"""Nested R-hat for many short chains (Margossian et al. 2024; counterpart
of the JAX package's ``diagnostics/rhat_nested.py``, reference
rhat_nested.jl).

Chains are grouped into superchains (all chains of a superchain share an
initialization). Per parameter and superchain, ``Wk`` (mean within-chain
variance) and ``Bk`` (between-chain variance) combine as
``rhat = sqrt(1 + var(superchain means) / mean(Wk + Bk))``
(src/rhat_nested.jl:127-188). The chains are permuted so that superchains
are contiguous, and both levels of the reduction are axis reductions. The
kinds reuse the exact rank transforms (src/rhat_nested.jl:98-125).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ranknorm import fold_around_median, rank_normalize
from ..utils.indices import unique_indices
from ..utils.layout import maybe_scalar
from ..utils.profiling import annotate, host_sync
from ..utils.split import split_chains_reshape
from .ess_rhat import _canonical_input

_KINDS = ("rank", "bulk", "tail", "basic")


def rhat_nested(samples, superchain_ids, *, kind: str = "rank",
                split_chains: int = 2, device=None):
    """Nested R-hat of ``samples`` shaped ``(draws, chains[, params...])``.

    ``superchain_ids``: one id per chain; every superchain must hold the
    same number of chains, and there must be at least 2 superchains
    (src/rhat_nested.jl:68-81). ``kind``: ``"rank"`` (default, the max of
    bulk and tail), ``"bulk"``, ``"tail"`` or ``"basic"``. Outputs and
    devices as in ``ess``.
    """
    if kind not in _KINDS:
        raise ValueError(
            f"the `kind` `{kind}` is not supported by `rhat_nested`")
    with annotate("mdt.rhat_nested"):
        x3, pshape = _canonical_input(samples, device, min_ndim=2)
        perm, nsuper = _validate_superchain_ids(superchain_ids, x3.shape[1])
        with host_sync("superchain_ids"):
            perm = torch.as_tensor(perm, device=x3.device)
        if kind == "rank":
            bulk = _rhat_nested_basic(_ranked(x3, False), perm, nsuper,
                                      split_chains)
            tail = _rhat_nested_basic(_ranked(x3, True), perm, nsuper,
                                      split_chains)
            return maybe_scalar(torch.maximum(bulk, tail), pshape)
        if kind != "basic":
            x3 = _ranked(x3, kind == "tail")
        return maybe_scalar(_rhat_nested_basic(x3, perm, nsuper, split_chains),
                            pshape)


def _ranked(x3, fold: bool):
    """The exact rank-normal sample, of ``|x - median|`` with ``fold``."""
    with annotate("mdt.rank.exact"):
        return rank_normalize(fold_around_median(x3) if fold else x3)


def _validate_superchain_ids(superchain_ids, nchains: int):
    """``(chain permutation that makes superchains contiguous, nsuper)``."""
    ids = np.asarray(superchain_ids)
    if ids.ndim != 1 or len(ids) != nchains:
        raise ValueError(f"`superchain_ids` has length {ids.size} but "
                         f"`samples` has {nchains} chains")
    _, groups = unique_indices(ids)
    nsuper = len(groups)
    if nsuper < 2:
        raise ValueError(f"at least 2 superchains are required, got {nsuper}")
    if len({len(g) for g in groups}) != 1:
        raise ValueError(
            "all superchains must contain the same number of chains")
    return np.concatenate(groups), nsuper


def _rhat_nested_basic(x3, perm, nsuper: int, split_chains: int):
    """Two-level within/between reduction (src/rhat_nested.jl:127-188),
    batched over parameters."""
    with annotate("mdt.nested"):
        samples = split_chains_reshape(x3[:, perm, :], split_chains)
        niter, _, nparams = samples.shape
        chain_mean = samples.mean(0)
        centered = samples - chain_mean[None]
        chain_var = (centered * centered).sum(0) / (niter - 1)
        # an all-identical slice is NaN whatever the rounding of the sums
        degenerate = (samples == samples[0, 0][None, None]).reshape(
            -1, nparams).all(0)
        return _nested_from_moments(chain_mean, chain_var, nsuper, degenerate)


def _nested_from_moments(chain_mean, chain_var, nsuper: int, degenerate):
    """Nested R-hat from split-chain means and variances ``(C, P)``,
    superchains contiguous (chain-major split chains), NaN where
    ``degenerate``."""
    nchains, nparams = chain_mean.shape
    m = nchains // nsuper  # (split) chains per superchain
    cm = chain_mean.reshape(nsuper, m, nparams)
    wk = chain_var.reshape(nsuper, m, nparams).mean(1)  # (S, P)
    superchain_mean = cm.mean(1)
    dm = cm - superchain_mean[:, None]
    # corrected=(m > 1), src/rhat_nested.jl:175
    bk = (dm * dm).sum(1) / (m - 1) if m > 1 else torch.zeros_like(wk)
    var_within = (wk + bk).mean(0)  # (P,)
    ds = superchain_mean - superchain_mean.mean(0)[None]
    var_between = (ds * ds).sum(0) / (nsuper - 1)
    var_between = torch.where(degenerate, torch.nan, var_between)
    return torch.sqrt(1.0 + var_between / var_within)
