"""Nested R-hat for many short chains (Margossian et al. 2024; counterpart
of the JAX package's ``diagnostics/rhat_nested.py``, reference
rhat_nested.jl).

Chains are grouped into superchains (all chains of a superchain share an
initialization). Per parameter and superchain, ``Wk`` (mean within-chain
variance) and ``Bk`` (between-chain variance) combine as
``rhat = sqrt(1 + var(superchain means) / mean(Wk + Bk))``
(src/rhat_nested.jl:127-188). The chains are permuted so that superchains
are contiguous, and both levels of the reduction are axis reductions
(``ops.moments.nested_rhat``, which the sharded route calls with the mesh's
chain group). The kinds reuse the exact rank transforms
(src/rhat_nested.jl:98-125).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.moments import nested_rhat_split
from ..ops.ranknorm import fold_around_median, rank_normalize
from ..utils.indices import unique_indices
from ..utils.layout import maybe_scalar
from ..utils.profiling import annotate, host_sync
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
        perm, nsuper = validate_superchain_ids(superchain_ids, x3.shape[1])
        with host_sync("superchain_ids"):
            perm = torch.as_tensor(perm, device=x3.device)

        def nested(z):
            with annotate("mdt.nested"):
                return nested_rhat_split(z[:, perm, :], nsuper, split_chains)

        if kind == "basic":
            return maybe_scalar(nested(x3), pshape)
        return maybe_scalar(by_kind(kind, lambda: nested(_ranked(x3, False)),
                                    lambda: nested(_ranked(x3, True))),
                            pshape)


def by_kind(kind: str, bulk, tail):
    """The nested R-hat of ``kind`` from the calls that give its bulk and
    its tail R-hat: ``"bulk"``, ``"tail"``, or ``"rank"``, their max (the
    bulk computed first)."""
    if kind == "tail":
        return tail()
    r = bulk()
    return r if kind == "bulk" else torch.maximum(r, tail())


def _ranked(x3, fold: bool):
    """The exact rank-normal sample, of ``|x - median|`` with ``fold``."""
    with annotate("mdt.rank.exact"):
        return rank_normalize(fold_around_median(x3) if fold else x3)


def validate_superchain_ids(superchain_ids, nchains: int):
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
