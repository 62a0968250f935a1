"""Per-chain moment statistics for R-hat / ESS (counterpart of the JAX
package's ``ops/moments.py``), and nested R-hat's two-level reduction.

Per parameter: chain means, unbiased within-chain variances, ``W`` (mean
within-chain variance) and the pooled variance estimator
``var_plus = (n-1)/n * W + var(chain_means)`` used by both R-hat and ESS
(reference src/ess_rhat.jl:391-406, 529-545).

The cross-chain algebra is written once, over a :class:`ChainGroup`: the
chains on one card (``ONE_CARD``, the default) or over the ranks of a mesh
(``parallel.comm.MeshChains``), where a sum over chains ends in a collective.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.moments_autocov import moments_autocov
from ..utils.split import split_chains_reshape


class ChainGroup:
    """The chains of a call on one card (``parallel.comm.MeshChains``
    spreads them over ``ranks`` ranks); each method reduces this rank's
    ``(C_local, P)`` tensors over every chain of the group."""

    ranks = 1

    def mean(self, *ts):
        """Each tensor's mean over the group's chains, in one collective."""
        return tuple(t.mean(0) for t in ts)

    def sum(self, t):
        return t.sum(0)

    def mean_of_means(self, t, n: int):
        """The group's mean of ``t``, a mean over this rank's ``n`` chains."""
        return t

    def all_same(self, samples):
        """``(P,)`` True where the ``(n, C_local, P)`` samples are one value."""
        nparams = samples.shape[-1]
        return (samples == samples[0, 0][None, None]).reshape(-1, nparams).all(0)

    def same(self, vmin, vmax):
        """``(P,)`` True where the least ``vmin`` is the greatest ``vmax``."""
        return vmin == vmax


ONE_CARD = ChainGroup()


class ChainStats(NamedTuple):
    chain_mean: torch.Tensor  # (C, P)
    chain_var: torch.Tensor  # (C, P), ddof=1
    w: torch.Tensor  # (P,) mean within-chain variance
    var_plus: torch.Tensor  # (P,) pooled variance estimator
    rhat: torch.Tensor  # (P,) sqrt(var_plus / W)
    degenerate: torch.Tensor  # (P,) bool: all samples in the slice identical


def stats_from_chain_moments(chain_mean, chain_var, niter: int, degenerate,
                             group: ChainGroup = ONE_CARD) -> ChainStats:
    """Assemble ``ChainStats`` from per-chain first/second moments, this
    rank's ``(C_local, P)`` of the group's chains.

    With a single (split) chain the between-chain term is dropped, matching
    the reference's ``corrected=(nchains > 1)`` guard (src/ess_rhat.jl:403).
    """
    nchains = chain_mean.shape[0] * group.ranks
    w, grand_mean = group.mean(chain_var, chain_mean)
    dm = chain_mean - grand_mean[None]
    between = (group.sum(dm * dm) / (nchains - 1) if nchains > 1
               else torch.zeros_like(grand_mean))
    var_plus = (niter - 1) / niter * w + between
    # The reference relies on exact 0/0 -> NaN when every sample in a slice
    # is identical (test/ess_rhat.jl:242-257); reassociated sums can leave a
    # tiny nonzero between-chain term, so the case is poisoned explicitly.
    var_plus = torch.where(degenerate, torch.nan, var_plus)
    rhat = torch.sqrt(var_plus / w)
    return ChainStats(chain_mean, chain_var, w, var_plus, rhat, degenerate)


def chain_moments(samples: torch.Tensor):
    """``(chain_mean, centered, chain_var)`` of ``(niter, C, P)``."""
    chain_mean = samples.mean(0)
    centered = samples - chain_mean[None]
    return chain_mean, centered, (centered * centered).sum(0) / (
        samples.shape[0] - 1)


def chain_stats(samples: torch.Tensor,
                group: ChainGroup = ONE_CARD) -> ChainStats:
    """Per-chain moments and basic split-R-hat from ``(niter, C, P)``."""
    chain_mean, _, chain_var = chain_moments(samples)
    return stats_from_chain_moments(chain_mean, chain_var, samples.shape[0],
                                    group.all_same(samples), group)


def fused_chain_stats_autocov(samples: torch.Tensor, maxlag: int):
    """``(ChainStats, mean-over-chains autocov curve (maxlag+1, P))`` in one
    read of the sample: kernel K1 on the card, its plain version on the CPU.

    The curve is the reference-default direct estimator
    (src/ess_rhat.jl:161-179). The all-identical flag comes from the
    per-series min/max: a slice is constant iff its global min equals its
    global max (NaN slices compare unequal and propagate NaN anyway).
    """
    niter = samples.shape[0]
    chain_mean, chain_var, smin, smax, acov = moments_autocov(
        samples.contiguous(), maxlag
    )
    degenerate = smin.amin(0) == smax.amax(0)
    stats = stats_from_chain_moments(chain_mean, chain_var, niter, degenerate)
    return stats, acov.mean(1)


def nested_rhat(chain_mean, chain_var, nsuper: int, degenerate,
                group: ChainGroup = ONE_CARD, rows=None):
    """Nested R-hat (src/rhat_nested.jl:127-188) from this rank's split-chain
    means and variances ``(C_local, P)``: ``nsuper`` whole superchains,
    contiguous or made so by ``rows``, reduced locally, then across the
    group; NaN where ``degenerate``."""
    if rows is not None:
        chain_mean, chain_var = chain_mean[rows], chain_var[rows]
    nchains, nparams = chain_mean.shape
    m = nchains // nsuper  # (split) chains per superchain
    cm = chain_mean.reshape(nsuper, m, nparams)
    wk = chain_var.reshape(nsuper, m, nparams).mean(1)  # (S, P)
    superchain_mean = cm.mean(1)
    dm = cm - superchain_mean[:, None]
    # corrected=(m > 1), src/rhat_nested.jl:175
    bk = (dm * dm).sum(1) / (m - 1) if m > 1 else torch.zeros_like(wk)
    var_within, grand = group.mean(wk + bk, superchain_mean)  # (P,)
    ds = superchain_mean - grand[None]
    var_between = group.sum(ds * ds) / (nsuper * group.ranks - 1)
    var_between = torch.where(degenerate, torch.nan, var_between)
    return torch.sqrt(1.0 + var_between / var_within)


def nested_rhat_split(x3, nsuper: int, split: int,
                      group: ChainGroup = ONE_CARD, rows=None):
    """Nested R-hat of this rank's ``(draws, C_local, P)``, each chain split
    in ``split`` (the other arguments as ``nested_rhat``'s)."""
    samples = split_chains_reshape(x3, split)
    chain_mean, _, chain_var = chain_moments(samples)
    return nested_rhat(chain_mean, chain_var, nsuper, group.all_same(samples),
                       group, rows)
