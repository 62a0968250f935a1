"""Per-chain moment statistics for R-hat / ESS (counterpart of the JAX
package's ``ops/moments.py``).

Per parameter: chain means, unbiased within-chain variances, ``W`` (mean
within-chain variance) and the pooled variance estimator
``var_plus = (n-1)/n * W + var(chain_means)`` used by both R-hat and ESS
(reference src/ess_rhat.jl:391-406, 529-545).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.moments_autocov import moments_autocov


class ChainStats(NamedTuple):
    chain_mean: torch.Tensor  # (C, P)
    chain_var: torch.Tensor  # (C, P), ddof=1
    w: torch.Tensor  # (P,) mean within-chain variance
    var_plus: torch.Tensor  # (P,) pooled variance estimator
    rhat: torch.Tensor  # (P,) sqrt(var_plus / W)
    degenerate: torch.Tensor  # (P,) bool: all samples in the slice identical


def stats_from_chain_moments(chain_mean, chain_var, niter: int,
                             degenerate) -> ChainStats:
    """Assemble ``ChainStats`` from per-chain first/second moments.

    With a single (split) chain the between-chain term is dropped, matching
    the reference's ``corrected=(nchains > 1)`` guard (src/ess_rhat.jl:403).
    """
    nchains = chain_mean.shape[0]
    w = chain_var.mean(0)
    grand_mean = chain_mean.mean(0)
    dm = chain_mean - grand_mean[None]
    if nchains > 1:
        between = (dm * dm).sum(0) / (nchains - 1)
    else:
        between = torch.zeros_like(grand_mean)
    var_plus = (niter - 1) / niter * w + between
    # The reference relies on exact 0/0 -> NaN when every sample in a slice
    # is identical (test/ess_rhat.jl:242-257); reassociated sums can leave a
    # tiny nonzero between-chain term, so the case is poisoned explicitly.
    var_plus = torch.where(degenerate, torch.nan, var_plus)
    rhat = torch.sqrt(var_plus / w)
    return ChainStats(chain_mean, chain_var, w, var_plus, rhat, degenerate)


def chain_stats(samples: torch.Tensor) -> ChainStats:
    """Per-chain moments and basic split-R-hat from ``(niter, C, P)``."""
    niter, _, nparams = samples.shape
    chain_mean = samples.mean(0)
    centered = samples - chain_mean[None]
    chain_var = (centered * centered).sum(0) / (niter - 1)
    degenerate = (samples == samples[0, 0][None, None]).reshape(-1, nparams).all(0)
    return stats_from_chain_moments(chain_mean, chain_var, niter, degenerate)


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
