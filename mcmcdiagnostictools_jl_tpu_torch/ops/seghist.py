"""Per-split-chain moments straight from a sorted sample (counterpart of the
JAX package's ``ops/seghist.py``).

The tail R-hat needs only the per-split-chain means and variances of the
rank-normal folded sample (reference ``_rhat(Val(:tail), x)``,
src/ess_rhat.jl:413-415): sums that do not depend on order. The fold sort
already carries each value's original flat position ``n = draw * nchains +
chain``, from which its split chain is a formula, so the values are never
routed back to (draw, chain) order.

Layout contract (``utils/split.py``): flat position ``draw * nchains +
chain``; the remainder-discard rule of the split; split-chain id ``chain *
split + k`` (chain-major, as ``split_chains_reshape`` lays them out);
values and positions ``(P, N)``, one row a parameter.

``split_chain_stats_from_sorted`` and ``nested_rhat_from_sorted`` (each over
a chain group, ``ops.moments``) run kernel K11 (``kernels/seghist.py``) on a
CUDA float32 tensor and its plain version (``split_chain_ids_from_flat`` and
``weighted_segment_moments``) on any other.
"""

from __future__ import annotations

from ..kernels.seghist import (
    segment_moments,
    split_chain_ids_from_flat,
    weighted_segment_moments,
)
from .moments import (
    ONE_CARD,
    ChainGroup,
    ChainStats,
    nested_rhat,
    stats_from_chain_moments,
)

__all__ = ["split_chain_ids_from_flat", "weighted_segment_moments",
           "split_chain_moments", "split_chain_stats_from_sorted",
           "nested_rhat_from_sorted"]


def split_chain_moments(values_sorted, order_sorted, ndraws: int,
                        nchains: int, split: int):
    """``(chain_mean, chain_var, vmin, vmax)``: the split chains' means and
    unbiased variances ``(nchains * split, P)`` of ``values_sorted`` ``(P,
    N)`` in any order along each row (the ring route passes its ``(N, P)``
    blocks transposed), ``order_sorted`` the flat original position of each,
    and each parameter's min and max over the draws the split keeps."""
    niter = ndraws // split
    sums, sumsq, vmin, vmax = segment_moments(values_sorted, order_sorted,
                                              ndraws, nchains, split)
    chain_mean = sums / niter
    chain_var = (sumsq - niter * chain_mean * chain_mean) / (niter - 1)
    return chain_mean, chain_var, vmin, vmax


def split_chain_stats_from_sorted(values_sorted, order_sorted, ndraws: int,
                                  nchains: int, split: int,
                                  group: ChainGroup = ONE_CARD) -> ChainStats:
    """``ChainStats`` of ``values`` as if routed back to ``(draws, chains)``
    and split, without routing them (arguments as
    :func:`split_chain_moments`). The same as
    ``chain_stats(split_chains_reshape(values_in_original_order, split))`` up
    to the summation order (sums of squares in place of two passes); a slice
    is degenerate where the min of its kept values equals their max."""
    chain_mean, chain_var, vmin, vmax = split_chain_moments(
        values_sorted, order_sorted, ndraws, nchains, split)
    return stats_from_chain_moments(chain_mean, chain_var, ndraws // split,
                                    group.same(vmin, vmax), group)


def nested_rhat_from_sorted(values_sorted, order_sorted, ndraws: int,
                            nchains: int, split: int, nsuper: int,
                            group: ChainGroup = ONE_CARD, rows=None):
    """``ops.moments.nested_rhat`` of ``values`` as if routed back to
    ``(draws, chains)`` and split, without routing them (arguments as
    :func:`split_chain_moments` and ``nested_rhat``)."""
    chain_mean, chain_var, vmin, vmax = split_chain_moments(
        values_sorted, order_sorted, ndraws, nchains, split)
    return nested_rhat(chain_mean, chain_var, nsuper, group.same(vmin, vmax),
                       group, rows)
