from .ranknorm import (
    batched_quantile,
    fold_around_median,
    rank_normalize,
    tiedrank,
)
from .autocov import mean_autocov_curve, next_fft_size
from .geyer import geyer_ess_from_rho
from .moments import chain_stats

__all__ = [
    "batched_quantile",
    "fold_around_median",
    "rank_normalize",
    "tiedrank",
    "mean_autocov_curve",
    "next_fft_size",
    "geyer_ess_from_rho",
    "chain_stats",
]
