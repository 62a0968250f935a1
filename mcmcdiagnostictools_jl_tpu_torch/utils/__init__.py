from .layout import (
    canonicalize,
    param_shape,
    restore_param_shape,
    maybe_scalar,
    sample_dims,
)
from .split import split_chains_reshape, split_draw_indices
from .indices import (
    unique_indices,
    split_chain_indices,
    shuffle_split_stratified,
)
from .profiling import (
    annotate,
    comm_counts,
    host_sync,
    reset_comm_counts,
    reset_sync_counts,
    sync_counts,
    trace,
)

__all__ = [
    "canonicalize",
    "param_shape",
    "restore_param_shape",
    "maybe_scalar",
    "sample_dims",
    "split_chains_reshape",
    "split_draw_indices",
    "unique_indices",
    "split_chain_indices",
    "shuffle_split_stratified",
    "annotate",
    "comm_counts",
    "host_sync",
    "reset_comm_counts",
    "reset_sync_counts",
    "sync_counts",
    "trace",
]
