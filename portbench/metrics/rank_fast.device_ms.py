"""rank_fast.device_ms (ms): device ms a pass of the fast rank transforms'
own kernels (``ops/fastrank.py``): K2's column range, K3's histogram and CDF
tables, K4's rank lookup (both routes) and the inverse normal CDF
(``ndtri``). By kernel name.

Not counted: the Blom passes and the fold around the median, which run
PyTorch's generic elementwise kernels whose names other layers share (~21 ms
of a ~99 ms pass of ``batched_c4.fast``). So this metric cannot judge a
change to that glue (the fast call's glue; the ``FUSE_BLOM_Z`` default,
which moves the Blom pass into K4 and so raises this number while the layer
gets faster): read those by ``diag_rate`` and the breakdown."""

from portbench.readers import device_ms_per_pass

KERNELS = (
    "minmax_partial_kernel", "minmax_final_kernel",   # K2
    "hist_partial_kernel", "hist_finish_kernel",      # K3
    "lookup_wide_kernel", "lookup_gather_kernel",     # K4
    "ndtri",
)


def read(ctx):
    return device_ms_per_pass(ctx, KERNELS)
