"""autocov.device_ms (ms): device ms a pass of the split-chain moments and
the autocovariance kernels (``ops/moments.py``, ``ops/autocov.py``): K1, and
K5, the direct autocovariance, where a call takes that route. By kernel
name.

Not counted: Geyer's reduction (``ops/geyer.py``), the split's ``cat``
copies and the moments' preparation, which run PyTorch's generic kernels
whose names other layers share (~7.4 ms of a ~99 ms pass of
``batched_c4.fast``). So this metric cannot judge a change to those (the
fast call's glue, a fused Geyer walk): read those by ``diag_rate`` and the
breakdown."""

from portbench.readers import device_ms_per_pass

KERNELS = ("moments_autocov_kernel", "direct_autocov_kernel")


def read(ctx):
    return device_ms_per_pass(ctx, KERNELS)
