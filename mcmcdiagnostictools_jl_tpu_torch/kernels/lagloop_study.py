"""Kernel K6: two formulations of the lag loop, side by side.

Replaces the Pallas kernels ``_kernel_a`` / ``_kernel_b`` of
``benchmarks/micro_lagloop.py`` (``_run``). Both variants compute the raw
biased lag products of series that are NOT centered,

    c_k = sum_{t < niter - k} x_t x_{t+k} / niter,   k = 0..maxlag,

0 for lags at or beyond ``niter``. The CUDA source is
``csrc/lagloop_study.cu``: variant ``"a"`` is the first form of the port's
lag loop (one shared-memory load per FMA; nothing else launches it), variant
``"b"`` the loop K1 and K5 run (a warp owns consecutive lags and keeps the
sliding window of the shifted factor in registers; every draw is staged once,
ahead of use); the source says what bounds each on an H100.

``lag_products`` launches the chosen variant for a CUDA float32 tensor and
runs ``lag_products_plain`` for a CPU tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build

VARIANTS = ("a", "b")


def lag_products_plain(x: torch.Tensor, maxlag: int):
    """Plain PyTorch version of K6 on ``(niter, S)`` series: ``(maxlag + 1,
    S)`` with ``c_k = sum_{t < niter-k} x_t x_{t+k} / niter``, 0 for lags at
    or beyond ``niter``."""
    niter = x.shape[0]
    out = x.new_zeros((maxlag + 1, x.shape[1]))
    for k in range(min(maxlag + 1, niter)):
        out[k] = (x[: niter - k] * x[k:]).sum(0) / niter
    return out


def lag_products(x: torch.Tensor, maxlag: int, variant: str = "b"):
    """K6 on ``(niter, S)`` series with the lag loop ``variant`` (``"a"`` or
    ``"b"``); same output as ``lag_products_plain`` whichever is chosen. A
    CUDA tensor must be float32 and contiguous, with ``niter >= 1``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if x.ndim != 2:
        raise ValueError("lag_products needs a (niter, series) tensor")
    niter, nseries = x.shape
    if niter < 1 or maxlag < 0:
        raise ValueError(f"need niter >= 1 and maxlag >= 0, got {niter}, {maxlag}")
    if not backend.use_kernels(x):
        return lag_products_plain(x, maxlag)
    if not x.is_contiguous():
        raise ValueError("lag_products needs a contiguous tensor")
    if niter >= 2**31 or nseries >= 2**31:
        raise ValueError("lag_products: niter and series must fit in int32")
    lib = _build.library()
    name = f"mdt_lagloop_{variant}"
    with torch.cuda.device(x.device):
        out = torch.empty((maxlag + 1, nseries), dtype=torch.float32,
                          device=x.device)
        code = getattr(lib, name)(
            x.data_ptr(), niter, nseries, maxlag, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, name)
    setattr(lag_products, f"{variant}_launches",
            getattr(lag_products, f"{variant}_launches") + 1)
    return out


lag_products.a_launches = 0
lag_products.b_launches = 0
