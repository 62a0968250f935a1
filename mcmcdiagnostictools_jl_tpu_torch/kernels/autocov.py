"""Kernel K5: direct autocovariance of centered series.

Replaces the Pallas kernel ``pallas_autocov``
(``mcmcdiagnostictools_jl_tpu/ops/pallas/autocov_kernel.py``). The CUDA
source is ``csrc/autocov.cu``, K1's lag loop (``lag_products_ring`` in
``csrc/lagloop.cuh``) without K1's moment pass; the header of ``lagloop.cuh``
says what bounds it on an H100 and how it tiles the draw axis.

``direct_autocov`` launches the kernel for a CUDA float32 tensor and runs
``direct_autocov_plain`` for a CPU tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build


def direct_autocov_plain(centered: torch.Tensor, maxlag: int):
    """Plain PyTorch version of K5 on centered ``(niter, C, P)`` series:
    ``(maxlag + 1, C, P)`` with ``c_k = sum_{i < niter-k} x_i x_{i+k} /
    niter``, 0 for lags at or beyond ``niter``."""
    niter = centered.shape[0]
    acov = centered.new_zeros((maxlag + 1,) + tuple(centered.shape[1:]))
    for k in range(min(maxlag + 1, niter)):
        acov[k] = (centered[: niter - k] * centered[k:]).sum(0) / niter
    return acov


def direct_autocov(centered: torch.Tensor, maxlag: int):
    """K5 on centered ``(niter, C, P)`` series; same output as
    ``direct_autocov_plain``. A CUDA tensor must be float32 and contiguous,
    with ``niter >= 1``."""
    if not backend.use_kernels(centered):
        return direct_autocov_plain(centered, maxlag)
    if centered.ndim != 3 or not centered.is_contiguous():
        raise ValueError("direct_autocov needs a contiguous (niter, C, P) tensor")
    niter, nchains, nparams = centered.shape
    nseries = nchains * nparams
    if niter < 1 or maxlag < 0:
        raise ValueError(f"need niter >= 1 and maxlag >= 0, got {niter}, {maxlag}")
    if niter >= 2**31 or nseries >= 2**31:
        raise ValueError("direct_autocov: niter and C * P must fit in int32")
    lib = _build.library()
    with torch.cuda.device(centered.device):
        acov = torch.empty((maxlag + 1, nseries), dtype=torch.float32,
                           device=centered.device)
        code = lib.mdt_direct_autocov(
            centered.data_ptr(), niter, nseries, maxlag, acov.data_ptr(),
            torch.cuda.current_stream(centered.device).cuda_stream,
        )
    _build.check(code, "mdt_direct_autocov")
    direct_autocov.launches += 1
    return acov.reshape(maxlag + 1, nchains, nparams)


direct_autocov.launches = 0
