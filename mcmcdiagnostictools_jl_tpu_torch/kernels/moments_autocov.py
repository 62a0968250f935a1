"""Kernel K1: fused per-series moments + direct autocovariance.

Replaces the Pallas kernel ``pallas_moments_autocov``
(``mcmcdiagnostictools_jl_tpu/ops/pallas/fused_basic_kernel.py``). The CUDA
source is ``csrc/moments_autocov.cu``; its header says what bounds the kernel
on an H100 (the lag FMAs' dispatch rate) and how the design tiles the draw
axis, since a 5000-draw block of series no longer fits on chip as it did in
the TPU's VMEM.

``moments_autocov`` launches the kernel for a CUDA float32 tensor and runs
``moments_autocov_plain`` for a CPU tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build
from .autocov import direct_autocov_plain


def moments_autocov_plain(samples: torch.Tensor, maxlag: int):
    """Plain PyTorch version of K1 on ``(niter, C, P)``.

    Returns ``(chain_mean, chain_var, smin, smax, acov)``: four ``(C, P)``
    tensors and the ``(maxlag + 1, C, P)`` biased direct autocovariance
    ``sum_i xc_i * xc_{i+k} / niter`` of the centered series (zero past the
    end, so every lag is full length).
    """
    niter = samples.shape[0]
    mean = samples.sum(0) / niter
    smin = samples.amin(0)
    smax = samples.amax(0)
    centered = samples - mean
    var = (centered * centered).sum(0) / (niter - 1)
    return mean, var, smin, smax, direct_autocov_plain(centered, maxlag)


def moments_autocov(samples: torch.Tensor, maxlag: int):
    """K1 on ``(niter, C, P)``; same outputs as ``moments_autocov_plain``.

    A CUDA tensor must be float32, contiguous, with ``niter >= 2``.
    """
    if not backend.use_kernels(samples):
        return moments_autocov_plain(samples, maxlag)
    if samples.ndim != 3 or not samples.is_contiguous():
        raise ValueError("moments_autocov needs a contiguous (niter, C, P) tensor")
    niter, nchains, nparams = samples.shape
    nseries = nchains * nparams
    if niter < 2 or maxlag < 0:
        raise ValueError(f"need niter >= 2 and maxlag >= 0, got {niter}, {maxlag}")
    if niter >= 2**31 or nseries >= 2**31:
        raise ValueError("moments_autocov: niter and C * P must fit in int32")
    lib = _build.library()
    with torch.cuda.device(samples.device):
        moments = torch.empty((4, nseries), dtype=torch.float32,
                              device=samples.device)
        acov = torch.empty((maxlag + 1, nseries), dtype=torch.float32,
                           device=samples.device)
        stream = torch.cuda.current_stream(samples.device).cuda_stream
        code = lib.mdt_moments_autocov(
            samples.data_ptr(), niter, nseries, maxlag,
            moments[0].data_ptr(), moments[1].data_ptr(),
            moments[2].data_ptr(), moments[3].data_ptr(), acov.data_ptr(),
            stream,
        )
    _build.check(code, "mdt_moments_autocov")
    moments_autocov.launches += 1
    mean, var, smin, smax = moments.reshape(4, nchains, nparams)
    return mean, var, smin, smax, acov.reshape(maxlag + 1, nchains, nparams)


moments_autocov.launches = 0
