"""Kernels K2-K4 of the histogram/CDF fast rank mode.

- K2 ``column_minmax`` replaces ``pallas_column_minmax``,
- K3 ``hist_moments`` replaces ``pallas_hist_moments``,
- K4 ``rank_lookup`` replaces ``pallas_rank_lookup`` (ranks only; its fused
  Blom/AS241 mode is off the main path and not ported),

all in ``mcmcdiagnostictools_jl_tpu/ops/pallas/fastrank_kernel.py``. The
CUDA source is ``csrc/fastrank.cu``; its header says what bounds each kernel
on an H100 and what the design does about it.

Each wrapper launches its kernel for a CUDA float32 tensor and runs the plain
PyTorch version beside it for a CPU tensor; it never falls back from one to
the other. The plain versions follow the JAX package's XLA path: a scatter
for the histogram, a gather for the lookup (the radix one-hot einsums stood
in for those on the TPU only).
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build

# shared memory a block may use on an H100 (bytes)
_SMEM_LIMIT = 232448


def bins_from_scale(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                    nbins: int):
    """Bin index (int64) and within-bin position of every element of a flat
    ``(N, P)`` sample: ``s = clip((x - lo) * scale, 0, nbins)``, bin
    ``clip(int(s), 0, nbins - 1)``, frac ``s - bin``.

    NaN elements map to 0 before binning (their columns are poisoned by the
    caller), and a NaN coordinate maps to 0, as in the kernels. The
    arithmetic runs in at least float32.
    """
    ct = torch.promote_types(xf.dtype, torch.float32)
    s = (torch.nan_to_num(xf.to(ct)) - lo.to(ct)[None]) * scale.to(ct)[None]
    s = torch.nan_to_num(s.clamp(0.0, float(nbins)), nan=0.0)
    b = s.to(torch.int64).clamp(0, nbins - 1)
    return b, s - b.to(ct)


def _check_flat(xf: torch.Tensor, name: str):
    if xf.ndim != 2 or not xf.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (N, P) tensor")
    n, p = xf.shape
    if p >= 2**31:
        raise ValueError(f"{name}: too many columns")
    return n, p


def _check_vec(v: torch.Tensor, p: int, ref: torch.Tensor, name: str):
    if (v.shape != (p,) or v.dtype != torch.float32 or v.device != ref.device
            or not v.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 ({p},) tensor "
                         f"on {ref.device}")


# ---- K2 --------------------------------------------------------------------


def column_minmax_plain(xf: torch.Tensor):
    """Per-column ``(lo, hi, bad)`` of ``(N, P)``: NaNs ignored for the
    range and flagged in ``bad``; a column whose lo or hi is not finite
    (all-NaN, empty, or holding an infinity) gets ``[0, 1]``."""
    nan = torch.isnan(xf)
    bad = nan.any(0)
    if xf.shape[0] == 0:
        lo = xf.new_zeros(xf.shape[1])
        return lo, lo + 1.0, bad
    lo = torch.where(nan, torch.inf, xf).amin(0)
    hi = torch.where(nan, -torch.inf, xf).amax(0)
    ok = torch.isfinite(lo) & torch.isfinite(hi)
    return torch.where(ok, lo, 0.0), torch.where(ok, hi, 1.0), bad


def column_minmax(xf: torch.Tensor):
    """K2; same outputs as ``column_minmax_plain``."""
    if not backend.use_kernels(xf):
        return column_minmax_plain(xf)
    n, p = _check_flat(xf, "column_minmax")
    nchunks = max(1, min(512, -(-n // 2048)))
    lib = _build.library()
    dev = xf.device
    with torch.cuda.device(dev):
        plo = torch.empty((nchunks, p), dtype=torch.float32, device=dev)
        phi = torch.empty((nchunks, p), dtype=torch.float32, device=dev)
        pbad = torch.empty((nchunks, p), dtype=torch.int32, device=dev)
        lo = torch.empty(p, dtype=torch.float32, device=dev)
        hi = torch.empty(p, dtype=torch.float32, device=dev)
        bad = torch.empty(p, dtype=torch.bool, device=dev)
        code = lib.mdt_column_minmax(
            xf.data_ptr(), n, p, nchunks, plo.data_ptr(), phi.data_ptr(),
            pbad.data_ptr(), lo.data_ptr(), hi.data_ptr(), bad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mdt_column_minmax")
    column_minmax.launches += 1
    return lo, hi, bad


column_minmax.launches = 0


# ---- K3 --------------------------------------------------------------------


def hist_moments_plain(xf: torch.Tensor, lo: torch.Tensor,
                       scale: torch.Tensor, nbins: int):
    """Per-column bin counts and within-bin frac sums, ``(nbins, P)``
    float32 each (counts are whole numbers, exact below 2^24)."""
    b, frac = bins_from_scale(xf, lo, scale, nbins)
    shape = (nbins, xf.shape[1])
    cnt = torch.zeros(shape, dtype=torch.float32, device=xf.device)
    cnt.scatter_add_(0, b, torch.ones(b.shape, dtype=torch.float32,
                                      device=xf.device))
    s1 = torch.zeros(shape, dtype=torch.float32, device=xf.device)
    s1.scatter_add_(0, b, frac.to(torch.float32))
    return cnt, s1


def hist_moments(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                 nbins: int):
    """K3; same outputs as ``hist_moments_plain``. The frac sums of the
    kernel are added with atomics, so their float32 rounding varies from
    run to run; counts are exact."""
    if not backend.use_kernels(xf):
        return hist_moments_plain(xf, lo, scale, nbins)
    n, p = _check_flat(xf, "hist_moments")
    _check_vec(lo, p, xf, "lo")
    _check_vec(scale, p, xf, "scale")
    cb = next((c for c in (4, 2, 1) if nbins * c * 8 <= _SMEM_LIMIT), 0)
    if nbins < 1 or cb == 0:
        raise ValueError(f"hist_moments: nbins={nbins} does not fit a block's "
                         "shared memory")
    # about four blocks per SM, at least 1024 rows each
    sms = torch.cuda.get_device_properties(xf.device).multi_processor_count
    nchunks = max(1, min(-(-4 * sms // -(-p // cb)), -(-n // 1024)))
    lib = _build.library()
    dev = xf.device
    with torch.cuda.device(dev):
        cnt = torch.zeros((nbins, p), dtype=torch.float32, device=dev)
        s1 = torch.zeros((nbins, p), dtype=torch.float32, device=dev)
        code = lib.mdt_hist_moments(
            xf.data_ptr(), n, p, lo.data_ptr(), scale.data_ptr(), nbins, cb,
            nchunks, cnt.data_ptr(), s1.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mdt_hist_moments")
    hist_moments.launches += 1
    return cnt, s1


hist_moments.launches = 0


# ---- K4 --------------------------------------------------------------------


def rank_lookup_plain(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                      tables: torch.Tensor, nbins: int):
    """Mean-anchored rank of every element, in original order:
    ``C[b] + clip(frac * cnt[b] + off[b], 0, cnt[b]) + 1/2`` from the
    ``(3, nbins, P)`` tables ``[C, cnt, off]``."""
    b, frac = bins_from_scale(xf, lo, scale, nbins)
    tables = tables.to(torch.float32)
    c_lo, cnt_b, off_b = (tables[w].gather(0, b) for w in range(3))
    g = torch.minimum((frac * cnt_b + off_b).clamp(min=0.0), cnt_b)
    return c_lo + g + 0.5


def rank_lookup(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                tables: torch.Tensor, nbins: int):
    """K4; same output as ``rank_lookup_plain`` (float32 on the card)."""
    if not backend.use_kernels(xf):
        return rank_lookup_plain(xf, lo, scale, tables, nbins)
    n, p = _check_flat(xf, "rank_lookup")
    _check_vec(lo, p, xf, "lo")
    _check_vec(scale, p, xf, "scale")
    if tables.shape != (3, nbins, p) or tables.device != xf.device:
        raise ValueError(f"tables must be (3, {nbins}, {p}) on {xf.device}")
    lib = _build.library()
    dev = xf.device
    with torch.cuda.device(dev):
        # per column, the three tables side by side: one 16-byte gather
        tab = torch.zeros((p, nbins, 4), dtype=torch.float32, device=dev)
        tab[..., :3] = tables.permute(2, 1, 0)
        out = torch.empty((n, p), dtype=torch.float32, device=dev)
        code = lib.mdt_rank_lookup(
            xf.data_ptr(), n, p, lo.data_ptr(), scale.data_ptr(),
            tab.data_ptr(), nbins, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mdt_rank_lookup")
    rank_lookup.launches += 1
    return out


rank_lookup.launches = 0
