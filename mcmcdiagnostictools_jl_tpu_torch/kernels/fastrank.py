"""Kernels K2-K4 of the histogram/CDF fast rank mode.

- K2 ``column_minmax`` replaces ``pallas_column_minmax``,
- K3 ``hist_moments`` replaces ``pallas_hist_moments``,
- K4 ``rank_lookup`` replaces ``pallas_rank_lookup`` in both of its modes:
  mean-anchored ranks, and with ``blom_n`` the fused Blom + AS241 ``ppnd7``
  z values (the ``FUSE_BLOM_Z`` route of ``ops/fastrank.py``),

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

# AS241 PPND7 (Wichura 1988) rational coefficients, lowest order first: the
# JAX package's ``fastrank_kernel._PPND7_*``, and ``csrc/fastrank.cu``'s.
_PPND7_A = (3.3871327179e0, 5.0434271938e1, 1.5929113202e2, 5.9109374720e1)
_PPND7_B = (1.0, 1.7895169469e1, 7.8757757664e1, 6.7187563600e1)
_PPND7_C = (1.4234372777e0, 2.7568153900e0, 1.3067284816e0, 1.7023821103e-1)
_PPND7_D = (1.0, 7.3700164250e-1, 1.2021132975e-1)
_PPND7_E = (6.6579051150e0, 3.0812263860e0, 4.2868294337e-1, 1.7337203997e-2)
_PPND7_F = (1.0, 2.4197894225e-1, 1.2258202635e-2)


def _horner(r: torch.Tensor, coeffs) -> torch.Tensor:
    acc = torch.full_like(r, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * r + c
    return acc


def ppnd7(p: torch.Tensor) -> torch.Tensor:
    """Inverse standard normal CDF, AS241's single-precision branch (~1.5e-7
    relative), in ``p``'s dtype: the plain version of K4's z mode, operation
    for operation the JAX package's ``ppnd7``."""
    q = p - 0.5
    central = q.abs() <= 0.425
    r_c = 0.180625 - q * q
    x_c = q * _horner(r_c, _PPND7_A) / _horner(r_c, _PPND7_B)
    # tails: r = sqrt(-log(min(p, 1 - p)))
    pt = torch.where(central, 0.25, torch.minimum(p, 1.0 - p))
    r_t = torch.sqrt(-torch.log(pt.clamp(min=1e-38)))
    x_near = _horner(r_t - 1.6, _PPND7_C) / _horner(r_t - 1.6, _PPND7_D)
    x_far = _horner(r_t - 5.0, _PPND7_E) / _horner(r_t - 5.0, _PPND7_F)
    x_t = torch.sign(q) * torch.where(r_t <= 5.0, x_near, x_far)
    return torch.where(central, x_c, x_t)


def _blom_scale(blom_n: int | None) -> float:
    """``1 / (blom_n + 1/4)`` as a Python float (rounded to float32 where it
    meets float32 values), 0 for the rank mode."""
    if blom_n is None:
        return 0.0
    if blom_n < 1:
        raise ValueError(f"blom_n must be a positive element count, got {blom_n}")
    return 1.0 / (blom_n + 0.25)


def rank_lookup_plain(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                      tables: torch.Tensor, nbins: int,
                      blom_n: int | None = None):
    """Mean-anchored rank of every element, in original order:
    ``C[b] + clip(frac * cnt[b] + off[b], 0, cnt[b]) + 1/2`` from the
    ``(3, nbins, P)`` tables ``[C, cnt, off]``. With ``blom_n`` (the
    element count ``n``), the rank-normal value ``ppnd7((rank - 3/8) /
    (n + 1/4))`` instead."""
    blom_scale = _blom_scale(blom_n)
    b, frac = bins_from_scale(xf, lo, scale, nbins)
    tables = tables.to(torch.float32)
    c_lo, cnt_b, off_b = (tables[w].gather(0, b) for w in range(3))
    g = torch.minimum((frac * cnt_b + off_b).clamp(min=0.0), cnt_b)
    rank = c_lo + g + 0.5
    return rank if blom_n is None else ppnd7((rank - 0.375) * blom_scale)


def rank_lookup(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                tables: torch.Tensor, nbins: int, blom_n: int | None = None):
    """K4; same output as ``rank_lookup_plain`` (float32 on the card).
    ``launches`` counts every launch, ``z_launches`` those in the z mode."""
    if not backend.use_kernels(xf):
        return rank_lookup_plain(xf, lo, scale, tables, nbins, blom_n)
    n, p = _check_flat(xf, "rank_lookup")
    _check_vec(lo, p, xf, "lo")
    _check_vec(scale, p, xf, "scale")
    if tables.shape != (3, nbins, p) or tables.device != xf.device:
        raise ValueError(f"tables must be (3, {nbins}, {p}) on {xf.device}")
    blom_scale = _blom_scale(blom_n)
    lib = _build.library()
    dev = xf.device
    with torch.cuda.device(dev):
        # per column, the three tables side by side: one 16-byte gather
        tab = torch.zeros((p, nbins, 4), dtype=torch.float32, device=dev)
        tab[..., :3] = tables.permute(2, 1, 0)
        out = torch.empty((n, p), dtype=torch.float32, device=dev)
        code = lib.mdt_rank_lookup(
            xf.data_ptr(), n, p, lo.data_ptr(), scale.data_ptr(),
            tab.data_ptr(), nbins, blom_scale, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mdt_rank_lookup")
    rank_lookup.launches += 1
    if blom_n is not None:
        rank_lookup.z_launches += 1
    return out


rank_lookup.launches = 0
rank_lookup.z_launches = 0
