"""Kernels K2-K4 of the histogram/CDF fast rank mode.

- K2 ``column_minmax`` replaces ``pallas_column_minmax``,
- K3 ``hist_moments`` replaces ``pallas_hist_moments``,
- K4 ``rank_lookup`` replaces ``pallas_rank_lookup`` in both of its modes:
  mean-anchored ranks, and with ``blom_n`` the fused Blom + AS241 ``ppnd7``
  z values (the ``FUSE_BLOM_Z`` route of ``ops/fastrank.py``),

all in ``mcmcdiagnostictools_jl_tpu/ops/pallas/fastrank_kernel.py``. The
CUDA source is ``csrc/fastrank.cu``; its header says what bounds each kernel
on an H100 and what the design does about it.

K3 also has the entry point ``hist_cdf_tables``: its second pass emits the
finished CDF (prefix counts, within-bin means) and K4's table, which K4 reads
from shared memory. K3 and K4 take a ``shift`` (they then work on the fold
``|x - shift|``), K4 also per-column constants (``fill``, ``bad``), so the
callers pass over the sample only inside the kernels.

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

# rows a slab block takes at a time (csrc/fastrank.cu: kTileRows), and the
# most a block may take in all: K3 packs a bin's count into 20 bits
_TILE_ROWS = 2048
_MAX_CHUNK_ROWS = 2**20 - 1
# slab blocks a multiprocessor, over the whole launch: K3 writes 128 KB of
# partial histograms a block; K4's wide kernel holds one block a
# multiprocessor and evens out with more, shorter ones
_BLOCKS_PER_SM = 4
_WIDE_BLOCKS_PER_SM = 8


def _apply_shift(xf: torch.Tensor, shift: torch.Tensor | None):
    """``|x - shift|`` per column, or ``xf`` itself without a shift."""
    return xf if shift is None else torch.abs(xf - shift[None, :])


def hist_moments_plain(xf: torch.Tensor, lo: torch.Tensor,
                       scale: torch.Tensor, nbins: int,
                       shift: torch.Tensor | None = None):
    """Per-column bin counts and within-bin frac sums, ``(nbins, P)``
    float32 each (counts are whole numbers, exact below 2^24), of ``xf`` or,
    with the ``(P,)`` vector ``shift``, of the fold ``|xf - shift|``."""
    b, frac = bins_from_scale(_apply_shift(xf, shift), lo, scale, nbins)
    shape = (nbins, xf.shape[1])
    cnt = torch.zeros(shape, dtype=torch.float32, device=xf.device)
    cnt.scatter_add_(0, b, torch.ones(b.shape, dtype=torch.float32,
                                      device=xf.device))
    s1 = torch.zeros(shape, dtype=torch.float32, device=xf.device)
    s1.scatter_add_(0, b, frac.to(torch.float32))
    return cnt, s1


def pack_tables(cum: torch.Tensor, fm: torch.Tensor) -> torch.Tensor:
    """K4's table from a CDF: ``(P, nbins + 1, 2)`` float32, ``[c, b] =
    (cum[b, c], fm[b, c])`` and ``(cum[nbins, c], 0)`` at the end, each
    column's bins contiguous (a block copies its columns' tables whole)."""
    tab = torch.zeros((cum.shape[1], cum.shape[0], 2), dtype=torch.float32,
                      device=cum.device)
    tab[:, :, 0] = cum.t()
    tab[:, :-1, 1] = fm.t()
    return tab


def hist_cdf_tables_plain(xf: torch.Tensor, lo: torch.Tensor,
                          scale: torch.Tensor, nbins: int,
                          shift: torch.Tensor | None = None):
    """The finished histogram CDF, ``(cum, fm, tab)``: the exclusive prefix
    counts ``(nbins + 1, P)``, the mean within-bin position ``(nbins, P)``
    (1/2 for an empty bin) and K4's table of the two (``pack_tables``)."""
    cnt, s1 = hist_moments_plain(xf, lo, scale, nbins, shift)
    fm = torch.where(cnt > 0, s1 / cnt.clamp(min=1.0), 0.5)
    cum = torch.cat([cnt.new_zeros((1, cnt.shape[1])), cnt.cumsum(0)], dim=0)
    return cum, fm, pack_tables(cum, fm)


def _row_chunks(n: int, groups: int, sms: int,
                blocks_per_sm: int = _BLOCKS_PER_SM) -> int:
    """Row chunks of a slab launch: about ``blocks_per_sm`` blocks a
    multiprocessor, no chunk below one tile nor above ``_MAX_CHUNK_ROWS``."""
    nchunks = min(-(-blocks_per_sm * sms // groups), -(-n // _TILE_ROWS))
    return max(1, nchunks, -(-n // _MAX_CHUNK_ROWS))


def slab_plan(n: int, p: int, nbins: int, sms: int, aligned: bool):
    """How K3 cuts an ``(n, p)`` sample: ``(cb, vec, nchunks)``, or ``None``
    when not even one column's ``nbins`` 8-byte words fit a block's shared
    memory. ``cb``: columns a block (4, 2 or 1). ``vec``: a block reads its
    rows as vectors of ``cb`` floats (``p`` a multiple of ``cb``, the
    sample's address of 16 bytes: ``aligned``), else float by float.
    ``nchunks``: ``_row_chunks``."""
    cb = next((c for c in (4, 2, 1) if nbins * c * 8 <= _SMEM_LIMIT), 0)
    if nbins < 1 or cb == 0:
        return None
    vec = cb == 1 or (aligned and p % cb == 0)
    return cb, int(vec), _row_chunks(n, -(-p // cb), sms)


def wide_plan(n: int, p: int, nbins: int, sms: int, aligned: bool):
    """K4's wide kernel on an ``(n, p)`` sample: ``(cb, nchunks)`` with
    ``cb`` = 32, 16 or 8 columns a block, the most whose tables (7 bytes a
    bin) fit a block's shared memory and that divide ``p``; ``None`` where
    none does, the tensors are not ``aligned`` to 16 bytes, or ``n`` is past
    the 24 bits a table entry keeps of a prefix count."""
    # csrc/fastrank.cu: wide_column_bytes
    column_bytes = 4 * nbins + (3 * (nbins + 1) + 15) // 8 * 8
    cb = next((c for c in (32, 16, 8)
               if p % c == 0 and c * column_bytes <= _SMEM_LIMIT), 0)
    if nbins < 1 or cb == 0 or not aligned or n >= 2**24:
        return None
    return cb, _row_chunks(n, p // cb, sms, _WIDE_BLOCKS_PER_SM)


def _aligned(nbytes: int, *tensors) -> bool:
    return all(t.data_ptr() % nbytes == 0 for t in tensors)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _hist_launch(xf, lo, scale, nbins, shift, want: str):
    """Both passes of K3; ``want``: ``"moments"`` (cnt, s1) or ``"cdf"``
    (cum, fm, tab)."""
    n, p = _check_flat(xf, "hist_moments")
    _check_vec(lo, p, xf, "lo")
    _check_vec(scale, p, xf, "scale")
    if shift is not None:
        _check_vec(shift, p, xf, "shift")
    dev = xf.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = slab_plan(n, p, nbins, sms, _aligned(16, xf))
    if plan is None:
        raise ValueError(f"hist_moments: nbins={nbins} does not fit a block's "
                         "shared memory")
    cb, vec, nchunks = plan
    lib = _build.library()
    with torch.cuda.device(dev):
        def new(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        partial = torch.empty((nchunks, -(-p // cb), cb, nbins),
                              dtype=torch.int64, device=dev)
        if want == "moments":
            out = {"cnt": new(nbins, p), "s1": new(nbins, p)}
        else:
            out = {"cum": new(nbins + 1, p), "fm": new(nbins, p),
                   "tab": new(p, nbins + 1, 2)}
        code = lib.mdt_hist_tables(
            xf.data_ptr(), n, p, lo.data_ptr(), scale.data_ptr(), _ptr(shift),
            nbins, cb, vec, nchunks, partial.data_ptr(),
            *(_ptr(out.get(k)) for k in ("cnt", "s1", "fm", "cum", "tab")),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mdt_hist_tables")
    hist_moments.launches += 1
    return tuple(out.values())


def hist_moments(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                 nbins: int, shift: torch.Tensor | None = None):
    """K3; same outputs as ``hist_moments_plain``. The kernel adds whole
    numbers (counts, and frac sums in fixed point with 24 fractional bits),
    so its output does not vary from run to run."""
    if not backend.use_kernels(xf):
        return hist_moments_plain(xf, lo, scale, nbins, shift)
    return _hist_launch(xf, lo, scale, nbins, shift, "moments")


hist_moments.launches = 0


def hist_cdf_tables(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                    nbins: int, shift: torch.Tensor | None = None):
    """K3 with its second pass emitting the finished CDF; same outputs as
    ``hist_cdf_tables_plain``. Counted in ``hist_moments.launches``."""
    if not backend.use_kernels(xf):
        return hist_cdf_tables_plain(xf, lo, scale, nbins, shift)
    return _hist_launch(xf, lo, scale, nbins, shift, "cdf")


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


def _is_packed(tables: torch.Tensor, nbins: int, p: int) -> bool:
    """Whether ``tables`` is the ``(P, nbins + 1, 2)`` table of
    ``pack_tables`` (else it must be the ``(3, nbins, P)`` stack)."""
    if tables.shape == (p, nbins + 1, 2):
        return True
    if tables.shape == (3, nbins, p):
        return False
    raise ValueError(f"tables must be ({p}, {nbins + 1}, 2) (cum, fm) or "
                     f"(3, {nbins}, {p}) [C, cnt, off], got "
                     f"{tuple(tables.shape)}")


def _unpack_tables(tables: torch.Tensor, nbins: int, p: int):
    """``(C, cnt, off)``, each ``(nbins, P)`` float32, from either form of
    K4's tables; from ``(cum, fm)``: ``cnt = cum[b+1] - cum[b]``, ``off =
    cnt (1/2 - fm)``."""
    tables = tables.to(torch.float32)
    if not _is_packed(tables, nbins, p):
        return tables[0], tables[1], tables[2]
    cum, fm = tables[:, :, 0].t(), tables[:, :-1, 1].t()
    cnt = cum[1:] - cum[:-1]
    return cum[:-1], cnt, cnt * (0.5 - fm)


def rank_lookup_plain(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                      tables: torch.Tensor, nbins: int,
                      blom_n: int | None = None, *,
                      shift: torch.Tensor | None = None,
                      fill: torch.Tensor | None = None,
                      bad: torch.Tensor | None = None):
    """Mean-anchored rank of every element, in original order:
    ``C[b] + clip(frac * cnt[b] + off[b], 0, cnt[b]) + 1/2``. ``tables``:
    the ``(P, nbins + 1, 2)`` table ``(cum, fm)`` of ``pack_tables``, or the
    ``(3, nbins, P)`` stack ``[C, cnt, off]``. With ``blom_n`` (the element
    count ``n``), the rank-normal value ``ppnd7((rank - 3/8) / (n + 1/4))``
    instead.

    ``shift`` (``(P,)``): the elements looked up are ``|xf - shift|``.
    ``fill`` (``(P,)``): a column whose entry is not NaN gets that constant
    instead of its lookup (NaN: look up). ``bad`` (``(P,)`` bool): these
    columns get NaN, whatever ``fill`` says."""
    blom_scale = _blom_scale(blom_n)
    b, frac = bins_from_scale(_apply_shift(xf, shift), lo, scale, nbins)
    c_lo, cnt_b, off_b = (w.gather(0, b)
                          for w in _unpack_tables(tables, nbins, xf.shape[1]))
    g = torch.minimum((frac * cnt_b + off_b).clamp(min=0.0), cnt_b)
    out = c_lo + g + 0.5
    if blom_n is not None:
        out = ppnd7((out - 0.375) * blom_scale)
    if fill is not None:
        out = torch.where(torch.isnan(fill)[None, :], out,
                          fill.to(out.dtype)[None, :])
    if bad is not None:
        out = torch.where(bad[None, :], torch.nan, out)
    return out


def lookup_route(n: int, p: int, nbins: int, packed: bool, sms: int,
                 aligned: bool):
    """Which kernel K4 runs for this shape, by shape alone: ``("wide", cb,
    nchunks)`` (``wide_plan``: the columns' tables in shared memory, whole
    sectors of every row a block), or ``("gather",)`` for what that kernel
    does not take (``p`` no multiple of 8, more bins than fit its shared
    memory, the ``[C, cnt, off]`` stack): the tables packed as float4 and
    gathered through the L2."""
    plan = wide_plan(n, p, nbins, sms, aligned) if packed else None
    return ("gather",) if plan is None else ("wide", *plan)


def rank_lookup(xf: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                tables: torch.Tensor, nbins: int, blom_n: int | None = None,
                *, shift: torch.Tensor | None = None,
                fill: torch.Tensor | None = None,
                bad: torch.Tensor | None = None):
    """K4; same output as ``rank_lookup_plain`` (float32 on the card).
    ``launches`` counts every launch, ``z_launches`` those in the z mode;
    ``route`` is the last launch's ``lookup_route``."""
    if not backend.use_kernels(xf):
        return rank_lookup_plain(xf, lo, scale, tables, nbins, blom_n,
                                 shift=shift, fill=fill, bad=bad)
    n, p = _check_flat(xf, "rank_lookup")
    _check_vec(lo, p, xf, "lo")
    _check_vec(scale, p, xf, "scale")
    for name, v in (("shift", shift), ("fill", fill)):
        if v is not None:
            _check_vec(v, p, xf, name)
    if bad is not None and (bad.shape != (p,) or bad.dtype != torch.bool
                            or bad.device != xf.device
                            or not bad.is_contiguous()):
        raise ValueError(f"bad must be a contiguous bool ({p},) tensor on "
                         f"{xf.device}")
    packed = _is_packed(tables, nbins, p)
    if (tables.device != xf.device or tables.dtype != torch.float32
            or not tables.is_contiguous()):
        raise ValueError(f"tables must be contiguous float32 on {xf.device}")
    blom_scale = _blom_scale(blom_n)
    lib = _build.library()
    dev = xf.device
    with torch.cuda.device(dev):
        out = torch.empty((n, p), dtype=torch.float32, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        route = lookup_route(n, p, nbins, packed, sms, _aligned(16, xf, out))
        common = (xf.data_ptr(), n, p, lo.data_ptr(), scale.data_ptr(),
                  _ptr(shift), _ptr(fill), _ptr(bad))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route[0] == "wide":
            _, cb, nchunks = route
            code = lib.mdt_rank_lookup_wide(
                *common, tables.data_ptr(), nbins, blom_scale, cb, nchunks,
                out.data_ptr(), stream)
        else:
            # per column, [C, cnt, off] side by side: one 16-byte gather
            tab = torch.zeros((p, nbins, 4), dtype=torch.float32, device=dev)
            tab[..., :3] = torch.stack(
                _unpack_tables(tables, nbins, p)).permute(2, 1, 0)
            code = lib.mdt_rank_lookup_gather(
                *common, tab.data_ptr(), nbins, blom_scale, out.data_ptr(),
                stream)
    _build.check(code, "mdt_rank_lookup (" + route[0] + ")")
    rank_lookup.launches += 1
    rank_lookup.route = route
    if blom_n is not None:
        rank_lookup.z_launches += 1
    return out


rank_lookup.launches = 0
rank_lookup.z_launches = 0
rank_lookup.route = None
