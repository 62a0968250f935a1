"""Kernel K12: the exact rank mode's tied ranks and Blom normal scores, in
one pass over each sorted row.

Stands for three XLA pieces of the JAX package's exact rank mode
(``mcmcdiagnostictools_jl_tpu/ops/ranknorm.py``), none of them a Pallas
kernel: ``_avg_ranks_sorted``, ``ndtri((r - 0.375) / (n + 0.25))`` and the
inverse permutation back to the original order. The CUDA source is
``csrc/tied_ranks.cu``; its header says what bounds it on an H100, how a
block finds the runs that cross its edges, how the Blom scores come from a
table made at each call, and how the scatter back goes in two passes that
write whole sectors.

``tied_blom`` launches the kernels for a CUDA float32 tensor and runs
``tied_blom_plain`` for any other, never falling back from one to the other.
The plain version is the exact mode's code as it was before the kernel:
``_run_sums`` (a cummax and a reverse cummin over the run boundaries), the
ranks or their Blom scores (``blom_scores``, the arithmetic K12 follows),
the ``bad`` mask and ``_scatter_rows``; ``ops/ranknorm.py`` exports those
names.

Kernel K15 (``blom_from_counts``, in the same source) forms the same Blom
scores from the ring route's integer counts in one pass over them, written
over the counts' own storage; its plain version is ``blom_scores`` itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from . import _build

_TILE = 4096  # entries of one row a block of the kernel (csrc: kTile)
_BUCKET = 32768  # columns of one bucket of the scatter (csrc: kBucket)
_TABLE_MAX_N = 2**22  # longest row whose scores come from a table (kTableMaxN)
# what the kernel writes (csrc: Mode): ranks, or Blom scores from the
# call's table, or computed an entry
_RANKS, _BLOM_TABLE, _BLOM_NDTRI = 0, 1, 2


def _run_sums(xs: torch.Tensor) -> torch.Tensor:
    """``(P, N)`` int32: for each entry of the presorted rows ``xs`` ``(P,
    N)``, in sorted order, the sum ``k`` of the 1-based first and last
    positions of its run of equal values (its tied rank is ``k / 2``): the
    first by a cummax and the last by a reverse cummin over the run
    boundaries, along the contiguous axis. Entry ``j`` starts a run where
    it differs from entry ``j - 1`` (``first``), and ends one where entry
    ``j + 1`` starts one, so the reverse scan reads ``first`` flipped as
    bytes (reversed position ``r`` is entry ``n - 1 - r``) and one int32
    result is flipped back."""
    p, n = xs.shape
    pos = torch.arange(1, n + 1, dtype=torch.int32, device=xs.device)
    first = torch.empty((p, n), dtype=torch.bool, device=xs.device)
    first[:, 0] = True
    torch.ne(xs[:, 1:], xs[:, :-1], out=first[:, 1:])
    start = torch.cummax(torch.where(first, pos, 1), dim=1).values
    # reversed position r >= 1 (entry n - 1 - r) ends a run where entry
    # n - r starts one; r = 0, the last entry, always does: the fill's n
    first_rev = first.flip(1)
    end = torch.full((p, n), n, dtype=torch.int32, device=xs.device)
    torch.where(first_rev[:, :-1], pos.flip(0)[1:], pos[-1], out=end[:, 1:])
    end = torch.cummin(end, dim=1).values.flip(1)
    return start.add_(end)


def _avg_ranks_sorted(xs: torch.Tensor) -> torch.Tensor:
    """Tied ("average") 1-based ranks of the presorted rows ``xs`` ``(P,
    N)``, in sorted order: each run of equal values gets the mean of its
    1-based positions, (first + last) / 2, rounded once to ``xs``'s
    dtype."""
    return _run_sums(xs).to(xs.dtype) * 0.5


def blom_scores(k: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Blom normal scores ``ndtri((r - 3/8) / (n + 1/4))``, in ``dtype``, of
    the tied ranks ``r = k / 2`` in a row of ``n`` entries, ``k`` an integer
    tensor (each run's 1-based first plus last position; the ring route's
    ``2 cl + ce + 1``).

    Formed as K12 forms them (``csrc/tied_ranks.cu``, ``blom_score``): the
    numerator exactly in integers, eight times over, and on the upper half
    (``k > n``) from the far end, ``n - r + 5/8``, with the sign flipped
    (``ndtri(1 - y) = -ndtri(y)``): ``8 min(r - 3/8, n - r + 5/8) = 4
    min(k, 2n + 2 - k) - 3``; then rounded once to ``dtype`` and multiplied
    by ``1 / (8 (n + 1/4))`` (in float32 PyTorch's product with the
    reciprocal rounded to float32, as the card divides by a Python scalar;
    the 1/8 is exact). In float32 ``(r - 3/8) / (n + 1/4)`` rounds to 1 for
    the top rank from ``n = 2^24`` on, where ``ndtri`` gives +inf; here
    every argument lies in (0, 1/2]. The integers are int32 while ``8 n <
    2^31``."""
    k = k.to(torch.int32 if 8 * n < 2**31 else torch.int64)
    upper = k > n
    a8 = torch.minimum(k, (2 * n + 2) - k).mul_(4).sub_(3)
    z = torch.special.ndtri(a8.to(dtype).mul_(0.125 / (n + 0.25)))
    return torch.where(upper, -z, z)


def _scatter_rows(values_sorted: torch.Tensor,
                  order: torch.Tensor) -> torch.Tensor:
    """``(P, N)``: value ``values_sorted[p, j]`` at column ``order[p, j]`` of
    row ``p`` (the sorted rows back in their original order)."""
    return torch.empty_like(values_sorted).scatter_(1, order, values_sorted)


def tied_blom_plain(xs: torch.Tensor, order: torch.Tensor | None = None,
                    bad: torch.Tensor | None = None, *,
                    blom: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K12 (see ``tied_blom``)."""
    k = _run_sums(xs)
    v = blom_scores(k, xs.shape[1], xs.dtype) if blom else k.to(xs.dtype) * 0.5
    if bad is not None:
        v = v.masked_fill_(bad[:, None], torch.nan)
    return v if order is None else _scatter_rows(v, order)


def tied_blom(xs: torch.Tensor, order: torch.Tensor | None = None,
              bad: torch.Tensor | None = None, *,
              blom: bool = True) -> torch.Tensor:
    """K12: ``(P, N)``, the tied ("average") 1-based ranks of the rows ``xs``
    ``(P, N)``, each ascending, or with ``blom`` their Blom normal scores
    ``ndtri((rank - 0.375) / (N + 0.25))``; in sorted order, or with
    ``order`` ``(P, N)`` int64 (the original column of each sorted value, a
    permutation of each row) scattered back: the value of sorted entry ``j``
    at column ``order[p, j]``. A row whose ``bad`` ``(P,)`` entry is set
    comes out NaN throughout.

    Equal is ``==``: each NaN is a run of its own, ``-0.0`` and ``+0.0`` one
    run. The ranks are bit-equal to the plain version's (first + last is an
    integer rounded once to float32, then halved), and the scores follow
    its ``blom_scores`` (an exact numerator, from the far end on the upper
    half, so that they stay finite for rows of 2^24 entries and more) and
    PyTorch's ``ndtri``. The kernel finds the runs that
    cross its tiles' edges by searches that assume NaN last in the row; the
    card's sort puts a sign-bit NaN first, so a caller masks every row that
    holds a NaN (``ops.ranknorm._nan_rows``), by ``bad`` or afterwards: such
    a row is read in bounds and its values are meaningless. On the card
    ``xs`` must be float32 and contiguous, ``order`` int64 and contiguous,
    ``bad`` bool, all on one device, and ``N < 2^31 - 4096``.

    On the card a call with ``blom`` and ``N <= 2^22`` first fills a table
    of the ``2N + 1`` scores a row can hold (``blom_table``), and the
    scatter runs the rows in groups of ``group_rows(P)``, each in two
    passes through a pair buffer of 8 bytes an entry of the group (at most
    a float32 ``(P, N)`` array; ``csrc/tied_ranks.cu`` says why)."""
    if not backend.use_kernels(xs):
        return tied_blom_plain(xs, order, bad, blom=blom)
    if xs.dim() != 2 or not xs.is_contiguous():
        raise ValueError("tied_blom needs contiguous float32 rows xs (P, N)")
    p, n = xs.shape
    if order is not None and (order.shape != xs.shape
                              or order.dtype != torch.int64
                              or not order.is_contiguous()
                              or order.device != xs.device):
        raise ValueError("tied_blom: order must be contiguous int64 (P, N) "
                         "on the device of xs")
    if bad is not None and (bad.shape != (p,) or bad.dtype != torch.bool
                            or bad.device != xs.device):
        raise ValueError("tied_blom: bad must be bool (P,) on the device of "
                         "xs")
    ntiles = -(-n // _TILE)
    if not 1 <= n < 2**31 - _TILE or p * ntiles >= 2**31:
        raise ValueError(f"tied_blom: need 1 <= N < 2^31 - {_TILE} and P N / "
                         f"{_TILE} < 2^31, got ({p}, {n})")
    out = torch.empty_like(xs)
    if p == 0:
        return out
    bad = None if bad is None else bad.contiguous()
    inv_b = _inv_b(n)
    with torch.cuda.device(xs.device):
        table = blom_table(n, xs.device) if blom and n <= _TABLE_MAX_N else None
        mode = (_RANKS if not blom
                else _BLOM_NDTRI if table is None else _BLOM_TABLE)
        if order is None:
            _launch_rows(xs, None, bad, mode, table, inv_b, out=out)
        else:
            _scatter(xs, order, bad, mode, table, inv_b, out, group_rows(p))
    tied_blom.launches += 1
    return out


tied_blom.launches = 0


def group_rows(p: int) -> int:
    """Rows of one group of the scatter: the pair buffer, 8 bytes an entry
    of a group, costs at most one float32 ``(P, N)`` array."""
    return max(1, p // 2)


def blom_table(n: int, device) -> torch.Tensor:
    """``(2N + 1,)`` float32 on the card: entry ``k`` the Blom score of an
    entry whose run's 1-based first and last positions add up to ``k``,
    ``blom_scores(k, N)`` as the kernel computes it."""
    table = torch.empty(2 * n + 1, dtype=torch.float32, device=device)
    with torch.cuda.device(table.device):
        code = _build.library().mdt_blom_table(
            n, _inv_b(n), table.data_ptr(), _stream(table))
    _build.check(code, "mdt_blom_table")
    return table


def blom_from_counts(t: torch.Tensor, n: int) -> torch.Tensor:
    """K15: the float32 Blom scores ``blom_scores(t + 1, n)`` of the ring
    route's int32 counts ``t`` ``(P, N_loc)``, each the twice-rank minus 1
    (``2 cl + ce``) of its entry among the ``n`` entries of a row of the
    chain group (``parallel.ring_rank``), bit for bit the plain version's.
    Consumes ``t``: on the card the scores are written over its storage
    (``t.view(torch.float32)``) in one pass, 8 bytes an entry; elsewhere
    the plain ``blom_scores(t.add_(1), n)``. On the card ``t`` must be
    contiguous on a 16-byte boundary; ``2n + 1 < 2^31`` everywhere (the
    twice-rank in int32). One launch counted a call."""
    if t.dtype != torch.int32 or not 1 <= n or 2 * n + 1 >= 2**31:
        raise ValueError("blom_from_counts needs int32 counts of rows of "
                         f"1 <= n < 2^30 entries, got {t.dtype} and n={n}")
    z = t.view(torch.float32)
    if not backend.use_kernels(z):
        return blom_scores(t.add_(1), n, torch.float32)
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("blom_from_counts needs contiguous counts on a "
                         "16-byte boundary")
    with torch.cuda.device(t.device):
        code = _build.library().mdt_blom_counts(
            t.data_ptr(), t.numel(), n, _inv_b(n), _stream(t))
    _build.check(code, "mdt_blom_counts")
    blom_from_counts.launches += 1
    return z


blom_from_counts.launches = 0


def _inv_b(n: int) -> float:
    """What the card's division by the Python scalar ``n + 0.25``
    multiplies by: its reciprocal, rounded once to float32 (from ``N =
    2^22`` on, ``n + 0.25`` itself is no float32)."""
    return float(np.float32(1.0 / (n + 0.25)))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _launch_rows(xs, order, bad, mode, table, inv_b, *, out=None, cursor=None,
                 pairs=None) -> None:
    """One launch of the kernel over the rows ``xs``: their values in
    sorted order into ``out``, or (``order`` given: pass A) their pairs into
    ``pairs`` and counts into ``cursor``, the first rows of each."""
    p, n = xs.shape
    code = _build.library().mdt_tied_ranks(
        xs.data_ptr(), _ptr(order), _ptr(bad), n, p, mode, _ptr(table), inv_b,
        _ptr(out), _ptr(cursor), _ptr(pairs), _stream(xs))
    _build.check(code, "mdt_tied_ranks")


def _scatter(xs, order, bad, mode, table, inv_b, out, group: int) -> None:
    """The values of the rows ``xs`` scattered back by ``order`` into
    ``out``: pass A, then pass B, for each group of ``group`` rows, through
    one pair buffer and one set of cursors."""
    p, n = xs.shape
    cursor = torch.empty((group, -(-n // _BUCKET)), dtype=torch.int32,
                         device=xs.device)
    pairs = torch.empty((group, n, 2), dtype=torch.int32, device=xs.device)
    for r in range(0, p, group):
        rows = slice(r, r + group)
        gbad = None if bad is None else bad[rows]
        _launch_rows(xs[rows], order[rows], gbad, mode, table, inv_b,
                     cursor=cursor, pairs=pairs)
        _place(pairs, cursor, gbad, out[rows])


def _place(pairs, cursor, bad, out) -> None:
    """Pass B: the rows ``out`` from pass A's pairs and counts."""
    p, n = out.shape
    code = _build.library().mdt_tied_ranks_place(
        pairs.data_ptr(), cursor.data_ptr(), _ptr(bad), n, p, out.data_ptr(),
        _stream(out))
    _build.check(code, "mdt_tied_ranks_place")
