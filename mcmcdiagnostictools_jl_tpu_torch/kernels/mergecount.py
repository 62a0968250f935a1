"""Kernel K14: the ring route's merge-count of a sorted block against a
sorted visiting block.

Stands for the JAX package's ``_count_block``
(``mcmcdiagnostictools_jl_tpu/parallel/ring_rank.py``), an XLA function
rather than a Pallas kernel. The CUDA source is ``csrc/merge_count.cu``; its
header says what bounds it on an H100 and how it merges.

For every entry ``x`` of the rows ``a`` ``(P, n)`` it counts the entries of
row ``p`` of ``b`` ``(P, m)`` below it, ``less = #{b < x}``, and not above
it, ``leq = #{b <= x}`` (float comparisons, ``-0.0 == +0.0``), and puts
them into int32 accumulators ``t`` and ``gpos`` ``(P, n)`` that the caller
owns, in place:

- ``first`` (``b`` is ``a``, the rank's own block): ``t = less + leq`` and
  ``gpos = i``, each entry's own index;
- else ``t += less + leq`` and ``gpos += leq`` where ``b``'s block is
  ring-earlier than ``a``'s (``earlier``), else ``gpos += less``.

``gpos`` may be None (the fold pass wants ``t`` alone). ``merge_count_plain``
forms the same integers with ``torch.searchsorted``; ``merge_count``
launches the kernel for a CUDA float32 ``a`` with int32 accumulators and
runs the plain version for any other input (CPU, float64, or accumulators
in int64, which rows of 2^30 entries and more need), never falling back
from one to the other.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build

_TILE = 4096  # merged entries of one row a block of the kernel (csrc: kTile)


def fits(n: int, m: int) -> bool:
    """Whether the kernel takes rows of ``n`` and ``m`` entries: their merge
    and a tile more index in int32."""
    return n + m < 2**31 - _TILE


def merge_count_plain(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor,
                      gpos: torch.Tensor | None = None, *, first: bool = False,
                      earlier: bool = False) -> None:
    """Plain PyTorch version of K14 (see ``merge_count``): the counts by
    ``torch.searchsorted``, in ``t``'s dtype."""
    narrow = t.dtype == torch.int32
    less = torch.searchsorted(b, a, side="left", out_int32=narrow)
    leq = torch.searchsorted(b, a, side="right", out_int32=narrow)
    if first:
        torch.add(less, leq, out=t)
        if gpos is not None:
            gpos.copy_(torch.arange(a.shape[1], dtype=gpos.dtype,
                                    device=gpos.device).expand_as(gpos))
        return
    t.add_(less).add_(leq)
    if gpos is not None:
        gpos.add_(leq if earlier else less)


def merge_count(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor,
                gpos: torch.Tensor | None = None, *, first: bool = False,
                earlier: bool = False) -> None:
    """K14: the counts of the rows ``a`` ``(P, n)`` against the rows ``b``
    ``(P, m)``, each ascending, into ``t`` (and ``gpos``) ``(P, n)``, in
    place (module docstring). With ``first``, ``b`` must be ``a``.

    On the card ``a`` and ``b`` are float32 and the accumulators int32, all
    contiguous on one device and on 16-byte boundaries (the kernel reads and
    writes 16 bytes a thread). A row that holds a NaN gives counts that mean
    nothing; the kernel keeps every read and write of such a row inside it,
    so the other rows' counts are exact. One launch counted a call."""
    if not backend.use_kernels(a) or t.dtype != torch.int32:
        return merge_count_plain(a, b, t, gpos, first=first, earlier=earlier)
    p, n = a.shape
    m = b.shape[1] if b.dim() == 2 else -1
    accs = (t,) if gpos is None else (t, gpos)
    if (b.shape != (p, m) or b.dtype != torch.float32 or b.device != a.device
            or not a.is_contiguous() or not b.is_contiguous()
            or any(x.shape != a.shape or x.dtype != torch.int32
                   or x.device != a.device or not x.is_contiguous()
                   for x in accs)
            or any(x.data_ptr() % 16 for x in (a, b) + accs)):
        raise ValueError("merge_count needs contiguous float32 a (P, n) and "
                         "b (P, m) and int32 t, gpos (P, n) on one device, "
                         "on 16-byte boundaries")
    if p == 0 or n == 0 or (m == 0 and not first):
        return None
    ntiles = -(-(n + m) // _TILE)
    if not fits(n, m) or p * (ntiles + 1) >= 2**31:
        raise ValueError(f"merge_count: need n + m < 2^31 - {_TILE} and "
                         f"P ((n + m) / {_TILE} + 1) < 2^31, got P={p}, "
                         f"n={n}, m={m}")
    lib = _build.library()
    with torch.cuda.device(a.device):
        parts = torch.empty((p, ntiles + 1, 2), dtype=torch.int32,
                            device=a.device)
        code = lib.mdt_merge_count(
            a.data_ptr(), n, b.data_ptr(), m, p, int(first), int(earlier),
            t.data_ptr(), None if gpos is None else gpos.data_ptr(),
            parts.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(code, "mdt_merge_count")
    merge_count.launches += 1
    return None


merge_count.launches = 0
