"""Kernel K10: the exact rank mode's fold sort as one merge.

Stands for the JAX package's ``valley_sort_2d``
(``mcmcdiagnostictools_jl_tpu/ops/ranknorm.py``), an XLA function rather than
a Pallas kernel. The CUDA source is ``csrc/valley_merge.cu``; its header says
what bounds it on an H100 and how it reads the rows.

The exact rank mode keeps the sample as rows ``(P, N)``: each parameter's
sorted joint sample is one contiguous row. Along an ascending row the folded
keys ``|xs - med|`` fall, then rise (a valley), so their sorted order is a
merge of two sorted runs, each contiguous in the row. ``valley_sort_2d`` is
the plain version, the JAX package's two-axis decomposition written for rows,
with ``torch.sort`` on each short axis; ``valley_merge`` launches the kernel
for a CUDA float32 tensor and runs ``valley_merge_plain`` for any other,
never falling back from one to the other.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build

# The JAX package's block length of the two-axis decomposition: each row is
# viewed as (ceil(N / S), S) and sorted along each axis once
_VALLEY_BLOCK = 8192
_TILE = 2048  # outputs of one row a block of the merge kernel (csrc: kTile)


def valley_sort_2d(keys: torch.Tensor, payload: torch.Tensor,
                   s: int = _VALLEY_BLOCK):
    """Sort the valley sequences ``keys`` ``(P, N)`` (each row circularly
    bitonic: the shape of ``|xs - med|`` along a sorted row ``xs``) along dim
    1, carrying ``payload``: ``(keys sorted, payload)``, the keys
    bit-identical to ``torch.sort``'s (NaN last).

    Each row, padded with NaN to ``(M, s)``, is sorted along its long axis
    (dim 1 of the ``(P, M, s)`` view) and then within each block (dim 2):
    the first sort performs the high stages of a bitonic merge of the row,
    after which each block is bitonic and the blocks are in order (the JAX
    package's ``valley_sort_2d`` on the transpose). Both sorts are stable,
    so a row whose keys are all NaN keeps its order, and the pads, sorted
    after every key, are the entries cut off at the end. The pads are the
    NaN with every payload bit set: the card's radix sort orders NaNs by
    their bits (a NaN with the sign bit set, such as the host's ``-np.nan``
    or ``inf - inf``, ``0xffc00000``, first; any other last), and a NaN key
    of the data must not follow a pad. The keys are absolute values, so
    their NaNs have the sign bit clear (``0x7fc00000``, or ``0x7fffffff``
    from the card's arithmetic) and sort last, before the pads.
    """
    p, n = keys.shape
    m = -(-n // s)
    npad = m * s - n
    if npad:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}[
            keys.dtype]
        pad = keys.new_full((p, npad), torch.iinfo(bits).max,
                            dtype=bits).view(keys.dtype)
        keys = torch.cat([keys, pad], dim=1)
        payload = torch.cat([payload, payload.new_zeros((p, npad))], dim=1)
    k3, idx = torch.sort(keys.reshape(p, m, s), dim=1, stable=True)
    p3 = payload.reshape(p, m, s).gather(1, idx)
    k3, idx = torch.sort(k3, dim=2, stable=True)
    p3 = p3.gather(2, idx)
    return k3.reshape(p, -1)[:, :n], p3.reshape(p, -1)[:, :n]


def valley_merge_plain(xs: torch.Tensor, order: torch.Tensor,
                       med: torch.Tensor):
    """Plain PyTorch version of K10: ``valley_sort_2d(|xs - med|, order)``."""
    return valley_sort_2d(torch.abs(xs - med[:, None]), order)


def valley_merge(xs: torch.Tensor, order: torch.Tensor, med: torch.Tensor):
    """K10: ``(fs, forder)`` ``(P, N)``, ``|xs - med|`` of each row ascending
    (NaN last) with ``order`` carried along, from the rows ``xs`` ``(P, N)``
    ascending (NaN last), their payload ``order`` (int64) and the row
    medians ``med`` ``(P,)``. A row whose ``med`` is NaN keeps its ``xs``
    order. The kernel's searches assume NaN last in a row with a finite
    ``med``; the card's sort puts a sign-bit NaN first, so a caller gives
    every row that holds a NaN a NaN ``med`` (``ops.ranknorm._nan_rows``):
    its keys are then all NaN, its split 0, and it is read in bounds
    wherever its NaNs lie. Keys as ``valley_merge_plain``'s, payloads equal
    up to the order of tied keys. On the card ``xs`` must be float32, and
    ``xs`` and ``order`` contiguous, on 16-byte boundaries (the kernel reads
    and writes 16 bytes a thread)."""
    if not backend.use_kernels(xs):
        return valley_merge_plain(xs, order, med)
    p, n = xs.shape
    if (not xs.is_contiguous() or order.shape != xs.shape
            or order.dtype != torch.int64 or not order.is_contiguous()
            or order.device != xs.device or med.shape != (p,)
            or med.dtype != torch.float32 or med.device != xs.device
            or xs.data_ptr() % 16 or order.data_ptr() % 16):
        raise ValueError("valley_merge needs contiguous float32 xs (P, N), "
                         "int64 order (P, N), both on 16-byte boundaries, "
                         "and float32 med (P,) on one device")
    ntiles = -(-n // _TILE)
    if not 1 <= n < 2**31 - _TILE or p * (ntiles + 1) >= 2**31:
        raise ValueError(f"valley_merge: need 1 <= N < 2^31 - {_TILE} and "
                         f"P (N / {_TILE} + 1) < 2^31, got ({p}, {n})")
    med = med.contiguous()
    lib = _build.library()
    with torch.cuda.device(xs.device):
        ksplit = torch.empty(p, dtype=torch.int32, device=xs.device)
        splits = torch.empty((p, ntiles + 1), dtype=torch.int32,
                             device=xs.device)
        fs = torch.empty_like(xs)
        forder = torch.empty_like(order)
        code = lib.mdt_valley_merge(
            xs.data_ptr(), order.data_ptr(), n, p, med.data_ptr(),
            ksplit.data_ptr(), splits.data_ptr(), fs.data_ptr(),
            forder.data_ptr(),
            torch.cuda.current_stream(xs.device).cuda_stream,
        )
    _build.check(code, "mdt_valley_merge")
    valley_merge.launches += 1
    return fs, forder


valley_merge.launches = 0
