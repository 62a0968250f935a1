"""Kernel K10: the exact rank mode's fold sort as one merge.

Stands for the JAX package's ``valley_sort_2d``
(``mcmcdiagnostictools_jl_tpu/ops/ranknorm.py``), an XLA function rather than
a Pallas kernel. The CUDA source is ``csrc/valley_merge.cu``; its header says
what bounds it on an H100 and how it reads the row-major sample.

In ascending ``xs`` order the folded keys ``|xs - med|`` of a column fall,
then rise (a valley), so their sorted order is a merge of two sorted runs.
``valley_sort_2d`` is the plain version, the JAX package's two-axis
decomposition with ``torch.sort`` on each short axis; ``valley_merge`` launches
the kernel for a CUDA float32 tensor and runs ``valley_merge_plain`` for any
other, never falling back from one to the other.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build

# The JAX package's block length of the two-axis decomposition: the flattened
# sample is viewed as (ceil(N / S), S) and sorted along each axis once
_VALLEY_BLOCK = 8192
_TILE = 256  # output rows a block of the merge kernel (csrc: kTile)


def valley_sort_2d(keys: torch.Tensor, payload: torch.Tensor,
                   s: int = _VALLEY_BLOCK):
    """Sort per-column valley sequences ``keys`` ``(N, P)`` (circularly
    bitonic: the shape of ``|xs - med|`` along a sorted ``xs``) along dim 0,
    carrying ``payload``: ``(keys sorted, payload)``, the keys bit-identical
    to ``torch.sort``'s (NaN last).

    The sequence, padded with NaN to ``(M, s)``, is sorted along its long
    axis and then within each block: the first sort performs the high stages
    of a bitonic merge of every column, after which each block is bitonic and
    the blocks are in order (the JAX package's ``valley_sort_2d``). Both
    sorts are stable, so a column whose keys are all NaN keeps its order, and
    the pads, sorted after every key, are the rows cut off at the end. The
    pads are the NaN with every payload bit set: the card's sort orders NaNs
    by their bits, and a NaN key of the data (``0x7fffffff`` from the card's
    arithmetic, ``0x7fc00000`` from the host's) must not follow a pad.
    """
    n, p = keys.shape
    m = -(-n // s)
    npad = m * s - n
    if npad:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}[
            keys.dtype]
        pad = keys.new_full((npad, p), torch.iinfo(bits).max,
                            dtype=bits).view(keys.dtype)
        keys = torch.cat([keys, pad])
        payload = torch.cat([payload, payload.new_zeros((npad, p))])
    k3, idx = torch.sort(keys.reshape(m, s, p), dim=0, stable=True)
    p3 = payload.reshape(m, s, p).gather(0, idx)
    k3, idx = torch.sort(k3, dim=1, stable=True)
    p3 = p3.gather(1, idx)
    return k3.reshape(-1, p)[:n], p3.reshape(-1, p)[:n]


def valley_merge_plain(xs: torch.Tensor, order: torch.Tensor,
                       med: torch.Tensor):
    """Plain PyTorch version of K10: ``valley_sort_2d(|xs - med|, order)``."""
    return valley_sort_2d(torch.abs(xs - med[None, :]), order)


def valley_merge(xs: torch.Tensor, order: torch.Tensor, med: torch.Tensor):
    """K10: ``(fs, forder)``, ``|xs - med|`` of each column ascending (NaN
    last) with ``order`` carried along, from ``xs`` ``(N, P)`` ascending
    along dim 0 (NaN last), its payload ``order`` (int64) and the column
    medians ``med`` ``(P,)``. A column whose ``med`` is NaN keeps its ``xs``
    order. Keys as ``valley_merge_plain``'s, payloads equal up to the order
    of tied keys. A CUDA tensor must be float32 and contiguous."""
    if not backend.use_kernels(xs):
        return valley_merge_plain(xs, order, med)
    n, p = xs.shape
    if (not xs.is_contiguous() or order.shape != xs.shape
            or order.dtype != torch.int64 or not order.is_contiguous()
            or order.device != xs.device or med.shape != (p,)
            or med.dtype != torch.float32 or med.device != xs.device):
        raise ValueError("valley_merge needs contiguous float32 xs (N, P), "
                         "int64 order (N, P) and float32 med (P,) on its device")
    if not 1 <= n < 2**31 - 2 * _TILE or p >= 2**31:
        raise ValueError(f"valley_merge: need 1 <= N < 2^31 - {2 * _TILE}, "
                         f"got {n}")
    med = med.contiguous()
    ntiles = -(-n // _TILE)
    lib = _build.library()
    with torch.cuda.device(xs.device):
        ksplit = torch.empty(p, dtype=torch.int32, device=xs.device)
        splits = torch.empty((ntiles + 1, p), dtype=torch.int32,
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
