"""Kernel K11: per split-chain moments straight off a sorted sample.

Stands for the JAX package's ``weighted_segment_moments``
(``mcmcdiagnostictools_jl_tpu/ops/seghist.py``), an XLA function rather than
a Pallas kernel, with the split-chain ids of ``split_chain_ids_from_flat``
and the min / max of ``split_chain_stats_from_sorted`` folded in. The CUDA
source is ``csrc/segment_moments.cu``; its header says what bounds it on an
H100 and how it stays deterministic (fixed-point integer sums).

The tail R-hat needs only per-split-chain sums of the rank-normal folded
sample, which do not depend on order: the fold sort carries each value's
original flat position ``draw * nchains + chain``, and the split chain follows
from it by a formula, so nothing is scattered back to (draw, chain) order.
Values and positions are ``(P, N)``: the exact rank mode's rows, or the
ring route's ``(N, P)`` blocks as their transposed views; the kernel reads
either by the strides the wrapper passes.

``segment_moments`` launches the kernel for a CUDA float32 tensor and runs
``segment_moments_plain`` for any other, never falling back from one to the
other. ``split_chain_ids_from_flat`` and ``weighted_segment_moments`` are the
plain version's parts (the JAX package's names; ``ops/seghist.py`` exports
them).
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build


def split_chain_ids_from_flat(order: torch.Tensor, ndraws: int, nchains: int,
                              split: int):
    """``(seg, valid)`` of flat positions ``order`` (``draw * nchains +
    chain``): the split chain ``chain * split + k`` of each, and False for
    the draws that the remainder rule discards (with ``niter = ndraws //
    split``, ``d = ndraws % split``, splits ``k < d`` own draws ``[k (niter +
    1), k (niter + 1) + niter)``, splits ``k >= d`` own ``[k niter + d, (k +
    1) niter + d)``; reference src/utils.jl:29-36)."""
    niter, d = divmod(ndraws, split)
    draw = torch.div(order, nchains, rounding_mode="floor")
    chain = order - draw * nchains
    boundary = d * (niter + 1)
    in_first = draw < boundary
    later = ((draw - boundary) // niter + d) if niter > 0 else torch.zeros_like(draw)
    k = torch.where(in_first, draw // (niter + 1), later)
    valid = ~in_first | (draw % (niter + 1) < niter)
    return chain * split + k, valid


def weighted_segment_moments(values: torch.Tensor, seg: torch.Tensor,
                             valid: torch.Tensor, nseg: int):
    """``(sum, sumsq)``, each ``(nseg, P)``: per parameter, the sums of the
    valid ``values`` ``(P, N)`` and of their squares by segment ``seg``
    (segments differ per parameter). A plain segment sum (``index_add_``)."""
    p, n = values.shape
    w = torch.where(valid, values, 0)
    idx = (seg * p + torch.arange(p, device=seg.device)[:, None]).reshape(-1)
    sums = values.new_zeros(nseg * p).index_add_(0, idx, w.reshape(-1))
    sumsq = values.new_zeros(nseg * p).index_add_(0, idx, (w * w).reshape(-1))
    return sums.reshape(nseg, p), sumsq.reshape(nseg, p)


def segment_moments_plain(values: torch.Tensor, order: torch.Tensor,
                          ndraws: int, nchains: int, split: int):
    """Plain PyTorch version of K11: ``(sum, sumsq, vmin, vmax)``, the
    per-split-chain sums ``(nchains * split, P)`` of ``values`` ``(P, N)``
    and of their squares, by the flat positions ``order`` ``(P, N)``, and
    each parameter's min and max over the values of the draws the split
    keeps."""
    seg, valid = split_chain_ids_from_flat(order, ndraws, nchains, split)
    sums, sumsq = weighted_segment_moments(values, seg, valid, nchains * split)
    vmin = torch.where(valid, values, torch.inf).amin(1)
    vmax = torch.where(valid, values, -torch.inf).amax(1)
    return sums, sumsq, vmin, vmax


def segment_moments(values: torch.Tensor, order: torch.Tensor, ndraws: int,
                    nchains: int, split: int):
    """K11: the output of ``segment_moments_plain``, deterministic (two runs
    bit-equal) and exact to the float32 rounding of each sum. On the card
    ``values`` must be float32 and ``order`` int64, both ``(P, N)`` with the
    same strides, one of them 1 (rows, or the transpose of a contiguous
    ``(N, P)``), ``N = ndraws * nchains < 2^31``, and the values inside (-8,
    8) (rank-normal values are: a parameter holding another comes out
    NaN)."""
    if not backend.use_kernels(values):
        return segment_moments_plain(values, order, ndraws, nchains, split)
    p, n = values.shape
    sp, sn = values.stride()
    if (order.shape != values.shape or order.stride() != (sp, sn)
            or order.dtype != torch.int64 or order.device != values.device
            or not ((sn == 1 and sp >= n) or (sp == 1 and sn >= p))):
        raise ValueError("segment_moments needs float32 values (P, N) and "
                         "int64 order (P, N) on one device, with equal "
                         "strides, rows or columns contiguous")
    nseg = nchains * split
    if n != ndraws * nchains or not 1 <= n < 2**31 or split < 1:
        raise ValueError(f"segment_moments: {n} rows for {ndraws} draws x "
                         f"{nchains} chains (must match, below 2^31)")
    lib = _build.library()
    dev = values.device
    with torch.cuda.device(dev):
        acc = torch.empty((nseg, p, 2), dtype=torch.int64, device=dev)
        lohi = torch.empty((3, p), dtype=torch.int32, device=dev)
        sums = torch.empty((nseg, p), dtype=torch.float32, device=dev)
        sumsq = torch.empty_like(sums)
        vmin = torch.empty(p, dtype=torch.float32, device=dev)
        vmax = torch.empty_like(vmin)
        code = lib.mdt_segment_moments(
            values.data_ptr(), order.data_ptr(), ndraws, nchains, split, p,
            sp, sn, acc.data_ptr(), lohi.data_ptr(), sums.data_ptr(),
            sumsq.data_ptr(), vmin.data_ptr(), vmax.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mdt_segment_moments")
    segment_moments.launches += 1
    return sums, sumsq, vmin, vmax


segment_moments.launches = 0
