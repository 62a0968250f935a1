"""Kernel K13: a stable ascending sort of every row of ``(P, N)`` float32,
with each value's position in its row.

Stands for the JAX package's ``_sort_pair``
(``mcmcdiagnostictools_jl_tpu/ops/ranknorm.py:26-35``, XLA's ``lax.sort``;
not a Pallas kernel), the exact rank mode's sort. The CUDA source is
``csrc/radix_sort.cu``: a least-significant-digit radix sort of all rows at
once, one launch for the histograms of every digit and one a digit pass
(onesweep style: tiles handed out in order by a ticket on the card to a
persistent grid whose blocks load the next tile by the TMA while they work
on this one, ranked in the warp by ballots, placed by decoupled look-back),
in place of PyTorch's one cub radix sort a row; its header says what bounds
it on an H100.

The order is cub's for floats, bit for bit what the card's
``torch.sort(dim=1, stable=True)`` gives (checked on an H100 at rows of 1
to 30.7M entries): by the bits, a negative key's all flipped, any other's
sign bit, so a NaN with the sign bit set sorts before ``-inf`` and any other
NaN after ``+inf``; ``-0.0`` ties ``+0.0``; tied keys keep their order in
the row (stable). The keys come out with their own bits.

``sort_rows`` / ``sort_rows_keys`` launch the kernel for a CUDA float32
tensor and run the plain version ``sort_rows_plain`` for a CPU tensor or a
CUDA float64 tensor (``backend.use_kernels``; another CUDA dtype raises),
never falling back from one to the other. The plain version is one stable
``torch.sort`` of the integer keys of the same order (``order_keys``) and a
gather: the card's order on any device.
"""

from __future__ import annotations

import torch

from .. import backend
from . import _build

# as csrc/radix_sort.cu builds them: threads a block, keys a thread ranks at
# once, the parts of a tile (a ticket, a look-back word a digit), digit-pass
# blocks a multiprocessor, digit width, ticket words, the longest row (a
# count in 30 bits)
THREADS = 256
ITEMS = 15
PART = THREADS * ITEMS
PARTS = 2
TILE = PARTS * PART
BLOCKS_PER_SM = 3
BITS = 8
RADIX = 1 << BITS
PASSES = 32 // BITS
TICKET_WORDS = 8
MAX_N = 2**30 - 1
HIST_BLOCKS_PER_SM = 4  # histogram blocks the grid aims for, a multiprocessor
H100_SMS = 132
MAX_BLOCK_BYTES = 227 * 1024  # the most shared memory one block may take


def pass_smem(positions: bool = True) -> int:
    """Dynamic shared memory of a digit-pass block
    (``digit_pass_smem_bytes`` in the source): the ring's mbarriers and the
    ticket held, the warp sums, the digit bases of each part, the tile's
    digit counts, the per-warp digit counters, and the ring: ``PARTS``
    slots, each a part of 4-byte keys or, with positions, of 8-byte
    key-position pairs (16 bytes over, for a part that starts off a 16-byte
    boundary)."""
    warps = THREADS // 32
    head = (8 * PARTS + 16 + 8 * warps + 4 * PARTS * RADIX + 4 * RADIX
            + 4 * warps * RADIX)
    slot = (8 if positions else 4) * PART + 16
    return -(-head // 128) * 128 + PARTS * slot


def sort_plan(p: int, n: int, *, sms: int = H100_SMS,
              positions: bool = True) -> dict:
    """The launches of a sort of ``(p, n)``, as a dict:

    - ``tiles`` of ``TILE`` keys a row; ``tickets`` = ``p * tiles``, handed
      out in order to the persistent ``grid`` of each digit pass (as many
      blocks as the card holds at once, ``BLOCKS_PER_SM`` a multiprocessor,
      never more than the tickets; the source asks the occupancy API);
    - ``hist_chunks``: histogram blocks a row, so that the histogram grid
      (``hist_blocks``) aims at ``HIST_BLOCKS_PER_SM`` blocks a
      multiprocessor, at most one a tile;
    - the workspace in 4-byte words (``ws_words``): the histograms
      (``hist_words``: ``p`` x ``PASSES`` x ``RADIX``), ``TICKET_WORDS``
      tickets and two look-back buffers of ``status_words`` (a word a tile
      and digit); the call's one memset clears ``memset_bytes``, its head up
      to the second buffer;
    - ``smem``: a digit-pass block's dynamic shared memory;
    - ``launches``: the memset, the histogram and the passes.

    Raises ``ValueError`` for ``n`` outside ``[1, 2^30)`` and tickets past
    ``2^31 - 1``."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"rows of 1 to {MAX_N} entries, got {n}")
    tiles = -(-n // TILE)
    tickets = p * tiles
    if tickets >= 2**31:
        raise ValueError(f"{tickets} tiles is past 2^31 - 1 tickets")
    hist_chunks = max(1, min(tiles, -(-HIST_BLOCKS_PER_SM * sms // max(p, 1))))
    hist_words = p * PASSES * RADIX
    status_words = tickets * RADIX
    return dict(tiles=tiles, tickets=tickets,
                grid=min(BLOCKS_PER_SM * sms, tickets),
                hist_chunks=hist_chunks,
                hist_blocks=p * hist_chunks, chunk_len=-(-n // hist_chunks),
                hist_words=hist_words, status_words=status_words,
                ws_words=hist_words + TICKET_WORDS + 2 * status_words,
                memset_bytes=4 * (hist_words + TICKET_WORDS + status_words),
                smem=pass_smem(positions), launches=2 + PASSES)


def design_bytes(p: int, n: int, *, positions: bool = True) -> int:
    """Bytes the design moves: one read of the keys for the histograms,
    then a pass reads and writes the keys and, with ``positions``, reads
    (not in the first pass) and writes the int32 positions (int64 in the
    last): 68 bytes an entry, 36 for the keys alone."""
    per = 4
    for k in range(PASSES):
        per += 8
        if positions:
            per += (4 if k else 0) + (8 if k == PASSES - 1 else 4)
    return per * p * n


def floor_bytes(p: int, n: int, positions: bool = True) -> int:
    """Bytes of any sort: the keys read once, the keys and the int64
    positions written once (16 bytes an entry; 8 for the keys alone)."""
    return (16 if positions else 8) * p * n


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys of ``x`` (float32 -> int32, float64 -> int64)
    whose order is the kernel's: cub's key transform of the bits (a
    negative float's bits all flipped, any other's sign bit, compared
    unsigned) is, as a signed integer, ``bits ^ maxint`` for a set sign bit
    and ``bits`` otherwise; ``-0.0`` first becomes ``+0.0``."""
    ibits = {torch.float32: torch.int32, torch.float64: torch.int64}.get(
        x.dtype)
    if ibits is None:
        raise ValueError(f"sort_rows sorts float32 or float64, got {x.dtype}")
    info = torch.iinfo(ibits)
    b = x.contiguous().view(ibits)
    b = b.masked_fill(b == info.min, 0)
    return torch.where(b < 0, b ^ info.max, b)


def sort_rows_plain(x: torch.Tensor):
    """Plain PyTorch version of K13: ``(xs, order)``, each row of ``x``
    ``(P, N)`` sorted by ``order_keys`` with one stable ``torch.sort``, and
    the int64 positions of the sorted values in their rows. A sign-bit NaN
    first, any other NaN last, ``-0.0`` and ``+0.0`` tied, on every
    device."""
    idx = torch.sort(order_keys(x), dim=1, stable=True).indices
    return x.gather(1, idx), idx


def sort_rows(x: torch.Tensor):
    """K13: ``(xs, order)``, each row of ``x`` ``(P, N)`` sorted ascending
    and stable in the order of the module docstring, ``order`` ``(P, N)``
    int64 contiguous, the position in its row of each sorted value. On the
    card ``x`` must be contiguous float32 with ``N < 2^30``; the call takes
    8 bytes an entry of scratch (pairs of a key and its int32 position) and
    a workspace of ~2 KB a tile of 7680 entries beside its outputs."""
    if not backend.use_kernels(x):
        return sort_rows_plain(x)
    return _sort(x, positions=True)


def sort_rows_keys(x: torch.Tensor) -> torch.Tensor:
    """K13 for the keys alone: ``sort_rows(x)[0]``, with no positions moved
    (counted with ``sort_rows.launches``)."""
    if not backend.use_kernels(x):
        return sort_rows_plain(x)[0]
    return _sort(x, positions=False)[0]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _sort(x: torch.Tensor, *, positions: bool):
    """Launch the sort of the CUDA float32 rows ``x``."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("sort_rows needs contiguous float32 rows (P, N)")
    p, n = x.shape
    xs = torch.empty_like(x)
    order = (torch.empty((p, n), dtype=torch.int64, device=x.device)
             if positions else None)
    if x.numel() == 0:
        return xs, order
    lib = _build.library()
    plan = sort_plan(p, n, sms=torch.cuda.get_device_properties(
        x.device).multi_processor_count, positions=positions)
    tmp = torch.empty((p, n), dtype=torch.int64 if positions else torch.int32,
                      device=x.device)
    ws = torch.empty(plan["ws_words"], dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.mdt_radix_sort(
            x.data_ptr(), xs.data_ptr(), _ptr(order), tmp.data_ptr(),
            ws.data_ptr(), n, p, plan["hist_chunks"],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "mdt_radix_sort")
    sort_rows.launches += 1
    return xs, order


sort_rows.launches = 0
