"""K13, the exact rank mode's row sort (``kernels/radix_sort.py``), on the CPU.

- ``sort_rows_plain`` against an independent numpy sort by cub's key
  transform (unsigned: a negative float's bits all flipped, any other's sign
  bit; ``-0.0`` read as ``+0.0``), keys compared as bits and positions
  exactly, float32 and float64, on rows with ties, all-equal rows,
  ``+-inf``, ``+-0.0``, NaN with and without the sign bit, ``N = 1``,
  ``P = 1`` and ``N`` off the kernel's tile. The placement rule: a sign-bit
  NaN sorts before ``-inf``, any other NaN after ``+inf``, ``-0.0`` ties
  ``+0.0`` (tied keys keep their order in the row). Against the CPU's own
  ``torch.sort(stable=True)`` it is bit-equal wherever a row holds no
  sign-bit NaN, and otherwise differs only by moving those first;
- the launch plan (``sort_plan``): tiles cover a row, the tickets and the
  persistent grid, shared memory within a block's 227 KB and three blocks
  to a multiprocessor, the workspace and its memset, the bytes the design
  moves, the limits that raise, and the constants and the C signature
  against ``csrc/radix_sort.cu``; a numpy model of the digit passes with
  the kernel's bookkeeping (a persistent grid taking tickets in order, the
  next one once a tile's look-back is done, a tile's count published on
  arrival, ranked in parts, key-position pairs between passes), run in
  random interleavings of its blocks, never stalls and equals the plain
  sort;
- the routed callers (``sort_with_positions``, ``tiedrank``,
  ``batched_quantile``, the quantile MCSE, ``fold_impl="sort"``) against the
  JAX package at float64 within 1e-6, with a column holding a sign-bit NaN
  (poisoned on both sides);
- no CPU result changes: the exact calls with the routed sorts equal, bit
  for bit, the same calls with the CPU's ``torch.sort`` put back, on a
  sample without sign-bit NaNs; and a CPU tensor launches nothing.
"""

import re

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from conftest import ar1
from mcmcdiagnostictools_jl_tpu.ops import ranknorm as jrn
from mcmcdiagnostictools_jl_tpu_torch import kernels
from mcmcdiagnostictools_jl_tpu_torch.kernels import _build, radix_sort as rs
from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm as rn
from torch_parity import assert_close, t

KINDS = ["normal", "ties", "all_equal", "infinities", "signed_zeros", "nan",
         "signed_nan", "mixed"]
SHAPES = [(1, 1), (4, 1), (1, 7), (3, 300), (2, rs.TILE + 1),
          (2, 2 * rs.TILE - 5)]
DTYPES = [np.float32, np.float64]
_UINT = {np.float32: np.uint32, np.float64: np.uint64}
_SINT = {np.float32: np.int32, np.float64: np.int64}


def _rows(kind, p, n, dtype, seed=0):
    """``(p, n)`` unsorted rows holding what ``kind`` names."""
    rng = np.random.default_rng(seed + 7 * n + p)
    x = rng.standard_normal((p, n))
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "all_equal":
        x[:] = 0.75
    elif kind == "infinities":
        x[:, ::3] = np.inf
        x[:, 1::4] = -np.inf
    elif kind == "signed_zeros":
        x[:, ::2] = -0.0
        x[:, 1::3] = 0.0
    elif kind == "nan":
        x[:, ::3] = np.nan
    elif kind == "signed_nan":
        x[:, ::3] = -np.nan
        x[:, 1::5] = np.nan
    elif kind == "mixed":
        x = np.round(x * 2) / 2
        x[:, ::7] = -0.0
        x[:, 1::11] = -np.nan
        x[:, 2::13] = np.nan
        x[:, 3::5] = -np.inf
        x[:, 4::9] = np.inf
    return x.astype(dtype)


def _numpy_sort(x):
    """The kernel's order in numpy, on unsigned keys: ``(values, idx)``."""
    u = x.view(_UINT[x.dtype.type]).copy()
    sign = u.dtype.type(1) << u.dtype.type(8 * u.itemsize - 1)
    u[u == sign] = 0
    key = np.where(u & sign, ~u, u | sign)
    idx = np.argsort(key, axis=1, kind="stable")
    return np.take_along_axis(x, idx, 1), idx


def _bits(a):
    a = np.asarray(a)
    return a.view(_SINT[a.dtype.type])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_plain_sort_is_cubs_order_stable(kind, shape, dtype):
    x = _rows(kind, *shape, dtype)
    xs, order = rs.sort_rows_plain(t(x))
    want, idx = _numpy_sort(x)
    assert order.dtype == torch.int64 and order.is_contiguous()
    assert xs.shape == order.shape == shape and xs.dtype == t(x).dtype
    np.testing.assert_array_equal(_bits(xs.numpy()), _bits(want))
    np.testing.assert_array_equal(order.numpy(), idx)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_plain_sort_against_the_cpus_torch_sort(kind, shape, dtype):
    """Equal bit for bit where a row holds no sign-bit NaN; elsewhere the
    sign-bit NaNs come first, in their row order, and the rest is the CPU's
    order."""
    x = t(_rows(kind, *shape, dtype))
    xs, order = rs.sort_rows_plain(x)
    ref, ridx = torch.sort(x, dim=1, stable=True)
    neg_nan = torch.isnan(x) & torch.signbit(x)
    for r in range(x.shape[0]):
        k = int(neg_nan[r].sum())
        first = torch.nonzero(neg_nan[r]).flatten()
        assert torch.equal(order[r, :k], first)
        rest = ridx[r][~neg_nan[r][ridx[r]]]
        assert torch.equal(order[r, k:], rest)
    assert torch.equal(xs, x.gather(1, order)) or bool(torch.isnan(xs).any())
    if not bool(neg_nan.any()):
        assert torch.equal(order, ridx)
        np.testing.assert_array_equal(_bits(xs.numpy()), _bits(ref.numpy()))


def test_placement_rule_on_one_row():
    x = torch.tensor([[1.0, -np.nan, np.inf, np.nan, -np.inf, -0.0, 0.0,
                       -0.0, -1.0]], dtype=torch.float32)
    xs, order = rs.sort_rows_plain(x)
    assert order.tolist() == [[1, 4, 8, 5, 6, 7, 0, 2, 3]]
    assert torch.signbit(xs[0, 3]) and not torch.signbit(xs[0, 4])
    assert torch.equal(rs.sort_rows_keys(x).view(torch.int32),
                       xs.view(torch.int32))


def test_order_keys_raise_for_other_dtypes():
    with pytest.raises(ValueError, match="float32 or float64"):
        rs.sort_rows(torch.zeros((2, 3), dtype=torch.int32))


# ---- the launch plan --------------------------------------------------------

PLAN_SHAPES = [(256, 1_280_000), (64, 1_280_000), (1, 1), (1, rs.TILE),
               (1, rs.TILE + 1), (7, 12345), (3, 100), (512, 20_000),
               (1, rs.MAX_N)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plan_tiles_every_row(shape):
    p, n = shape
    plan = rs.sort_plan(p, n)
    assert (plan["tiles"] - 1) * rs.TILE < n <= plan["tiles"] * rs.TILE
    assert plan["tickets"] == p * plan["tiles"] < 2**31
    # the persistent grid: what the card holds at once, never more tickets
    assert plan["grid"] == min(rs.BLOCKS_PER_SM * rs.H100_SMS,
                               plan["tickets"])
    assert rs.PASSES * rs.BITS == 32 and rs.RADIX == 2**rs.BITS
    assert plan["launches"] == 2 + rs.PASSES
    # the histogram chunks cover each row once, none of them empty
    c, ln = plan["hist_chunks"], plan["chunk_len"]
    assert 1 <= c <= plan["tiles"] and (c - 1) * ln < n <= c * ln
    assert plan["hist_blocks"] == p * c
    if p <= rs.HIST_BLOCKS_PER_SM * rs.H100_SMS and plan["tiles"] > 1:
        assert plan["hist_blocks"] >= min(rs.HIST_BLOCKS_PER_SM * rs.H100_SMS,
                                          p * plan["tiles"])


@pytest.mark.parametrize("positions", [True, False])
def test_plan_shared_memory_fits_a_block(positions):
    smem = rs.pass_smem(positions)
    assert smem <= rs.MAX_BLOCK_BYTES
    warps = rs.THREADS // 32
    # the ring: a slot a part, of keys or key-position pairs, and the
    # per-warp digit counters beside it
    assert smem >= 4 * warps * rs.RADIX + rs.PARTS * rs.PART * (
        8 if positions else 4)
    assert smem % 16 == 0
    # BLOCKS_PER_SM blocks to a multiprocessor's 228 KB (1 KB a block is
    # the system's)
    assert rs.BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024
    assert rs.sort_plan(3, 5000, positions=positions)["smem"] == smem


def test_plan_workspace():
    p, n = 256, 1_280_000
    plan = rs.sort_plan(p, n)
    radix, tiles = rs.RADIX, -(-n // rs.TILE)
    assert plan["hist_words"] == p * rs.PASSES * radix
    assert plan["status_words"] == p * tiles * radix
    assert plan["ws_words"] == (plan["hist_words"] + rs.TICKET_WORDS
                                + 2 * plan["status_words"])
    # the memset clears the histograms, the tickets and the first look-back
    # buffer, and stops at the second
    assert plan["memset_bytes"] == 4 * (plan["ws_words"]
                                        - plan["status_words"])
    assert rs.TICKET_WORDS >= rs.PASSES
    # (256, 1.28M): 167 tiles a row, ~88 MB of look-back
    assert tiles == 167 and 8 * plan["status_words"] < 90e6


def test_plan_bytes():
    p, n = 256, 1_280_000
    assert rs.design_bytes(p, n) == 68 * p * n
    assert rs.design_bytes(p, n, positions=False) == 36 * p * n
    assert rs.floor_bytes(p, n) == 16 * p * n
    # the bound of the design at 3.35 TB/s: 6.65 ms; of any sort: 1.57 ms
    assert round(rs.design_bytes(p, n) / 3.35e9, 2) == 6.65
    assert round(rs.floor_bytes(p, n) / 3.35e9, 2) == 1.57


@pytest.mark.parametrize("args,match", [
    ((2, 0), "rows of 1"), ((2, 2**30), "rows of 1"),
    ((2**22, 600 * rs.TILE), "tickets")])
def test_plan_limits_raise(args, match):
    with pytest.raises(ValueError, match=match):
        rs.sort_plan(*args)


def _model_digit_passes(x, grid=3, seed=0):
    """K13's passes in numpy with ``csrc/radix_sort.cu``'s bookkeeping, its
    ``grid`` persistent blocks stepped in a random order (``seed``): the
    histograms of every digit first; then in a pass each block holds one
    ticket (handed out in order) and takes its next only once its tile's
    look-back is done. A tile, on arrival, publishes its count of each digit
    (the row's first tile as a prefix); ranks each part of ``PART`` keys
    stably by digit (keys past the row's end take the last digit and rank
    after the part's own); looks back over the row's earlier tiles' words,
    nearest first, adding counts until a prefix (a block whose walk meets an
    unpublished word waits), and publishes its own prefix; then writes each
    key to the row's exclusive histogram sum of its digit plus the prefix
    plus the digit's keys in the tile's earlier parts plus its rank in its
    part. Between passes keys and positions travel as pairs; the first pass
    takes each key's place in its row as its position. Returns the last
    pass's keys (as bits) and positions; raises if the blocks stall, or a
    key would land outside its row or on a slot already written."""
    p, n = x.shape
    plan = rs.sort_plan(p, n)
    tiles, total = plan["tiles"], plan["tickets"]
    keys = x.view(np.uint32).copy()
    pos = np.tile(np.arange(n), (p, 1))  # the first pass: the keys' places
    rng = np.random.default_rng(seed)
    agg, pre = 1, 2  # a word's flag: the tile's count, or its prefix

    def ordered(b):
        b = np.where(b == 0x80000000, np.uint32(0), b).astype(np.uint32)
        return np.where(b & np.uint32(0x80000000), ~b,
                        b | np.uint32(0x80000000)).astype(np.uint32)

    def digit(b, k):
        return ((ordered(b) >> np.uint32(rs.BITS * k))
                & np.uint32(rs.RADIX - 1)).astype(np.int64)

    hist = np.stack([[np.bincount(digit(keys[r], k), minlength=rs.RADIX)
                      for k in range(rs.PASSES)] for r in range(p)])
    for k in range(rs.PASSES):
        flag = np.zeros((total, rs.RADIX), np.int64)
        value = np.zeros((total, rs.RADIX), np.int64)
        out_k = np.zeros_like(keys)
        out_p = np.full((p, n), -1, np.int64)
        next_ticket = min(grid, total)
        blocks = [dict(t=b, step="arrive") for b in range(next_ticket)]
        while any(blk["step"] != "done" for blk in blocks):
            moved = False
            for blk in (blocks[i] for i in rng.permutation(len(blocks))):
                t, step = blk["t"], blk["step"]
                row, tile = divmod(t, tiles)
                if step == "done":
                    continue
                if step == "arrive":
                    start = tile * rs.TILE
                    count = min(rs.TILE, n - start)
                    d = digit(keys[row, start:start + count], k)
                    blk["cnt"] = np.bincount(d, minlength=rs.RADIX)
                    flag[t] = pre if tile == 0 else agg
                    value[t] = blk["cnt"]
                    parts = []
                    for q in range(rs.PARTS):
                        part = max(0, min(rs.PART, count - q * rs.PART))
                        dq = np.full(rs.PART, rs.RADIX - 1)
                        dq[:part] = d[q * rs.PART:q * rs.PART + part]
                        rank = np.empty(rs.PART, np.int64)
                        rank[np.argsort(dq, kind="stable")] = np.arange(rs.PART)
                        assert (rank[:part] < part).all()  # padding ranks last
                        cq = np.bincount(dq, minlength=rs.RADIX)
                        parts.append((start + q * rs.PART, part, dq, rank,
                                      np.cumsum(cq) - cq))
                    blk["parts"], blk["step"] = parts, "look back"
                elif step == "look back":
                    prefix = np.zeros(rs.RADIX, np.int64)
                    if tile > 0:
                        found = np.zeros(rs.RADIX, bool)
                        for back in range(t - 1, t - tile - 1, -1):
                            if (flag[back][~found] == 0).any():
                                break  # a word not out yet: wait
                            prefix += np.where(found, 0, value[back])
                            found |= flag[back] == pre
                            if found.all():
                                break
                        if not found.all():
                            continue
                        flag[t], value[t] = pre, prefix + blk["cnt"]
                    blk["prefix"], blk["step"] = prefix, "write"
                    blk["next"] = next_ticket
                    next_ticket += 1
                else:  # "write"
                    row_excl = np.cumsum(hist[row, k]) - hist[row, k]
                    earlier = np.zeros(rs.RADIX, np.int64)  # the tile's parts
                    for start, part, dq, rank, part_excl in blk["parts"]:
                        d = dq[:part]
                        dst = (row_excl[d] + blk["prefix"][d] + earlier[d]
                               + rank[:part] - part_excl[d])
                        assert ((0 <= dst) & (dst < n)).all()
                        assert (out_p[row, dst] == -1).all()
                        out_k[row, dst] = keys[row, start:start + part]
                        out_p[row, dst] = pos[row, start:start + part]
                        earlier += np.bincount(dq, minlength=rs.RADIX)
                    assert (blk["prefix"] + blk["cnt"]).max() <= rs.MAX_N
                    blk["t"] = blk["next"]
                    blk["step"] = "arrive" if blk["t"] < total else "done"
                moved = True
            assert moved, "every block waits: the look-back stalled"
        keys, pos = out_k, out_p
    return keys, pos


@pytest.mark.parametrize("grid", [1, 3, 7])
@pytest.mark.parametrize("shape", [(1, 1), (3, 300), (2, rs.PART + 1),
                                   (2, rs.TILE + 1), (1, 3 * rs.TILE - 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_model_of_the_digit_passes_equals_the_plain_sort(kind, shape, grid):
    """The kernel's bookkeeping (digits of cub's key map with ``-0.0`` read
    as ``+0.0``, stable ranks in a part, the padding of a row's last tile,
    histogram sums plus look-back plus the tile's earlier parts, tickets
    taken after the look-back by a persistent grid) gives the plain
    version's sort in any interleaving of the blocks."""
    x = _rows(kind, *shape, np.float32)
    keys, pos = _model_digit_passes(x, grid=grid, seed=len(kind) + grid)
    xs, order = rs.sort_rows_plain(t(x))
    np.testing.assert_array_equal(keys.view(np.int32), _bits(xs.numpy()))
    np.testing.assert_array_equal(pos, order.numpy())


def _source():
    return (_build.CSRC_DIR / "radix_sort.cu").read_text()


def test_constants_agree_with_the_cuda_source():
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") == rs.THREADS
    assert const("kItems") == rs.ITEMS
    assert const("kParts") == rs.PARTS
    assert const("kMinBlocks") == rs.BLOCKS_PER_SM
    assert const("kBits") == rs.BITS
    assert re.search(r"constexpr int kPasses = 32 / kBits;", src)
    assert const("kTicketWords") == rs.TICKET_WORDS
    assert 2 ** const("kMaxLog2N") - 1 == rs.MAX_N
    assert rs.TILE == rs.PARTS * rs.PART == rs.PARTS * rs.THREADS * rs.ITEMS


def test_signature_agrees_with_the_cuda_source():
    sig = re.search(r'extern "C" int mdt_radix_sort\(([^)]*)\)', _source())[1]
    params = [a.strip() for a in sig.split(",")]
    assert len(params) == len(_build._SIGNATURES["mdt_radix_sort"])
    ints = [i for i, a in enumerate(params) if a.startswith("int ")]
    want = [i for i, a in enumerate(_build._SIGNATURES["mdt_radix_sort"])
            if a is _build._I]
    assert ints == want


# ---- the routed callers against the JAX package ------------------------------

def _sample(rng, shape=(301, 4, 5), neg_nan=True):
    """float64 AR(1) chains: column 1 holds ties and signed zeros, column 3 a
    NaN (with the sign bit when ``neg_nan``), column 4 +-inf."""
    x = ar1(rng, 0.5, 1.0, shape)
    x[:, :, 1] = np.round(x[:, :, 1] * 2) / 2
    x[::4, :, 1] = -0.0
    x[7, 2, 3] = -np.nan if neg_nan else np.nan
    x[:2, 0, 4] = [np.inf, -np.inf]
    return x


def test_sort_with_positions_matches_jax(rng):
    x = _sample(rng)
    xs, order, bad = rn.sort_with_positions(t(x))
    jxs, jorder, jbad = jrn.sort_with_positions(x)
    assert xs.shape == order.shape == (5, 301 * 4)
    assert bad.tolist() == np.asarray(jbad).tolist() == [False, False, False,
                                                          True, False]
    assert torch.isnan(xs[3, 0]) and torch.signbit(xs[3, 0])  # first
    for c in (0, 1, 2, 4):
        np.testing.assert_array_equal(xs[c].numpy(), np.asarray(jxs)[:, c])
    # continuous columns have no ties: the same positions as JAX's sort
    for c in (0, 2):
        np.testing.assert_array_equal(order[c].numpy(),
                                      np.asarray(jorder)[:, c])
    # ties keep their flat order
    for v in torch.unique(xs[1]):
        flat = order[1][xs[1] == v]
        assert torch.equal(flat, torch.sort(flat).values)


def test_tiedrank_matches_jax(rng):
    x = _sample(rng).reshape(-1, 5)
    got = rn.tiedrank(t(x))
    want = np.asarray(jrn.tiedrank(np.where(np.isnan(x), np.nan, x)))
    assert_close(got, want)
    # a sign-bit NaN ranks last, as a +nan does
    pos = x.copy()
    pos[np.isnan(pos)] = np.nan
    assert torch.equal(got, rn.tiedrank(t(pos)))


@pytest.mark.parametrize("p", [0.5, 0.1, 0.93])
def test_batched_quantile_matches_jax(rng, p):
    x = _sample(rng)
    got = rn.batched_quantile(t(x), p)
    assert bool(torch.isnan(got[3]))
    assert_close(got, jrn.batched_quantile(x, p))


@pytest.mark.parametrize("q", [0.25, 0.5, 0.9])
def test_quantile_mcse_matches_jax(rng, q):
    x = _sample(rng)
    got = mtt.mcse(t(x), kind=mtt.Quantile(q))
    assert bool(torch.isnan(got[3]))
    assert_close(got, mdt.mcse(x, kind=mdt.Quantile(q)))


@pytest.mark.parametrize("kind", ["rank", "tail", "bulk"])
def test_fold_sort_route_matches_jax(rng, kind):
    x = _sample(rng)
    got = mtt.ess_rhat(t(x), kind=kind, fold_impl="sort")
    want = mdt.ess_rhat(x, kind=kind, fold_impl="sort")
    for g, w in ((got.ess, want.ess), (got.rhat, want.rhat)):
        assert bool(torch.isnan(g[3]))
        assert_close(g, w)


def test_fold_sort_route_gathers_order(rng):
    """The fold route sorts the folded keys with positions and gathers the
    flat rows by them: the same keys and rows as a stable sort of the keys
    carrying the rows."""
    x = _sample(rng, neg_nan=False)
    xs, order, bad = rn.sort_with_positions(t(x))
    med = torch.where(bad, torch.nan, rn.sorted_quantile(xs, 0.5))
    zf, forder = rn.folded_rank_values_sorted(xs, order, med)
    keys = torch.abs(xs - med[:, None])
    ks, kidx = torch.sort(keys, dim=1, stable=True)
    assert torch.equal(forder[~bad], order.gather(1, kidx)[~bad])
    assert torch.equal(zf[~bad], kernels.tiedrank.tied_blom_plain(ks)[~bad])


# ---- no CPU result changes --------------------------------------------------

def _torch_sort_rows(x):
    return torch.sort(x, dim=1, stable=True)


EXACT_CALLS = [
    ("ess_rhat", dict(kind="rank")),
    ("ess_rhat", dict(kind="rank", fold_impl="sort")),
    ("ess_rhat", dict(kind="tail", fold_impl="sort")),
    ("ess", dict(kind="median")),
    ("ess", dict(kind="mad")),
    ("ess", dict(kind="tail")),
    ("mcse", dict(kind=mtt.Quantile(0.3))),
    ("mcse", dict(kind="median")),
]


@pytest.mark.parametrize("fn,kw", EXACT_CALLS, ids=lambda v: str(v))
def test_no_cpu_result_changes(monkeypatch, rng, fn, kw):
    """The routed sorts against the CPU's ``torch.sort`` (the calls'
    sort before K13), on a sample with ties, signed zeros, +-inf and a +nan
    column: bit-equal."""
    x = t(_sample(rng, neg_nan=False))
    got = getattr(mtt, fn)(x, **kw)
    monkeypatch.setattr(rn, "sort_rows", _torch_sort_rows)
    monkeypatch.setattr(rn, "sort_rows_keys",
                        lambda v: _torch_sort_rows(v).values)
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics import mcse as mcse_mod
    monkeypatch.setattr(mcse_mod, "sort_rows_keys",
                        lambda v: _torch_sort_rows(v).values)
    want = getattr(mtt, fn)(x, **kw)
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[~torch.isnan(g)], w[~torch.isnan(w)])


def test_cpu_tensors_launch_nothing(rng):
    kernels.reset_launch_counts()
    x = t(_sample(rng))
    mtt.ess_rhat(x, kind="rank", fold_impl="sort")
    rs.sort_rows(x.reshape(-1, 5).t().contiguous())
    rs.sort_rows_keys(x.reshape(-1, 5).t().contiguous())
    assert kernels.launch_counts()["K13"] == 0
