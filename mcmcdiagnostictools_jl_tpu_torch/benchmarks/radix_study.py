"""K13, the exact rank mode's row sort, on the flagship exact call's rows.

``python -m mcmcdiagnostictools_jl_tpu_torch.benchmarks.radix_study`` (needs
the card) sorts the rows ``(P, 1.28M)`` of the flagship sample (10k draws x
128 chains x 256 params, float32, as ``chip_smoke.py`` makes it) for P =
256 and 64 (the bench's ``param_chunk``), then standard normal rows at the
shapes the benchmark's sort cells run (``CELL_SHAPES``: 1000 rows of 1.28M,
``batched_c4.exact``; 125 rows of 6.25M, a call of
``many_chains_c5.nested``): K13 held bit for bit to
``torch.sort(dim=1, stable=True)`` (keys as bits, positions), then K13,
its keys-only form, ``torch.sort`` and the plain version timed in turns
behind a sleep on the card (medians of ``ROUNDS``), K13's launches one by
one under the profiler (the memset, the histograms, each digit pass),
``torch.sort``'s device time under the profiler (its host-bound launches
outlast the queue), and the peak memory of K13 and of ``torch.sort`` above
their input.

The design's ablations (PR 17: digit width, keys a thread, blocks a
multiprocessor, ranking by ballots or ``__match_any_sync``; PR 20: the
persistent digit pass's look-back, ticket order, tile size and how keys and
positions travel between passes) are in PERF.md; their variants are not
kept.
"""

from __future__ import annotations

import sys

import torch

from . import interleaved_ms, peak_gb
from .profile_calls import make_sample

SEED = 20261016  # chip_smoke.py's
SHAPE = (10_000, 128, 256)
CELL_SHAPES = ((1000, 1_280_000), (125, 6_250_000))
ROUNDS = 9


def flagship_rows(device=None) -> torch.Tensor:
    """The flagship sample's rows ``(256, 1.28M)``, as the exact call sorts
    them."""
    from ..ops.ranknorm import _rows

    return _rows(make_sample(SEED, SHAPE, device=device))


def launches_ms(fn) -> list:
    """``[(name, ms), ...]``: the device's kernels, memsets and copies of one
    warm call of ``fn`` in the order they ran."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.device_time / 1e3) for e in events]


def device_ms(fn) -> float:
    """Device ms of one warm call of ``fn`` under the profiler: the sum of
    its kernels, memsets and copies, whatever the host's time to launch
    them (``torch.sort`` of many rows launches more than the timer's queue
    hides)."""
    return sum(ms for _, ms in launches_ms(fn))


def _short(name: str) -> str:
    for key in ("radix_histogram", "radix_digit_pass", "Memset"):
        if key in name:
            return name[name.index(key):].split("(")[0]
    return name[:60]


def same_sort(a, b) -> bool:
    """Keys bit for bit and positions equal."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def study(x) -> dict:
    """K13 on the rows ``x`` held bit for bit to ``torch.sort``, then timed
    against it and the plain version; prints a line and returns the row."""
    from ..kernels import radix_sort as rs

    p, n = x.shape
    want = torch.sort(x, dim=1, stable=True)
    got = rs.sort_rows(x)
    if not (same_sort(got, want) and same_sort(rs.sort_rows(x), got)
            and torch.equal(rs.sort_rows_keys(x).view(torch.int32),
                            want[0].view(torch.int32))):
        raise RuntimeError(f"K13 differs from torch.sort at ({p}, {n})")
    del want, got
    ms = interleaved_ms({
        "K13": lambda: rs.sort_rows(x),
        "K13 keys": lambda: rs.sort_rows_keys(x),
        "torch.sort": lambda: torch.sort(x, dim=1, stable=True),
        "plain": lambda: rs.sort_rows_plain(x),
    }, ROUNDS)
    bound = rs.design_bytes(p, n) / 3.35e9
    floor = rs.floor_bytes(p, n) / 3.35e9
    pieces = launches_ms(lambda: rs.sort_rows(x))
    keys_pieces = launches_ms(lambda: rs.sort_rows_keys(x))
    lib_device = device_ms(lambda: torch.sort(x, dim=1, stable=True))
    row = dict(ms=ms, design_bound_ms=bound, floor_ms=floor,
               torch_sort_device_ms=lib_device,
               launches=[(_short(k), v) for k, v in pieces],
               keys_launches=[(_short(k), v) for k, v in keys_pieces],
               peak_gb={"K13": peak_gb(lambda: rs.sort_rows(x)),
                        "torch.sort": peak_gb(
                            lambda: torch.sort(x, dim=1, stable=True))})
    print(f"({p}, {n}): K13 {ms['K13']:.3f} ms (design bound {bound:.3f},"
          f" {bound / ms['K13']:.0%}; floor {floor:.3f}, "
          f"{floor / ms['K13']:.0%}), keys only {ms['K13 keys']:.3f}, "
          f"torch.sort {ms['torch.sort']:.3f} (device {lib_device:.3f}), "
          f"plain {ms['plain']:.3f}; peak +{row['peak_gb']['K13']:.3f} GB "
          f"(torch.sort +{row['peak_gb']['torch.sort']:.3f})", flush=True)
    for label, lv in (("launches", row["launches"]),
                      ("keys only", row["keys_launches"])):
        print(f"   {label}: " + ", ".join(f"{k} {v:.3f}" for k, v in lv))
    return row


def table(device=None) -> dict:
    xr = flagship_rows(device)
    out = {}
    for p in (256, 64):
        out[p] = study(xr[:p].contiguous() if p < xr.shape[0] else xr)
    del xr
    for p, n in CELL_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED + p)
        out[(p, n)] = study(torch.randn((p, n), generator=g, device="cuda"))
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("radix_study needs the card")
    table()
