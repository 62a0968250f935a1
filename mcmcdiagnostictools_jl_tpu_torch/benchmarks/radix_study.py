"""K13, the exact rank mode's row sort, on the flagship exact call's rows.

``python -m mcmcdiagnostictools_jl_tpu_torch.benchmarks.radix_study`` (needs
the card) sorts the rows ``(P, 1.28M)`` of the flagship sample (10k draws x
128 chains x 256 params, float32, as ``chip_smoke.py`` makes it) for P =
256 and 64 (the bench's ``param_chunk``): K13 held bit for bit to
``torch.sort(dim=1, stable=True)`` (keys as bits, positions), then K13,
its keys-only form, ``torch.sort`` and the plain version timed in turns
behind a sleep on the card (medians of ``ROUNDS``), K13's launches one by
one under the profiler (the memset, the histograms, each digit pass),
``torch.sort``'s device time under the profiler (its host-bound launches
outlast the queue), and the peak memory of K13 and of ``torch.sort`` above
their input.

The design's ablation (digit width, keys a thread, blocks a
multiprocessor, ranking by ballots or ``__match_any_sync``, when the
positions are loaded) is in PERF.md (PR 17); its variants are not kept.
"""

from __future__ import annotations

import sys

import torch

from . import interleaved_ms, peak_gb
from .profile_calls import make_sample

SEED = 20261016  # chip_smoke.py's
SHAPE = (10_000, 128, 256)
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


def table(device=None) -> dict:
    from ..kernels import radix_sort as rs

    xr = flagship_rows(device)
    out = {}
    for p in (256, 64):
        x = xr[:p].contiguous() if p < xr.shape[0] else xr
        want = torch.sort(x, dim=1, stable=True)
        got = rs.sort_rows(x)
        if not (same_sort(got, want) and same_sort(rs.sort_rows(x), got)):
            raise RuntimeError(f"K13 differs from torch.sort at ({p}, N)")
        del want, got
        n = x.shape[1]
        ms = interleaved_ms({
            "K13": lambda: rs.sort_rows(x),
            "K13 keys": lambda: rs.sort_rows_keys(x),
            "torch.sort": lambda: torch.sort(x, dim=1, stable=True),
            "plain": lambda: rs.sort_rows_plain(x),
        }, ROUNDS)
        bound = rs.design_bytes(p, n) / 3.35e9
        floor = rs.floor_bytes(p, n) / 3.35e9
        pieces = launches_ms(lambda: rs.sort_rows(x))
        lib_device = device_ms(lambda: torch.sort(x, dim=1, stable=True))
        row = dict(ms=ms, design_bound_ms=bound, floor_ms=floor,
                   torch_sort_device_ms=lib_device,
                   launches=[(_short(k), v) for k, v in pieces],
                   peak_gb={"K13": peak_gb(lambda: rs.sort_rows(x)),
                            "torch.sort": peak_gb(
                                lambda: torch.sort(x, dim=1, stable=True))})
        out[p] = row
        print(f"({p}, {n}): K13 {ms['K13']:.3f} ms (design bound {bound:.3f},"
              f" {bound / ms['K13']:.0%}; floor {floor:.3f}), keys only "
              f"{ms['K13 keys']:.3f}, torch.sort {ms['torch.sort']:.3f} "
              f"(device {lib_device:.3f}), plain {ms['plain']:.3f}; peak +{row['peak_gb']['K13']:.3f} GB "
              f"(torch.sort +{row['peak_gb']['torch.sort']:.3f})", flush=True)
        print("   launches: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                          row["launches"]))
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("radix_study needs the card")
    table()
