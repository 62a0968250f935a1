"""Kernel studies of the port: microbenchmarks that run on the card.

- ``micro_lagloop``: two formulations of the lag loop of K1/K5 (kernel K6);
- ``sort_microbench``: the traffic of one sort pass (K7, K8) and the bitonic
  sort of a pod (K9) beside the library sort;
- ``profile_calls``: where the device time of the port's flagship calls goes
  (``torch.profiler``, by kernel);
- ``gbt_contract``: the R* GBT's histogram and leaf products at config 5's
  shapes, one product against row blocks through ``torch.bmm``;
- ``tiedrank_study``: K12 on the flagship exact call's rows, for checkouts
  of the port in turns, and its table fill, scatter passes and group sizes;
- ``pass_study``: K7 and K8 in turns with ``add_``, for checkouts of the
  port in turns, and the pass kernel's variants (ring, stages, hint, store,
  walk) beside the first design;
- ``radix_study``: K13 on the flagship exact call's rows beside
  ``torch.sort``, its launches one by one, and its peak memory.
- ``mergecount_study``: K14 at the sharded cell's block in each of its
  modes, beside its bound and its plain version (``torch.searchsorted``
  and int32 adds).

Each entry point takes an explicit ``device`` (default: the card; it raises
if there is none), makes its data from an explicit seed with numpy, times
with CUDA events (each call queued behind a sleep on the card:
``queued_ms``, ``time_ms``, ``interleaved_ms``), and returns its outputs
with a small dict of times.
"""

from __future__ import annotations

import statistics

import torch


QUEUE_CYCLES = 2_000_000  # the card's sleep ahead of a timed call, ~1 ms


def queued_ms(fn, *args) -> float:
    """Device ms of one call of ``fn(*args)``, between two CUDA events
    queued behind ``QUEUE_CYCLES`` of ``torch.cuda._sleep`` on the card, so
    that the host's work to launch it (~25 us a launch on an H100's host)
    overlaps the sleep and only the device's time is counted."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    fn(*args)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs the card: CUDA events, no host clock")


def time_ms(fn, *, setup=None, reps: int = 5, warmup: bool = True) -> float:
    """Median ``queued_ms`` of ``fn(*setup())`` over ``reps`` calls after a
    warm-up: ``setup`` (fresh inputs for a function that works in place)
    runs outside the timed window."""
    _need_card()

    def args():
        return () if setup is None else setup()

    if warmup:
        fn(*args())
    return statistics.median([queued_ms(fn, *args()) for _ in range(reps)])


def interleaved_ms(fns: dict, rounds: int = 15) -> dict:
    """Median ``queued_ms`` of each callable of ``fns`` (no arguments),
    called in turns: a warm-up round, then ``rounds`` rounds."""
    _need_card()
    times = {name: [] for name in fns}
    for r in range(rounds + 1):
        for name, fn in fns.items():
            ms = queued_ms(fn)
            if r:
                times[name].append(ms)
    return {name: statistics.median(ts) for name, ts in times.items()}


def peak_gb(fn) -> float:
    """Peak device memory of one call of ``fn``, in GB above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9
