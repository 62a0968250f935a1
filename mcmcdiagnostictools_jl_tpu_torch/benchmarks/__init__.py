"""Kernel studies of the port: microbenchmarks that run on the card.

- ``micro_lagloop``: two formulations of the lag loop of K1/K5 (kernel K6);
- ``sort_microbench``: the traffic of one sort pass (K7, K8) and the bitonic
  sort of a pod (K9) beside the library sort;
- ``profile_calls``: where the device time of the port's flagship calls goes
  (``torch.profiler``, by kernel);
- ``gbt_contract``: the R* GBT's histogram and leaf products at config 5's
  shapes, one product against row blocks through ``torch.bmm``;
- ``ab_walls``: the flagship calls' walls and peak memory of two checkouts
  of the port, in turns, one process a run (host walls, each call ending in
  a synchronize);
- ``nan_probe``: where the card's sort puts a sign-bit NaN, and the exact
  calls' values in its column, for checkouts of the port;
- ``tiedrank_study``: K12 on the flagship exact call's rows, for checkouts
  of the port in turns, and its table fill, scatter passes and group sizes;
- ``pass_study``: K7 and K8 in turns with ``add_``, for checkouts of the
  port in turns, and the pass kernel's variants (ring, stages, hint, store,
  walk) beside the first design.

Each entry point takes an explicit ``device`` (default: the card; it raises
if there is none), makes its data from an explicit seed with numpy, times
with CUDA events, and returns its outputs with a small dict of times.
"""

from __future__ import annotations

import statistics

import torch


def time_ms(fn, *, setup=None, reps: int = 5, warmup: bool = True) -> float:
    """Median time of ``fn(*setup())`` in ms over ``reps`` calls after a
    warm-up, from CUDA events around ``fn`` alone: ``setup`` (fresh inputs
    for a function that works in place) runs outside the timed window."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs the card: CUDA events, no host clock")

    def args():
        return () if setup is None else setup()

    if warmup:
        fn(*args())
    times = []
    for _ in range(reps):
        a = args()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)
