"""Where the device time of the port's flagship calls goes.

One warm call of each of a few public functions on the flagship sample (10k
draws x 128 chains x 256 params, float32 AR(1), made from a seed, an eighth
of the chains of parameter 0 shifted by 4 so that one parameter mixes badly
and the adaptive Geyer probe has to ask for all 250 lags; ``make_sample``,
which ``chip_smoke.py`` calls too, with its own seed) under
``torch.profiler``: the wall, the device time (the sum over kernels, memsets
and copies), the card's idle share (1 - union of device intervals / wall)
and the device kernels that take most, by name.

Run on a machine with the card: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.profile_calls [top]``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..backend import resolve_device

DRAWS, CHAINS, PARAMS = 10_000, 128, 256


def make_sample(seed: int = 0, shape=(DRAWS, CHAINS, PARAMS), phi: float = 0.5,
                device=None) -> torch.Tensor:
    """float32 AR(1) chains along axis 0 from ``seed``, on the device; an
    eighth of the chains of parameter 0 sit 4 off."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    for t in range(1, shape[0]):
        x[t] += np.float32(phi) * x[t - 1]
    x[:, : max(shape[1] // 8, 1), 0] += 4.0
    return torch.from_numpy(x).to(resolve_device(device))


def profile_call(fn, top: int = 8) -> dict:
    """One warm call of ``fn`` under the profiler: ``{"wall_ms", "device_ms",
    "idle", "launches", "kernels": [(name, ms, calls), ...]}``, the kernels
    by device time, largest first; ``launches`` counts the device's
    kernels, memsets and copies."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        start = e.time_range.start
        spans.append((start, start + e.device_time))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time / 1e3, calls + 1)
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])
    return {"wall_ms": wall_ms,
            "device_ms": sum(ms for _, ms, _ in kernels),
            "idle": 1.0 - busy / 1e3 / wall_ms, "launches": len(spans),
            "kernels": kernels[:top]}


def calls(x: torch.Tensor) -> dict:
    """The profiled calls on sample ``x``, by name."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from ..ops import fastrank

    def fused():
        old, fastrank.FUSE_BLOM_Z = fastrank.FUSE_BLOM_Z, True
        try:
            return mtt.ess_rhat(x, kind="rank", rank_mode="fast")
        finally:
            fastrank.FUSE_BLOM_Z = old

    return {
        "ess_rhat fast": lambda: mtt.ess_rhat(x, kind="rank", rank_mode="fast"),
        "ess_rhat fast, FUSE_BLOM_Z": fused,
        "ess_rhat exact": lambda: mtt.ess_rhat(x, kind="rank"),
        "ess_rhat exact, fold_impl=sort": lambda: mtt.ess_rhat(
            x, kind="rank", fold_impl="sort"),
        "mcse mean, K5 marker": lambda: mtt.mcse(
            x, kind="mean", autocov_method=mtt.DirectKernelAutocovMethod()),
        "gewekediag": lambda: mtt.gewekediag(x),
        "heideldiag": lambda: mtt.heideldiag(x),
    }


def main(top: int = 8, seed: int = 0, device=None) -> dict:
    x = make_sample(seed, device=device)
    out = {}
    for name, fn in calls(x).items():
        out[name] = r = profile_call(fn, top)
        print(f"{name}: wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms, idle {r['idle']:.1%}", flush=True)
        for kernel, ms, n in r["kernels"]:
            print(f"  {ms:8.3f} ms x{n:<3d} {kernel[:100]}")
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
