"""Microbenchmark: two formulations of the lag loop (kernel K6).

The counterpart of the JAX-era ``benchmarks/micro_lagloop.py``. The direct
autocovariance kernels K1 and K5 spend their time in the lag products.
Measured here, on the same input:

A. the first form of their loop (``variant="a"``): one shared-memory load
   per FMA, tiles staged between two barriers;
B. the loop they run (``variant="b"``): a warp owns consecutive lags and
   keeps the sliding window of the shifted factor in registers, and every
   draw is staged once, ahead of use.

Run on a machine with the card: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.micro_lagloop``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from ..kernels import lagloop_study
from . import time_ms

NITER, MAXLAG = 5000, 250
SERIES = 256 * 64  # one parameter chunk of 64 after the split of 128 chains
LABELS = {"a": "A one shared-memory load per FMA (the first form)",
          "b": "B consecutive lags, window in registers (the loop of K1/K5)"}


def make_input(seed: int = 0, niter: int = NITER, series: int = SERIES,
               device=None) -> torch.Tensor:
    """Standard normal ``(niter, series)`` float32 from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((niter, series), dtype=np.float32)
    return torch.from_numpy(x).to(resolve_device(device))


def run(variant: str, x: torch.Tensor, maxlag: int = MAXLAG, reps: int = 5):
    """The lag products of ``x`` with the loop ``variant``: ``(out,
    {"ms": median of reps after a warm-up})``."""
    out = lagloop_study.lag_products(x, maxlag, variant)  # the warm-up too
    ms = time_ms(lambda: lagloop_study.lag_products(x, maxlag, variant),
                 reps=reps, warmup=False)
    return out, {"ms": ms}


def main(seed: int = 0, device=None) -> dict:
    x = make_input(seed, device=device)
    outs = {}
    for variant in lagloop_study.VARIANTS:
        outs[variant], times = run(variant, x)
        print(f"{LABELS[variant]}: {times['ms']:.3f} ms", flush=True)
    # float32 sums in another order: relative to the lag-0 sum
    err = float((outs["a"] - outs["b"]).abs().max() / outs["a"][0].max())
    print(f"A == B: max abs diff / largest c_0 = {err:.2e}", flush=True)
    return outs


if __name__ == "__main__":
    main()
