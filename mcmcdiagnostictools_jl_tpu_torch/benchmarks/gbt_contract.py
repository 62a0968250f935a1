"""The GBT's row contractions at BASELINE.md config 5's shapes: one
``a.T @ b`` against the rows cut into blocks, multiplied by ``torch.bmm``
and summed.

``models/gbt.py`` builds each level's histograms, and each round's leaf
sums, as ``a.T @ b`` with ``a`` a float32 one-hot (n, C) and ``b`` the
stacked gradients and hessians (n, 2 kc). At config 5 (100 draws x 10,000
chains x 4 params, ``GBTClassifier(n_rounds=20, n_bins=32,
class_chunk=256)``) the class-chunked fit has n = 700,000 training rows,
2 kc = 512 columns of ``b``, one-hot chunks of 64 and 128 columns (the
256 MB feature chunks of 1, 2 and 4 nodes x 32 bins) and 8 leaves.

Run on the card: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.gbt_contract``. It prints one
line a shape and form (median of 5 CUDA-event times, the max abs difference
from the single product, the float32 bound) and a JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import time_ms

N_ROWS = 700_000
B_COLS = 512
# (name, one-hot columns): the histogram chunks of config 5 and the leaves
SHAPES = (("hist, 2 features x 1 node x 32 bins", 64),
          ("hist, 1 feature x 4 nodes x 32 bins", 128),
          ("leaf sums, 8 leaves", 8))
BLOCKS = (4096, 16384, 65536)
F32_FLOPS = 66.9e12  # H100 SXM, outside the tensor cores


def single(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.T @ b


def blocked(a: torch.Tensor, b: torch.Tensor, rows: int) -> torch.Tensor:
    """``a.T @ b`` as whole blocks of ``rows`` rows through one batched
    product and a sum over blocks, the rest through one more product."""
    n = a.shape[0]
    nb = n // rows
    main = nb * rows
    out = torch.bmm(a[:main].reshape(nb, rows, -1).transpose(1, 2),
                    b[:main].reshape(nb, rows, -1)).sum(0)
    if main < n:
        out += a[main:].T @ b[main:]
    return out


def run(seed: int = 5, device=None) -> dict:
    from ..backend import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal((N_ROWS, B_COLS),
                                             dtype=np.float32)).to(device)
    out = {}
    for name, cols in SHAPES:
        idx = torch.from_numpy(rng.integers(0, cols, N_ROWS)).to(device)
        a = torch.zeros((N_ROWS, cols), dtype=torch.float32, device=device)
        a.scatter_(1, idx[:, None], 1.0)
        want = single(a, b)
        bound = 2.0 * N_ROWS * cols * B_COLS / F32_FLOPS * 1e3
        row = {"single_ms": time_ms(lambda: single(a, b)), "bound_ms": bound}
        print(f"[{name}] ({N_ROWS}, {cols}).T @ ({N_ROWS}, {B_COLS}): single "
              f"{row['single_ms']:.3f} ms (bound {bound:.3f} ms)")
        for rows in BLOCKS:
            ms = time_ms(lambda: blocked(a, b, rows))
            err = float((blocked(a, b, rows) - want).abs().max())
            row[f"blocked_{rows}_ms"] = ms
            row[f"blocked_{rows}_max_abs_diff"] = err
            print(f"[{name}] blocks of {rows} rows: {ms:.3f} ms, max abs "
                  f"difference from the single product {err:.3e}")
        out[name] = row
    return out


if __name__ == "__main__":
    print(json.dumps(run()))
