"""Where the card's sort puts a NaN with the sign bit set, and whether the
exact calls of checkouts of the port poison its column.

Each run is a fresh process that imports ``mcmcdiagnostictools_jl_tpu_torch``
from one checkout root (as ``ab_walls`` does) and makes (2000, 16, 6) AR(1)
draws from a seed, with column 1 all ``-nan`` (``0xffc00000`` in float32)
and one ``-nan`` among the numbers of column 3. For float32 and float64 on
the card it prints one JSON line: whether the first and the last entry of
each of those columns' sorted rows is NaN (``torch.sort`` along the 32,000
draws x chains, where the card sorts by radix), and the values of columns 1
and 3 from the exact ``ess_rhat`` with each ``fold_impl``, ``ess`` of the
median and mad kinds, ``mcse`` of ``Quantile(0.25)`` and
``ess_rhat_streaming`` in exact mode. Both columns must come out NaN.

Run on a machine with the card, e.g. with the parent commit unpacked by
``git archive`` into a git-ignored directory: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.nan_probe parent/ .``.
"""

from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
import mcmcdiagnostictools_jl_tpu_torch as mtt

rng = np.random.default_rng(int(sys.argv[2]))
x = rng.standard_normal((2000, 16, 6))
for t in range(1, 2000):
    x[t] += 0.5 * x[t - 1]
x[:, :, 1] = -np.nan
x[777, 5, 3] = -np.nan
for dtype in (torch.float32, torch.float64):
    xt = torch.from_numpy(x).to(dtype).cuda()
    xs = torch.sort(xt.reshape(-1, 6).t().contiguous(), dim=1).values
    calls = {
        "ess_rhat sort": lambda v: mtt.ess_rhat(v, fold_impl="sort"),
        "ess_rhat merge": lambda v: mtt.ess_rhat(v, fold_impl="merge"),
        "ess median": lambda v: mtt.ess(v, kind="median"),
        "ess mad": lambda v: mtt.ess(v, kind="mad"),
        "mcse q25": lambda v: mtt.mcse(v, kind=mtt.Quantile(0.25)),
        "streaming exact": lambda v: mtt.ess_rhat_streaming(
            v.cpu().numpy(), rank_mode="exact", param_chunk=4, dtype=dtype),
    }
    out = {"root": root, "package": mtt.__file__, "dtype": str(dtype),
           "nan_first_last": {c: [bool(torch.isnan(xs[c, 0])),
                                  bool(torch.isnan(xs[c, -1]))]
                              for c in (1, 3)}}
    for name, fn in calls.items():
        res = fn(xt)
        res = res if isinstance(res, tuple) else (res,)
        out[name] = [[float(v) for v in r.cpu()[[1, 3]]] for r in res]
    print(json.dumps(out), flush=True)
"""


def main(roots, seed: int = 41) -> None:
    """One child process per root, in the order given."""
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, str(seed)],
                              capture_output=True, text=True, check=True)
        print(proc.stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
