"""Seconds of each phase of ``chip_smoke.py`` for checkouts of the port, in
turns on one card.

Each root runs in a fresh process that changes into it, imports its
``chip_smoke.py``, wraps every ``phase_*`` function with a clock and calls
``main()``; it prints one JSON line: the root, the script's exit code, the
seconds of each phase (summed over calls) and the total. The roots run in
the order given, so ``a b`` or ``a b b a`` compares the smoke runs of two
commits on one card (a smoke run's length varies between machines by tens
of seconds, mostly in the host-bound phases 12 and 14).

Run on a machine with the card, e.g. with the parent commit unpacked by
``git archive`` into a git-ignored directory: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.smoke_phases parent/ .``.
"""

from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r"""
import functools, json, os, sys, time
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import chip_smoke
times = {}
for name in dir(chip_smoke):
    if name.startswith("phase_"):
        def wrap(fn, name=name):
            @functools.wraps(fn)
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    times[name] = (times.get(name, 0.0)
                                   + time.perf_counter() - t0)
            return timed
        setattr(chip_smoke, name, wrap(getattr(chip_smoke, name)))
t0 = time.perf_counter()
try:
    rc = chip_smoke.main()
except Exception as exc:  # the smoke run failed: report its phases so far
    print(f"chip_smoke failed: {exc!r}", file=sys.stderr)
    rc = 1
times["total"] = time.perf_counter() - t0
print("PHASE_TIMES " + json.dumps({"root": root, "rc": rc, "s": times}))
"""


def main(roots) -> list:
    """One child process per root, in the order given; their results."""
    out = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root],
                              capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("PHASE_TIMES ")]
        if not line:
            raise RuntimeError(f"{root}: no phase times\n{proc.stderr[-4000:]}")
        out.append(json.loads(line[-1][len("PHASE_TIMES "):]))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
