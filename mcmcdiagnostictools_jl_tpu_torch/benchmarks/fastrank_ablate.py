"""What holds K3 (``hist_moments`` / ``hist_cdf_tables``) and K4
(``rank_lookup``): timings of the kernels with parts taken out or constants
changed, of plain copies in the kernels' access pattern, and the SASS of
their atomics.

Each variant is a build of the kernels with macros of ``csrc/fastrank.cu``
defined (``_build.library(defines)``), beside the package's own library, run
through the package's wrappers; where a variant takes a part out its results
are wrong and only its time is read. The sample is the flagship one
(``profile_calls.make_sample``: 10k draws x 128 chains x 256 params,
float32) flattened to (1.28M, 256), 4096 bins.

Run on a machine with the card: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.fastrank_ablate
[hist|lookup|design|grain|sass|all]``.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import fastrank as kfr
from ..ops import fastrank as ofr
from . import time_ms
from .profile_calls import make_sample

NBINS = 4096

HIST_ABLATIONS = {
    "whole": (),
    "(a) the shared atomics -> a plain store": ("MDT_HIST_PLAIN_STORES",),
    "(b) one 64-bit atomicAdd (a CAS loop)": ("MDT_HIST_CAS64",),
    "(c) bin = row % nbins (no conflicts)": ("MDT_HIST_ROW_BINS",),
    "(e) loads only": ("MDT_HIST_LOADS_ONLY",),
}
LOOKUP_ABLATIONS = {
    "whole": (),
    "(a) every lookup reads bin 0": ("MDT_LOOKUP_BIN0",),
    "(b) no lookup": ("MDT_LOOKUP_NO_GATHER",),
    "(d) no arithmetic: the sample copied": ("MDT_LOOKUP_COPY",),
}
# K4's wide kernel: its threads and the rows a thread keeps in flight (K3's
# too, of its 1024 threads); "gather" is no macro but hides the wide kernel
# from the wrapper's choice (the first design: one element a thread, the
# tables through the L2)
DESIGNS = {
    "the package's (wide: 1024 threads, 2 rows in flight; K3: 2)": (),
    "wide: 1024 threads, 4 rows; K3: 4": ("MDT_WIDE_INFLIGHT=4",
                                          "MDT_FR_INFLIGHT=4"),
    "wide: 1024 threads, 1 row; K3: 1": ("MDT_WIDE_INFLIGHT=1",
                                         "MDT_FR_INFLIGHT=1"),
    "wide: 512 threads, 4 rows": ("MDT_WIDE_THREADS=512",
                                  "MDT_WIDE_INFLIGHT=4"),
    "loads through the L1 (ld.global.nc)": ("MDT_STREAM_LDG",),
    "gather": ("gather",),
}


@contextlib.contextmanager
def variant(defines: tuple):
    """The package's wrappers on the library built with the macros
    ``defines``; ``"gather"`` among them is no macro but hides the wide
    kernel from K4's wrapper."""
    lib = _build.library(tuple(d for d in defines if d != "gather"))
    real_library, real_plan = _build.library, kfr.wide_plan
    _build.library = lambda: lib
    if "gather" in defines:
        kfr.wide_plan = lambda *args: None
    try:
        yield
    finally:
        _build.library, kfr.wide_plan = real_library, real_plan


def _inputs(seed: int = 0, device=None):
    x3 = make_sample(seed, device=device)
    xf = x3.reshape(-1, x3.shape[2])
    lo, hi, _ = kfr.column_minmax(xf)
    scale = ofr._hist_scale(lo, hi, NBINS)
    _, _, tab = kfr.hist_cdf_tables(xf, lo, scale, NBINS)
    return xf, lo, scale, tab


def _time(variants: dict, runs: dict, reps: int) -> dict:
    out = {}
    for name, defines in variants.items():
        with variant(defines):
            out[name] = {k: time_ms(fn, reps=reps) for k, fn in runs.items()}
        print(f"{name}: " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in out[name].items()),
              flush=True)
    return out


def ablate_hist(seed: int = 0, device=None, reps: int = 5) -> dict:
    xf, lo, scale, _ = _inputs(seed, device)
    return _time(HIST_ABLATIONS, {
        "K3 (both passes)": lambda: kfr.hist_cdf_tables(xf, lo, scale, NBINS),
    }, reps)


def ablate_lookup(seed: int = 0, device=None, reps: int = 5) -> dict:
    xf, lo, scale, tab = _inputs(seed, device)
    return _time(LOOKUP_ABLATIONS, {
        "K4": lambda: kfr.rank_lookup(xf, lo, scale, tab, NBINS),
    }, reps)


def compare_designs(seed: int = 0, device=None, reps: int = 5) -> dict:
    xf, lo, scale, tab = _inputs(seed, device)
    n = xf.shape[0]
    return _time(DESIGNS, {
        "K3": lambda: kfr.hist_cdf_tables(xf, lo, scale, NBINS),
        "K4": lambda: kfr.rank_lookup(xf, lo, scale, tab, NBINS),
        "K4 z": lambda: kfr.rank_lookup(xf, lo, scale, tab, NBINS, blom_n=n),
    }, reps)


def slab_grain(seed: int = 0, device=None, reps: int = 5) -> dict:
    """What device memory gives blocks that own a few columns of every row:
    ms to read, write and copy the sample in slabs of 4 to 64 columns (16 to
    256 bytes of a row a block), at the shared memory K3's blocks hold (128
    KB), what K4's wide kernel holds (229,632 bytes: the L1 shrinks to what
    is left of 256 KB) and none; one block of 1024 threads a multiprocessor
    at a time, about 8 blocks each over the launch
    (``csrc/fastrank.cu: slab_copy_kernel``)."""
    xf = make_sample(seed, device=device).reshape(-1, 256)
    n, p = xf.shape
    out, sink = torch.empty_like(xf), torch.zeros(1, device=xf.device)
    lib = _build.library()
    sms = torch.cuda.get_device_properties(xf.device).multi_processor_count
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    times = {}
    for smem in (131072, 229632, 0):
        for cols in (4, 8, 16, 32, 64):
            nchunks = max(1, 8 * sms // (p // cols))

            def run(mode):
                _build.check(lib.mdt_slab_copy(
                    xf.data_ptr(), out.data_ptr(), n, p, cols, mode, smem,
                    nchunks, sink.data_ptr(), stream), "mdt_slab_copy")

            times[smem, cols] = t = tuple(
                time_ms(lambda: run(mode), reps=reps) for mode in range(3))
            print(f"shared memory {smem:6d} B, {cols:2d} columns ({4 * cols:3d} "
                  f"B of a row) a block: read {t[0]:.3f} ms, write {t[1]:.3f} "
                  f"ms, copy {t[2]:.3f} ms", flush=True)
    return times


def atomics_sass(text: str = "hist") -> list:
    """The atomic instructions (``ATOM*``, ``RED*``, ``*CAS*``) of the built
    library's kernels whose name contains ``text``, from ``cuobjdump -sass``."""
    lib, _ = _build.build()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    found = []
    for block in sass.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        if text not in name:
            continue
        lines = [ln.split("*/", 1)[1].split(";")[0].strip()
                 for ln in body.splitlines()
                 if any(k in ln for k in ("ATOM", "RED.", "CAS"))]
        print(f"{name.strip()[:100]}: {len(lines)} atomic instructions")
        for ln in sorted(set(lines)):
            print(f"    {lines.count(ln)} x {ln}")
        found.append((name.strip(), lines))
    return found


def main(which: str = "all") -> None:
    if which in ("all", "sass"):
        atomics_sass()
    if which in ("all", "hist"):
        ablate_hist()
    if which in ("all", "lookup"):
        ablate_lookup()
    if which in ("all", "design"):
        compare_designs()
    if which in ("all", "grain"):
        slab_grain()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
