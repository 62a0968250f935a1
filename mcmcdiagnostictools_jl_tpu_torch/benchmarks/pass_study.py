"""K7 and K8 (``kernels.sort_study.pass_strided`` / ``pass_contig``): one
pass of a sort's traffic, timed in turns with ``add_``, for checkouts of the
port and for variants of the kernel.

On 512 tiles of 2048 rows x 128 columns (1,048,576 x 128 float32 keys and
int32 payload, 1.07 GB; ``sort_microbench.make_arrays``) every geometry of
``GEOMETRIES`` runs in place beside ``k.add_(1.0); p.add_(1)``, the same
function as one PyTorch call, and the plain version ``keys + 1, payload +
1``, in turns: one warm-up round, then the median of ``ROUNDS`` rounds, each
call timed alone with CUDA events. A call's events are queued behind ~1 ms
of ``torch.cuda._sleep``, so that the host's work before a launch (a
wrapper's checks and plan, PyTorch's dispatch) runs while the card is busy:
the time is the card's alone. Without it, that host work counts as long as
the card waits for the launch.

``python -m mcmcdiagnostictools_jl_tpu_torch.benchmarks.pass_study ROOT
...`` runs one child process a checkout root, in the order given (so ``a b
b a`` compares two versions in turns); each child imports the package from
its root and prints one JSON line of medians. It uses only
``sort_microbench.make_arrays`` and the two wrappers, so any checkout since
the kernels were written can be timed.

``... pass_study ablate [ROOT]`` times, in this checkout, the kernel with
one setting of its plan changed at a time (ring depth, stage size, blocks a
multiprocessor, segment rows) and builds with parts added or changed (an
L2 evict-first hint on every copy: ``-DMDT_PASS_EVICT_FIRST``; 16-byte
stores from registers in place of the bulk store: ``-DMDT_PASS_STG``;
stores left reading before a slot is freed: ``-DMDT_PASS_STORE_DEPTH``;
block ``b`` taking the tasks ``b, b + grid, ...`` in place of the counter:
``-DMDT_PASS_STATIC_WALK``), each held equal to ``keys + 1``, all in one
rotation with ``add_``; with ROOT, a checkout from before the ring, also
that checkout's pass kernels (the first design: one block a task, 16-byte
``cp.async`` copies), built alone from its ``csrc/sort_study.cu``.

``... pass_study offsets ROOT`` times this checkout's kernels, ROOT's first
design and ``add_`` with the payload placed at offsets of 0 B to 34 MB past
the end of the keys in one buffer: how much the two arrays' relative place
in memory moves each.

``... pass_study sass`` prints the pass kernels' bulk-copy and ``LDGSTS``
counts from ``cuobjdump -sass`` of the built library (needs ``nvcc``, not
the card).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import QUEUE_CYCLES, interleaved_ms

NTILES = 512
LANES = 128
SEED = 20261016
ROUNDS = 15
# (kernel, pods, stride): K7's three settings and K8's two, as the JAX-era
# study's `__main__` runs them (K8: stride None)
GEOMETRIES = (("K7", 16, 1), ("K7", 16, 16), ("K7", 8, 64), ("K8", 16, None),
              ("K8", 4, None))


def label(kid: str, pods: int, stride: int | None) -> str:
    return (f"{kid} pods {pods}" if stride is None
            else f"{kid} pods {pods} stride {stride}")


def library_calls(keys, payload) -> dict:
    """``add_`` on ``keys`` and ``payload`` in place (the same function as
    one PyTorch call) and the plain version, as callables."""
    def add_():
        keys.add_(1.0)
        payload.add_(1)

    return {"add_": add_, "plain": lambda: (keys + 1.0, payload + 1)}


def pass_calls(keys, payload) -> dict:
    """``{label: callable}`` of every geometry of ``GEOMETRIES`` through the
    wrappers on ``keys``, ``payload`` in place, then ``library_calls``."""
    from ..kernels import sort_study

    def run(pods, stride):
        if stride is None:
            sort_study.pass_contig(keys, payload, pods)
        else:
            sort_study.pass_strided(keys, payload, pods, stride)

    calls = {label(*g): (lambda g=g: run(g[1], g[2])) for g in GEOMETRIES}
    return {**calls, **library_calls(keys, payload)}


_CHILD = r"""
import json, statistics, sys
root, seed, ntiles, rounds = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
geometries, queue_cycles = json.loads(sys.argv[5]), int(sys.argv[6])
sys.path.insert(0, root)
import torch
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.benchmarks import sort_microbench as sm
from mcmcdiagnostictools_jl_tpu_torch.kernels import sort_study as ss
keys, payload = sm.make_arrays(ntiles, seed)
k, p = keys.clone(), payload.clone()
calls = {}
for kid, pods, stride in geometries:
    if stride is None:
        calls[f"{kid} pods {pods}"] = lambda pods=pods: ss.pass_contig(k, p, pods)
    else:
        calls[f"{kid} pods {pods} stride {stride}"] = (
            lambda pods=pods, stride=stride: ss.pass_strided(k, p, pods, stride))
def add_():
    k.add_(1.0)
    p.add_(1)
calls["add_"] = add_
calls["plain"] = lambda: (keys + 1.0, payload + 1)
times = {name: [] for name in calls}
for r in range(rounds + 1):
    for name, fn in calls.items():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(queue_cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if r:
            times[name].append(e0.elapsed_time(e1))
same = {}
for kid, pods, stride in geometries:
    a, b = keys.clone(), payload.clone()
    if stride is None:
        ss.pass_contig(a, b, pods)
    else:
        ss.pass_strided(a, b, pods, stride)
    same[kid + f" {pods} {stride}"] = bool(torch.equal(a, keys + 1)
                                           and torch.equal(b, payload + 1))
print(json.dumps({"root": root, "package": mtt.__file__,
                  "ms": {n: statistics.median(t) for n, t in times.items()},
                  "equal_to_plain": same}))
"""


def compare(roots, seed: int = SEED, ntiles: int = NTILES,
            rounds: int = ROUNDS) -> list:
    """One child process a checkout root, in the order given; their
    results (medians in ms, and whether each geometry equals ``keys +
    1``)."""
    out = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, root, str(seed), str(ntiles),
             str(rounds), json.dumps(GEOMETRIES), str(QUEUE_CYCLES)],
            capture_output=True, text=True, check=True)
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(out[-1]), flush=True)
    return out


# The variants of ``ablate``: a name, the macros of the build, and the
# settings of ``pass_plan`` that differ from its defaults
VARIANTS = (
    ("as planned", (), {}),
    ("2 stages", (), {"stages": 2}),
    ("4 stages", (), {"stages": 4}),
    ("stages of 8 KB", (), {"stage_bytes": 8 * 1024}),
    ("stages of 16 KB", (), {"stage_bytes": 16 * 1024}),
    ("stages of 64 KB", (), {"stage_bytes": 64 * 1024}),
    ("2 blocks an SM", (), {"blocks_per_sm": 2}),
    ("segments of 8 rows", (), {"seg_rows": 8}),
    ("segments of 32 rows", (), {"seg_rows": 32}),
    ("L2 evict-first hint", ("MDT_PASS_EVICT_FIRST",), {}),
    ("STG.128 stores", ("MDT_PASS_STG",), {}),
    ("no store left reading", ("MDT_PASS_STORE_DEPTH=0",), {}),
    ("3 stores left reading", ("MDT_PASS_STORE_DEPTH=3",), {}),
    ("block b takes b, b + grid, ...", ("MDT_PASS_STATIC_WALK",), {}),
)


def first_design_library(root) -> ctypes.CDLL:
    """The pass kernels of the checkout at ``root`` from before the ring
    (entry points ``mdt_sort_pass_strided`` / ``mdt_sort_pass_contig``):
    its ``csrc/sort_study.cu`` built alone, with this checkout's flags, into
    this checkout's build directory."""
    from ..kernels import _build

    src = Path(root) / "mcmcdiagnostictools_jl_tpu_torch" / "csrc" / "sort_study.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"first_design_{digest}" / "libsort_study.so"
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib), str(src)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out.mdt_sort_pass_strided.argtypes = [p, p, ll, i, i, i, i, i, p]
    out.mdt_sort_pass_contig.argtypes = [p, p, ll, i, i, i, p]
    return out


def first_design_run(lib):
    """``run(k, p, pods, stride)``: one launch of the first design's pass
    kernel of ``lib``, with its default segment rows."""
    from ..kernels import _build, sort_study

    def run(k, p, pods, stride):
        nrows, ncols = k.shape
        seg = sort_study.default_seg_rows(pods, ncols)
        stream = torch.cuda.current_stream().cuda_stream
        if stride is None:
            code = lib.mdt_sort_pass_contig(k.data_ptr(), p.data_ptr(), nrows,
                                            ncols, pods, seg, stream)
        else:
            code = lib.mdt_sort_pass_strided(
                k.data_ptr(), p.data_ptr(), nrows, ncols, sort_study.TILE,
                pods, stride, seg, stream)
        _build.check(code, "first design pass")

    return run


def ablate(first_design_root=None, seed: int = SEED, ntiles: int = NTILES,
           rounds: int = ROUNDS) -> dict:
    """Every variant of ``VARIANTS`` at every geometry, all in turns with
    ``add_`` and the plain version in one rotation (with
    ``first_design_root``, also that checkout's pass kernels): ``{variant:
    {geometry: ms}, "add_": ms, "plain": ms}``; raises if a variant's result
    differs from ``keys + 1``."""
    from ..kernels import _build, sort_study
    from .sort_microbench import make_arrays

    keys, payload = make_arrays(ntiles, seed)
    want = (keys + 1.0, payload + 1)
    k, p = keys.clone(), payload.clone()
    calls, plans = {}, {}
    for name, defines, settings in VARIANTS:
        lib = _build.library(defines)
        for kid, pods, stride in GEOMETRIES:
            plan = sort_study.card_pass_plan(
                lib, keys, pods, stride or 1, contiguous=stride is None,
                **settings)
            a, b = keys.clone(), payload.clone()
            sort_study.run_pass(lib, plan, a, b)
            if not (torch.equal(a, want[0]) and torch.equal(b, want[1])):
                raise AssertionError(f"{name}, {label(kid, pods, stride)}: "
                                     "differs from keys + 1")
            key = f"{name} | {label(kid, pods, stride)}"
            plans[key] = {x: plan[x] for x in ("seg_rows", "stage_bytes",
                                                "stages", "grid",
                                                "blocks_per_sm")}
            calls[key] = (lambda lib=lib, plan=plan:
                          sort_study.run_pass(lib, plan, k, p))
    if first_design_root is not None:
        run = first_design_run(first_design_library(first_design_root))
        for kid, pods, stride in GEOMETRIES:
            a, b = keys.clone(), payload.clone()
            run(a, b, pods, stride)
            if not (torch.equal(a, want[0]) and torch.equal(b, want[1])):
                raise AssertionError(f"first design, {label(kid, pods, stride)}"
                                     ": differs from keys + 1")
            key = f"first design | {label(kid, pods, stride)}"
            plans[key] = {"seg_rows": sort_study.default_seg_rows(pods, LANES)}
            calls[key] = (lambda pods=pods, stride=stride:
                          run(k, p, pods, stride))
    del want, a, b
    calls.update(library_calls(k, p))
    ms = interleaved_ms(calls, rounds)
    out = {"add_": ms["add_"], "plain": ms["plain"]}
    for key, plan in plans.items():
        name, geometry = key.split(" | ")
        out.setdefault(name, {})[geometry] = ms[key]
        print(f"{name:32s} {geometry:22s} {ms[key]:.4f} ms "
              f"({ms[key] / ms['add_']:.3f} x add_) {plan}")
    print(f"add_ {ms['add_']:.4f} ms, plain {ms['plain']:.4f} ms")
    return out


OFFSETS = (0, 256, 4096, 65536, 1 << 20, 2 << 20, (2 << 20) + 256,
           (3 << 20) + 4096, (34 << 20) + 256)


def offsets(first_design_root, seed: int = SEED, ntiles: int = NTILES,
            rounds: int = ROUNDS) -> dict:
    """For each byte offset of ``OFFSETS``: the keys at the start of one
    buffer and the payload that many bytes after their end; every geometry
    of this checkout's wrappers and of ``first_design_root``'s first design,
    and ``add_``, in turns: ``{offset: {name: ms}}``."""
    from .sort_microbench import make_arrays

    keys, payload = make_arrays(ntiles, seed)
    nbytes = keys.numel() * 4
    run = first_design_run(first_design_library(first_design_root))
    out = {}
    for off in OFFSETS:
        buf = torch.empty(2 * nbytes + off, dtype=torch.uint8, device="cuda")
        k = buf[:nbytes].view(torch.float32).view(keys.shape)
        p = buf[nbytes + off:].view(torch.int32).view(keys.shape)
        k.copy_(keys)
        p.copy_(payload)
        calls = {f"this {name}": fn for name, fn in pass_calls(k, p).items()
                 if name != "plain"}
        calls.update({f"first {label(*g)}": (lambda g=g: run(k, p, g[1], g[2]))
                      for g in GEOMETRIES})
        out[off] = interleaved_ms(calls, rounds)
        print(f"offset {off}: " + ", ".join(
            f"{name} {t:.4f}" for name, t in out[off].items()), flush=True)
        del buf, k, p
    return out


def pass_sass(defines: tuple = ()) -> dict:
    """For each pass kernel of the built library: its bulk-copy and TMA
    opcodes (``UBLK*``, ``UTMA*``) with their counts, and its ``LDGSTS``
    count, from ``cuobjdump -sass`` (the reading of ``sass_mix``)."""
    from ..kernels import _build
    from .sass_mix import kernel_mix

    lib, _ = _build.build(defines)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for name, mix in kernel_mix(sass, "pass_kernel").items():
        ops = mix["opcodes"]
        out[name] = {"bulk": {op: n for op, n in sorted(ops.items())
                              if op.startswith(("UBLK", "UTMA"))},
                     "LDGSTS": ops["LDGSTS"]}
    return out


def main(argv) -> None:
    if argv[:1] == ["ablate"]:
        print(json.dumps(ablate(*argv[1:2])))
    elif argv[:1] == ["offsets"]:
        print(json.dumps(offsets(argv[1])))
    elif argv[:1] == ["sass"]:
        print(json.dumps(pass_sass()))
    elif argv:
        compare(argv)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
