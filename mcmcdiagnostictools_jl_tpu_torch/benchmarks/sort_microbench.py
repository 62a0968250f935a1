"""Microbenchmarks of a hand-written column sort (kernels K7, K8, K9).

The counterpart of the JAX-era ``benchmarks/sort_microbench.py``. On ``(N,
128)`` float32 keys with an int32 payload, N = ``ntiles`` tiles of 2048 rows:

1. ``bench_sort``: the library sort (``torch.sort`` along dim 0 and a gather
   of the payload), a yardstick only;
2. ``bench_dma_pass`` / ``bench_dma_contig``: one pass of every element
   through shared memory and back, in strided pods (K7) or contiguous runs
   (K8): the traffic floor of one merge pass;
3. ``bench_phase_a``: the bitonic sort of every pod of ``pod_tiles`` tiles
   (K9), checked against ``np.sort`` on the first two pods.

``profile_phase_a`` splits one K9 call and one library sort into their
device kernels with ``torch.profiler``; ``ablate_chunk_launch`` times K9's
chunk launches with their steps, their re-deals or both taken out, to show
which part of a launch costs what.

The kernels work in place, so every timed call gets fresh clones, made
outside the timed window. Run on a machine with the card: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.sort_microbench [all|sort|dma|
contig|phasea|profile|ablate]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..backend import resolve_device
from ..kernels import sort_study
from . import time_ms

LANES = 128
TILE = sort_study.TILE


def make_arrays(ntiles: int, seed: int = 0, lanes: int = LANES, device=None,
                tile_rows: int = TILE):
    """Uniform float32 keys ``(ntiles * tile_rows, lanes)`` from ``seed`` and
    the payload ``arange`` of the same shape (int32), on the device."""
    n = ntiles * tile_rows
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    keys = torch.from_numpy(rng.random((n, lanes), dtype=np.float32)).to(device)
    payload = torch.arange(n * lanes, dtype=torch.int32,
                           device=device).reshape(n, lanes)
    return keys, payload


def _bench_in_place(fn, keys, payload, reps):
    """``fn`` on fresh clones: the outputs of one call and the median time."""
    def fresh():
        return keys.clone(), payload.clone()

    out = fn(*fresh())  # the warm-up too
    return out, time_ms(fn, setup=fresh, reps=reps, warmup=False)


def _gbps(keys, ms):
    """Effective rate of one pass: both arrays read once and written once."""
    return 2 * keys.numel() * 8 / 1e9 / (ms / 1e3)


def bench_sort(ntiles: int, pod_tiles: int | None = None, *, seed: int = 0,
               lanes: int = LANES, device=None, reps: int = 5):
    """The library sort: ``torch.sort`` along dim 0 (of every pod of
    ``pod_tiles`` tiles, if given, all ascending; else of whole columns) and
    the payload gathered with its indices. ``((keys, payload), {"ms"})``."""
    keys, payload = make_arrays(ntiles, seed, lanes, device)
    pod_rows = keys.shape[0] if pod_tiles is None else pod_tiles * TILE

    def sort(k, p):
        ks, idx = torch.sort(k.reshape(-1, pod_rows, lanes), dim=1)
        ps = torch.gather(p.reshape(-1, pod_rows, lanes), 1, idx)
        return ks.reshape(k.shape), ps.reshape(p.shape)

    out = sort(keys, payload)
    ms = time_ms(lambda: sort(keys, payload), reps=reps, warmup=False)
    print(f"torch_sort  (N={keys.shape[0]}, L={lanes}, pods of {pod_rows}): "
          f"{ms:8.2f} ms   data={keys.numel() * 8 / 1e9:.2f} GB")
    return out, {"ms": ms}


def bench_dma_pass(ntiles: int, pod_tiles: int, stride_tiles: int, *,
                   seed: int = 0, lanes: int = LANES, device=None,
                   reps: int = 5):
    """K7 over fresh arrays: ``((keys + 1, payload + 1), {"ms", "gbps"})``."""
    keys, payload = make_arrays(ntiles, seed, lanes, device)
    out, ms = _bench_in_place(
        lambda k, p: sort_study.pass_strided(k, p, pod_tiles, stride_tiles),
        keys, payload, reps)
    gbps = _gbps(keys, ms)
    print(f"dma_pass    (T={ntiles}, pod={pod_tiles}, s={stride_tiles}): "
          f"{ms:8.3f} ms   {gbps:6.1f} GB/s eff")
    return out, {"ms": ms, "gbps": gbps}


def bench_dma_contig(ntiles: int, pod_tiles: int, *, seed: int = 0,
                     lanes: int = LANES, device=None, reps: int = 5):
    """K8 over fresh arrays: ``((keys + 1, payload + 1), {"ms", "gbps"})``."""
    keys, payload = make_arrays(ntiles, seed, lanes, device)
    out, ms = _bench_in_place(
        lambda k, p: sort_study.pass_contig(k, p, pod_tiles), keys, payload,
        reps)
    gbps = _gbps(keys, ms)
    print(f"dma_contig  (T={ntiles}, pod={pod_tiles}): "
          f"{ms:8.3f} ms   {gbps:6.1f} GB/s eff")
    return out, {"ms": ms, "gbps": gbps}


def bench_phase_a(ntiles: int, pod_tiles: int, *, seed: int = 0,
                  lanes: int = LANES, device=None, reps: int = 5):
    """K9 over fresh arrays, pods of ``pod_tiles`` tiles: ``((keys, payload)
    sorted, {"ms", "stages"})``. The first two pods of the first two columns
    are held against ``np.sort`` (the second pod descending)."""
    keys, payload = make_arrays(ntiles, seed, lanes, device)
    pod_rows = pod_tiles * TILE
    out, ms = _bench_in_place(
        lambda k, p: sort_study.bitonic_pod_sort(k, p, pod_rows), keys,
        payload, reps)
    for blk in range(min(2, keys.shape[0] // pod_rows)):
        rows = slice(blk * pod_rows, (blk + 1) * pod_rows)
        want = np.sort(keys[rows, :2].cpu().numpy(), axis=0)
        if blk % 2 == 1:
            want = want[::-1]
        if not np.array_equal(out[0][rows, :2].cpu().numpy(), want):
            raise AssertionError(f"phase A wrong at block {blk}")
    nbits = pod_rows.bit_length() - 1
    stages = nbits * (nbits + 1) // 2
    print(f"phase_a     (T={ntiles}, pod={pod_tiles} [{pod_rows} rows], "
          f"{stages} stages): {ms:8.3f} ms")
    return out, {"ms": ms, "stages": stages}


def profile_phase_a(ntiles: int, pod_tiles: int, *, seed: int = 0,
                    lanes: int = LANES, device=None) -> dict:
    """Device time in ms of every kernel of one warm K9 call (``"k9"``, in
    launch order) and of one library sort with its payload gather
    (``"library"``), as ``(kernel name, ms)`` lists from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    keys, payload = make_arrays(ntiles, seed, lanes, device)
    pod_rows = pod_tiles * TILE

    def library(k, p):
        ks, idx = torch.sort(k.reshape(-1, pod_rows, lanes), dim=1)
        return ks, torch.gather(p.reshape(-1, pod_rows, lanes), 1, idx)

    out = {}
    for name, fn in (("k9", lambda k, p: sort_study.bitonic_pod_sort(
            k, p, pod_rows)), ("library", library)):
        fn(keys.clone(), payload.clone())  # warm-up
        k, p = keys.clone(), payload.clone()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(k, p)
            torch.cuda.synchronize()
        out[name] = [(e.name, e.device_time / 1e3) for e in prof.events()
                     if e.device_type.name == "CUDA"]
        print(f"profile {name} (T={ntiles}, pods of {pod_rows} rows): "
              f"{sum(ms for _, ms in out[name]):.3f} ms on the device")
        for kernel, ms in out[name]:
            print(f"  {ms:8.3f} ms  {kernel[:90]}")
    return out


# What an ablation takes out of ``sort_chunk_kernel`` (the results are then
# wrong; only the time is read): macros of csrc/sort_study.cu
ABLATIONS = {
    "whole": (),
    "no steps": ("MDT_SORT_NO_STEPS",),
    "no re-deals (one deal)": ("MDT_SORT_NO_REDEALS",),
    "neither (load, one deal, store)": ("MDT_SORT_NO_STEPS",
                                        "MDT_SORT_NO_REDEALS"),
}


def ablate_chunk_launch(ntiles: int, pod_tiles: int = 8, *, seed: int = 0,
                        lanes: int = LANES, device=None, reps: int = 5) -> dict:
    """Median ms of K9's first chunk launch (every stage up to the chunk)
    and of a later one (one stage's strides below the chunk), for the kernel
    as it is and with parts taken out: ``{ablation: (first_ms, later_ms)}``.
    Each variant is a build of the kernels with its macros defined, beside
    the package's own library."""
    from ..kernels import _build

    keys, payload = make_arrays(ntiles, seed, lanes, device)
    pod_rows = pod_tiles * TILE
    chunk_rows = sort_study.sort_chunk_rows(pod_rows)
    chunks = [launch for launch in sort_study.sort_plan(pod_rows)
              if launch["kind"] == "chunk"]
    out = {}
    for name, defines in ABLATIONS.items():
        lib = _build.library(defines)
        out[name] = tuple(
            time_ms(lambda k, p: sort_study.run_launch(
                lib, launch, k, p, chunk_rows,
                torch.cuda.current_stream(k.device).cuda_stream),
                setup=lambda: (keys.clone(), payload.clone()), reps=reps)
            for launch in (chunks[0], chunks[-1]))
        print(f"ablate {name}: chunk launch of {len(chunks[0]['steps'])} steps "
              f"{out[name][0]:.3f} ms, of {len(chunks[-1]['steps'])} steps "
              f"{out[name][1]:.3f} ms", flush=True)
    return out


def main(which: str = "all", ntiles: int = 512) -> None:
    # pods must tile evenly: ntiles % (pod_tiles * stride_tiles) == 0
    if which in ("all", "sort"):
        bench_sort(ntiles)
    if which in ("all", "dma"):
        bench_dma_pass(ntiles, pod_tiles=16, stride_tiles=1)
        bench_dma_pass(ntiles, pod_tiles=16, stride_tiles=16)
        bench_dma_pass(ntiles, pod_tiles=8, stride_tiles=64)
    if which in ("all", "contig"):
        bench_dma_contig(ntiles, pod_tiles=16)
        bench_dma_contig(ntiles, pod_tiles=4)
    if which in ("all", "phasea"):
        bench_phase_a(ntiles, pod_tiles=8)
        bench_phase_a(ntiles, pod_tiles=16)
    if which == "profile":
        profile_phase_a(ntiles, pod_tiles=8)
    if which == "ablate":
        ablate_chunk_launch(ntiles, pod_tiles=8)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
