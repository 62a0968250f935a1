#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``),
builds the port's kernels from ``mcmcdiagnostictools_jl_tpu_torch/csrc``,
and exits nonzero, printing no result, if any phase fails:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the kernels and prints the build time;
3. per kernel: K1-K4 against their plain PyTorch versions on the card, at
   the main path's shapes (10k draws x 128 chains x 256 params, float32),
   with a NaN column and a constant column; prints error, bound and times;
4. end to end: ``ess_rhat(x, kind="rank")`` in the fast and exact rank modes
   on that sample; checks that every kernel ran, that fast tracks exact,
   and that the badly mixed parameter is flagged; prints the wall times;
5. card against CPU: the same calls at 2000 x 32 x 64 on the card and
   through the plain CPU path must agree.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Only PyTorch and numpy are used.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DRAWS, CHAINS, PARAMS = 10_000, 128, 256
NBINS = 4096
SEED = 20261016
PKG = "mcmcdiagnostictools_jl_tpu_torch"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def ar1(rng, phi: float, shape) -> np.ndarray:
    """float32 AR(1) chains along axis 0: x_t = phi x_{t-1} + e_t."""
    x = rng.standard_normal(shape, dtype=np.float32)
    for t in range(1, shape[0]):
        x[t] += np.float32(phi) * x[t - 1]
    return x


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def wall_s(fn, reps: int = 3) -> float:
    """Median host wall time of ``fn`` in s, each run ending in a sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| over entries where neither is NaN; NaN masks must agree."""
    a, b = a.double(), b.double()
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN positions differ")
    ok = ~torch.isnan(a)
    return float((a[ok] - b[ok]).abs().max()) if ok.any() else 0.0


def phase_device() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": smi, "name": name}


def phase_build() -> None:
    from mcmcdiagnostictools_jl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {path.name} "
          f"({'compiled' if log else 'cached'})")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())


def phase_kernels(x3: torch.Tensor) -> list:
    from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as fr
    from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as ma
    from mcmcdiagnostictools_jl_tpu_torch.ops.fastrank import _hist_scale
    from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape

    xk = x3.clone()
    xk[::997, :, 1] = torch.nan  # a NaN column
    xk[:, :, 2] = 0.75  # a constant column
    xf = xk.reshape(-1, PARAMS)
    rows = []

    def report(kid, err, checked, bound, what, ms, plain_ms, extra=None):
        """``err``: max abs error; ``checked``: the quantity held to
        ``bound`` (``what`` says which)."""
        print(f"[3 {kid}] max abs err {err:.3e}; {what} {checked:.3e} "
              f"(bound {bound:.1e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(checked <= bound, f"{kid} disagrees with its plain version")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, **(extra or {})))

    # K2: exact (min/max/any select existing values)
    k, p = fr.column_minmax(xf), fr.column_minmax_plain(xf)
    torch.cuda.synchronize()
    check(torch.equal(k[2], p[2]), "K2 bad flags differ")
    err = max(max_abs_err(a, b) for a, b in zip(k[:2], p[:2]))
    report("K2 column_minmax", err, err, 0.0, "exact:",
           time_ms(lambda: fr.column_minmax(xf)),
           time_ms(lambda: fr.column_minmax_plain(xf)))
    lo, hi, _ = k
    scale = _hist_scale(lo, hi, NBINS)

    # K3: counts exact; frac sums in float32 in another (atomic) order, so
    # compare the mean within-bin position fm = s1 / cnt, a sum of up to
    # ~1e3 terms in [0, 1]: bound 1e-4
    cnt, s1 = fr.hist_moments(xf, lo, scale, NBINS)
    cnt_p, s1_p = fr.hist_moments_plain(xf, lo, scale, NBINS)
    torch.cuda.synchronize()
    check(torch.equal(cnt, cnt_p), "K3 counts differ")
    fm_err = float(((s1 - s1_p).abs() / cnt.clamp(min=1.0)).max())
    report("K3 hist_moments", max_abs_err(s1, s1_p), fm_err, 1e-4,
           "counts equal; error of s1/cnt",
           time_ms(lambda: fr.hist_moments(xf, lo, scale, NBINS)),
           time_ms(lambda: fr.hist_moments_plain(xf, lo, scale, NBINS)))

    # K4 on K3's tables: both round identically; bound one float32 ulp of a
    # rank near n = 1.28M (0.125)
    fm = torch.where(cnt > 0, s1 / cnt.clamp(min=1.0), 0.5)
    cum = torch.cat([cnt.new_zeros((1, PARAMS)), cnt.cumsum(0)])
    tables = torch.stack([cum[:-1], cnt, cnt * (0.5 - fm)])
    err = max_abs_err(fr.rank_lookup(xf, lo, scale, tables, NBINS),
                      fr.rank_lookup_plain(xf, lo, scale, tables, NBINS))
    report("K4 rank_lookup", err, err, 0.125, "one f32 ulp at rank 1.28M:",
           time_ms(lambda: fr.rank_lookup(xf, lo, scale, tables, NBINS)),
           time_ms(lambda: fr.rank_lookup_plain(xf, lo, scale, tables, NBINS)))

    # K1 on the split sample (5000, 256, 256): moments and autocovariance in
    # another float32 summation order; errors relative to the series
    # variance, bound 1e-5; min/max exact
    samples = split_chains_reshape(xk, 2)
    k1 = {}
    for maxlag in (64, 250):
        k = ma.moments_autocov(samples, maxlag)
        p = ma.moments_autocov_plain(samples, maxlag)
        torch.cuda.synchronize()
        scale_var = float(p[1][~torch.isnan(p[1])].max())
        err = max(max_abs_err(k[0], p[0]), max_abs_err(k[1], p[1]),
                  max_abs_err(k[4], p[4]))
        check(max_abs_err(k[2], p[2]) == 0 and max_abs_err(k[3], p[3]) == 0,
              "K1 min/max differ")
        k1[maxlag] = (err,
                      time_ms(lambda: ma.moments_autocov(samples, maxlag)),
                      time_ms(lambda: ma.moments_autocov_plain(samples, maxlag)))
        print(f"   K1 maxlag {maxlag}: max abs err {k1[maxlag][0]:.3e}, "
              f"kernel {k1[maxlag][1]:.3f} ms, plain {k1[maxlag][2]:.3f} ms")
    err = max(k1[64][0], k1[250][0])
    report("K1 moments_autocov", err, err / scale_var, 1e-5,
           "relative to the largest variance:", k1[250][1], k1[250][2],
           {"ms_maxlag64": k1[64][1], "plain_ms_maxlag64": k1[64][2]})
    # rows in K2, K3, K4, K1 order -> K1..K4
    return [rows[3], rows[0], rows[1], rows[2]]


def phase_end_to_end(x3: torch.Tensor, bad_param: int) -> dict:
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch import kernels

    kernels.reset_launch_counts()
    fast = mtt.ess_rhat(x3, kind="rank", rank_mode="fast")
    torch.cuda.synchronize()
    fast_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    exact = mtt.ess_rhat(x3, kind="rank")
    torch.cuda.synchronize()
    exact_counts = kernels.launch_counts()
    print(f"[4 launches] fast {fast_counts}; exact {exact_counts}")
    for kid, least in (("K1", 1), ("K2", 1), ("K3", 2), ("K4", 2)):
        check(fast_counts[kid] >= least, f"{kid} ran {fast_counts[kid]} times "
              f"in the fast call, expected >= {least}")
    check(exact_counts["K1"] >= 1, "K1 did not run in the exact call")

    for res in (fast, exact):
        for v in res:
            check(v.shape == (PARAMS,) and v.device.type == "cuda",
                  f"bad output shape/device {tuple(v.shape)} {v.device}")
            check(bool(torch.isfinite(v).all()), "non-finite ESS or R-hat")
    ess_rel = float((fast.ess / exact.ess - 1).abs().max())
    rhat_abs = float((fast.rhat - exact.rhat).abs().max())
    print(f"[4 fast vs exact] ESS rel {ess_rel:.3e} (bound 1e-2), "
          f"R-hat abs {rhat_abs:.3e} (bound 1e-3)")
    check(ess_rel <= 1e-2 and rhat_abs <= 1e-3, "fast mode does not track exact")
    rb = float(exact.rhat[bad_param])
    rest = float(exact.rhat[torch.arange(PARAMS, device="cuda") != bad_param].max())
    print(f"[4 mixing] R-hat of the shifted parameter {rb:.4f}; "
          f"max of the others {rest:.4f}")
    check(rb > 1.1 and rest < 1.1, "badly mixed parameter not flagged")

    walls = {
        "fast_s": wall_s(lambda: mtt.ess_rhat(x3, kind="rank", rank_mode="fast")),
        "exact_s": wall_s(lambda: mtt.ess_rhat(x3, kind="rank")),
    }
    print(f"[4 wall] fast {walls['fast_s']:.4f} s, exact {walls['exact_s']:.4f} s "
          f"(median of 3, {DRAWS}x{CHAINS}x{PARAMS} f32)")
    return {"counts": fast_counts, **walls}


def _geyer_stop_pairs(x3: torch.Tensor, rank_mode: str, maxlag: int):
    """Per parameter, the index of the first nonpositive Geyer pair of the
    bulk ESS: where the truncation falls."""
    from mcmcdiagnostictools_jl_tpu_torch.ops.fastrank import fast_rank_bulk_tail
    from mcmcdiagnostictools_jl_tpu_torch.ops.moments import fused_chain_stats_autocov
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import rank_normalize
    from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape

    z = fast_rank_bulk_tail(x3)[0] if rank_mode == "fast" else rank_normalize(x3)
    stats, acov = fused_chain_stats_autocov(split_chains_reshape(z, 2), maxlag)
    rho = 1.0 - (stats.w[None] - acov) / stats.var_plus[None]
    npairs = (maxlag - 2) // 2
    stop = ~(rho[2:2 + 2 * npairs:2] + rho[3:3 + 2 * npairs:2] > 0)
    return torch.where(stop.any(0), stop.int().argmax(0), npairs).cpu()


def phase_card_vs_cpu() -> None:
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    rng = np.random.default_rng(SEED + 1)
    x_cpu = torch.from_numpy(ar1(rng, 0.5, (2000, 32, 64)))
    x_gpu = x_cpu.cuda()
    for mode in ("fast", "exact"):
        g = mtt.ess_rhat(x_gpu, kind="rank", rank_mode=mode)
        c = mtt.ess_rhat(x_cpu, kind="rank", rank_mode=mode)
        ess_rel = (g.ess.cpu() / c.ess - 1).abs()
        rhat_abs = (g.rhat.cpu() - c.rhat).abs()
        print(f"[5 {mode}] card vs CPU: ESS rel {float(ess_rel.max()):.3e} "
              f"(bound 1e-3), R-hat abs {float(rhat_abs.max()):.3e} (bound 1e-4)")
        check(bool((rhat_abs <= 1e-4).all()), f"{mode}: R-hat card != CPU")
        off = torch.nonzero(~(ess_rel <= 1e-3)).flatten().tolist()
        if not off:
            continue
        # the only allowed exception: one parameter whose Geyer truncation
        # falls on another lag pair on the card than on the CPU
        maxlag = min(250, 2000 // 2 - 4)
        sg = _geyer_stop_pairs(x_gpu, mode, maxlag)
        sc = _geyer_stop_pairs(x_cpu, mode, maxlag)
        for j in off:
            print(f"   param {j}: ESS card {float(g.ess[j]):.3f} CPU "
                  f"{float(c.ess[j]):.3f}; Geyer stop pair card {int(sg[j])} "
                  f"CPU {int(sc[j])}")
        check(len(off) == 1 and int(sg[off[0]]) != int(sc[off[0]]),
              f"{mode}: ESS card != CPU beyond a single truncation flip")
        print(f"   accepted: a single Geyer truncation flip (param {off[0]})")


def main() -> int:
    dev = phase_device()
    import mcmcdiagnostictools_jl_tpu_torch  # noqa: F401  (fails outside the repo)

    phase_build()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    x_np = ar1(rng, 0.5, (DRAWS, CHAINS, PARAMS))
    bad_param = 0
    # an eighth of the chains of one parameter sit 4 sd off: the rank-based
    # R-hat of 128 chains cannot be pushed past 1.1 by one chain alone
    x_np[:, : CHAINS // 8, bad_param] += 4.0
    x3 = torch.from_numpy(x_np).cuda()
    del x_np
    print(f"[data] AR(1) phi=0.5 {DRAWS}x{CHAINS}x{PARAMS} f32 on the card "
          f"({x3.numel() * 4 / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")

    rows = phase_kernels(x3)
    e2e = phase_end_to_end(x3, bad_param)
    phase_card_vs_cpu()

    src = f"{PKG}/csrc/"
    pallas = "mcmcdiagnostictools_jl_tpu/ops/pallas/"
    meta = [
        ("K1 moments_autocov", src + "moments_autocov.cu",
         pallas + "fused_basic_kernel.py:67"),
        ("K2 column_minmax", src + "fastrank.cu", pallas + "fastrank_kernel.py:360"),
        ("K3 hist_moments", src + "fastrank.cu", pallas + "fastrank_kernel.py:173"),
        ("K4 rank_lookup", src + "fastrank.cu", pallas + "fastrank_kernel.py:275"),
    ]
    kernels_out = []
    for (name, source, replaces), row, kid in zip(meta, rows, ("K1", "K2", "K3", "K4")):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": e2e["counts"][kid],
                 "max_abs_err": row.pop("err"), "ms": row.pop("ms"),
                 "plain_ms": row.pop("plain_ms")}
        entry.update(row)
        kernels_out.append(entry)
    print(json.dumps({"wall_fast_s": e2e["fast_s"], "wall_exact_s": e2e["exact_s"]}))
    print(dev["smi"])
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
