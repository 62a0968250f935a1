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
   K3 also through its finishing entry point (prefix counts equal, fm within
   1e-4, K4's table equal to its cum and fm, two runs bit-equal), plain and
   folded around a shift; K4 bit-equal also with shift, fill and bad, with
   the kernel its wrapper chose by shape, and through its gather route;
   then K1 and K5 at lag counts on both sides of a block's span (maxlag 0,
   64, 65, 250, 255, 256, 300), at a draw count off every tile, at series
   counts off 32 and off 4, and at ``maxlag >= niter``;
4. end to end: ``ess_rhat(x, kind="rank")`` in the fast and exact rank modes
   on that sample; checks that every kernel ran, that fast tracks exact,
   and that the badly mixed parameter is flagged; then the same sample as
   numpy float64 with no device, which must run K1-K4 on the card and give
   the float32 tensor's result; prints the wall times;
5. card against CPU: the same calls at 2000 x 32 x 64 on the card and
   through the plain CPU path must agree;
6. the estimator path with ``DirectKernelAutocovMethod`` (kernel K5): K5
   against its plain version, against K1's autocovariance and (with K1)
   against K6's variant A on the split sample: equal bit for bit where the
   tile is 128 draws; ``mcse`` and the estimator kinds of ``ess`` on the full
   sample in both rank modes, with the marker (K5 must run in every call) and with
   ``"auto"`` (K5 must not run), which must agree, with fast tracking exact;
   then those calls plus the SBM fallback, ``rhat_nested`` and ``bfmi`` at
   2000 x 32 x 64 on the card against the CPU;
7. K4's fused z mode (``blom_n``) against its plain version on the full
   sample, then the fast ``ess_rhat`` with ``FUSE_BLOM_Z`` on (the z mode
   must run for bulk and fold) and off, which must agree; walls in turns;
8. the classical suite: K5 on the flagship Heidelberger and Geweke masked
   window stacks (10k draws; 196,608 and 65,536 series) against its plain
   version; the five functions on BASELINE.md config 3
   (10k x 8 x 100) and Gelman/Geweke/Heidelberger/Raftery on the full
   sample, with walls, peak memory and K5's launches (it must run in Geweke
   and Heidelberger); then card against CPU at 2000 x 8 x 16, N-d and 1-d;
9. the lag-loop study (kernel K6) through ``benchmarks.micro_lagloop`` at
   (5000, 16384) and at K5's shape (5000, 65536), maxlag 250: variants A and B
   against the plain version and against each other, with the registers and
   spills of B (the loop K1 and K5 run) from the build;
10. the sort study through ``benchmarks.sort_microbench`` at 1,048,576 x 128
    keys and payload: K7 at three (pods, stride) settings and K8 at two, equal
    to the plain version, with their share of the memory rate; K9 at pods of
    16,384 and 32,768 rows against its plain version, beside ``torch.sort``,
    then at a pod smaller than a chunk and a column count off the 8-column
    block, with the chunk kernel's registers and spills from the build;
11. out of core: BASELINE.md config 4 (10k x 128 x 1000 float32, 5.12 GB) on
    the host through ``ess_rhat_streaming`` in chunks of 256 parameters: K1-K4
    must run in every chunk, the first 256 parameters must equal the resident
    call of phase 4, peak device memory must stay bounded whatever the number
    of chunks; prints the wall beside the sums of gather, copy and compute;
    then the exact rank mode in chunks of 64 against phase 4's exact result;
12. ``discretediag`` on BASELINE.md config 3 digitized into 4 categories
    (10k x 8 x 100): all six methods at nsim=1000 on the card, the three
    chi-squared methods against the CPU (stat, df, p within 1e-9 relative),
    the bootstrap methods' statistic against the CPU's, finite df and
    p-values in [0, 1], their df and p-values against the CPU's at nsim=1000
    on the first 4 parameters (df 15 %, p on the same side of 0.05 where the
    CPU's lies 3 Monte Carlo errors from it), MCBOOT's NaN statistic and 0.0
    p-value; a chain drawn from other category probabilities flagged at
    p < 1e-3 by weiss and billingsley; walls, the share of each bootstrap
    wall spent in the loop over draws, and a profile of that loop;
13. dense R*: the default ``GBTClassifier()`` through ``rstar`` on 1000 x 8
    x 100 AR(1) draws with one chain of one parameter shifted by 1 sd and
    without, probabilistic and deterministic (shifted above unshifted, the
    dense fit must run); one fitted state predicts the same logits on the
    card and on the CPU (1e-5);
14. BASELINE.md config 5's R* (100 draws x 10,000 chains x 4 params: 20,000
    classes on ~700k training rows) through the class-chunked fit, which
    must run, mean in [0.9, 1.1]; wall, peak memory, and the device time
    split between the logit products, the histograms and the rest; then its
    first 256 chains through the dense and the class-chunked fit (splits
    equal, leaf values within 5e-6);
15. float64 on the card: ``ess_rhat`` in both rank modes, ``mcse`` mean and
    ``gewekediag`` at 2000 x 32 x 64 run the plain versions on the card (no
    kernel may launch) and agree with the CPU within 1e-6;
16. the sharded path (``parallel``), run after phase 11 on its data and, for
    the GBT, after phase 13, over a (1, 1) mesh of a world of one rank over
    NCCL (the card takes one rank): ``ess_rhat_sharded(kind="rank")`` with
    the gather, ring and hist rank transforms and ``rhat_nested_sharded`` on
    16 superchains at 10k x 128 x 256, each with its launches counted from
    0 (hist: K3 and K4 twice, every ``ess_rhat_sharded`` call K5, K1 and K2
    never), its wall beside the in-core call's and its largest differences
    from the in-core results (ESS 1e-3 relative, R-hat 1e-4 absolute; ring
    against gather 1e-6); config 4 through ``ess_rhat_streaming(mesh_cfg=
    ...)`` against phase 11's result; ``ShardedGBTClassifier`` on phase 13's
    rows: the same forest.

The line before the last two is the card's name and power limit, the
second-to-last line the kernels' JSON record (each with its time, its plain
version's, its bound and, where one PyTorch call computes the same, that
call's), the last line ``{"ok": true, "device": {...}}``. Only PyTorch and
numpy are used.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed

DRAWS, CHAINS, PARAMS = 10_000, 128, 256
NBINS = 4096
SEED = 20261016
PKG = "mcmcdiagnostictools_jl_tpu_torch"
# H100 SXM data sheet: device memory rate, and the float32 rate outside the
# tensor cores (an FMA counts as two operations)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 66.9e12


def roofline(nbytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes that must
    move over the memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lag_bound(niter: int, nseries: int, maxlag: int) -> dict:
    """Bound of the lag products (K1, K5, K6): the series read once, the lags
    written once, niter * (maxlag + 1) FMAs a series."""
    return roofline(4.0 * nseries * (niter + maxlag + 1),
                 2.0 * niter * (maxlag + 1) * nseries)


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


def time_ms(fn, reps: int = 5, warmup: bool = True, setup=None) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after a warm-up
    call unless the caller has just made one. ``setup`` makes the arguments
    of each call (fresh copies for a function that works in place) outside
    the timed window."""
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import time_ms as timer

    return timer(fn, setup=setup, reps=reps, warmup=warmup)


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


def with_bad_columns(x3: torch.Tensor) -> torch.Tensor:
    """A copy of the sample with a NaN column (1) and a constant column (2)."""
    xk = x3.clone()
    xk[::997, :, 1] = torch.nan
    xk[:, :, 2] = 0.75
    return xk


def check_agree(tag: str, a, b, rel: float, stops=None, ranks=None) -> float:
    """``a`` and ``b`` (P,) within ``rel`` relative. Two exceptions:

    - for a quantile MCSE, ``ranks()`` gives each run's ``(ess, l, u)``: a
      parameter whose interval ranks ``l``, ``u`` differ between the runs
      reads other order statistics, and is accepted when the ESS values
      behind the ranks agree within 1e-3 (with equal ranks both runs read
      the same order statistics, and ``rel`` holds);
    - a single parameter whose Geyer truncation falls on another lag pair in
      the two runs; ``stops()`` gives both runs' stop pairs.
    """
    a, b = a.double().cpu(), b.double().cpu()
    dev = (a / b - 1).abs()
    worst = float(dev.max())
    print(f"   {tag}: max rel dev {worst:.3e} (bound {rel:.1e})")
    off = torch.nonzero(~(dev <= rel)).flatten().tolist()
    if not off:
        return worst
    if ranks is not None:
        (ea, la, ua), (eb, lb, ub) = ranks()
        for j in off:
            print(f"   param {j}: {float(a[j]):.6g} vs {float(b[j]):.6g}; ranks "
                  f"l {int(la[j])} vs {int(lb[j])}, u {int(ua[j])} vs "
                  f"{int(ub[j])}; ESS {float(ea[j]):.6g} vs {float(eb[j]):.6g}")
            check(int(la[j]) != int(lb[j]) or int(ua[j]) != int(ub[j]),
                  f"{tag}: param {j} disagrees with equal interval ranks")
        off = [j for j in off if not abs(float(ea[j] / eb[j]) - 1) <= 1e-3]
        if not off:
            print("   accepted: interval ranks moved by ESS within 1e-3")
            return worst
    check(stops is not None and len(off) == 1, f"{tag}: disagree at {off}")
    sa, sb = stops()
    j = off[0]
    print(f"   param {j}: {float(a[j]):.6g} vs {float(b[j]):.6g}; Geyer stop "
          f"pair {int(sa[j])} vs {int(sb[j])}")
    check(int(sa[j]) != int(sb[j]), f"{tag}: beyond a single truncation flip")
    print(f"   accepted: a single Geyer truncation flip (param {j})")
    return worst


def phase_device() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": smi, "name": name}


def phase_build() -> str:
    """Builds the kernels; returns the compiler's output (empty when the
    library was there already)."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {path.name} "
          f"({'compiled' if log else 'cached'})")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())
    return log


def phase_kernels(x3: torch.Tensor) -> list:
    """K1-K4 against their plain versions; each row carries its bound (K1:
    the lag products' operations; K2-K4: the sample read once, K4's output
    written once, the tables). K3 also through its finishing entry point
    (prefix counts equal, fm within 1e-4, K4's table, run twice) and folded
    around a shift; K4 also with shift, fill and bad, and through its gather
    route."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as fr
    from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as ma
    from mcmcdiagnostictools_jl_tpu_torch.ops.fastrank import _hist_scale
    from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape

    xk = with_bad_columns(x3)
    xf = xk.reshape(-1, PARAMS)
    rows = []

    def report(kid, err, checked, bound, what, ms, plain_ms, extra=None):
        """``err``: max abs error; ``checked``: the quantity held to
        ``bound`` (``what`` says which)."""
        print(f"[3 {kid}] max abs err {err:.3e}; {what} {checked:.3e} "
              f"(bound {bound:.1e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(checked <= bound, f"{kid} disagrees with its plain version")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, **(extra or {})))

    n = xf.shape[0]
    sample_bytes = 4.0 * n * PARAMS

    # K2: exact (min/max/any select existing values)
    k, p = fr.column_minmax(xf), fr.column_minmax_plain(xf)
    torch.cuda.synchronize()
    check(torch.equal(k[2], p[2]), "K2 bad flags differ")
    err = max(max_abs_err(a, b) for a, b in zip(k[:2], p[:2]))
    # the library call for K2's function on input without NaN
    x2 = x3.reshape(-1, PARAMS)
    report("K2 column_minmax", err, err, 0.0, "exact:",
           time_ms(lambda: fr.column_minmax(xf)),
           time_ms(lambda: fr.column_minmax_plain(xf)),
           {**roofline(sample_bytes),
            "library_ms": time_ms(lambda: torch.aminmax(x2, dim=0))})
    lo, hi, bad = k
    scale = _hist_scale(lo, hi, NBINS)

    # K3: counts exact; the kernel's frac sums are exact fixed-point sums
    # rounded once, the plain version's float32 sums in scatter order, so
    # compare the mean within-bin position fm = s1 / cnt, a sum of up to
    # ~1e3 terms in [0, 1]: bound 1e-4
    cnt, s1 = fr.hist_moments(xf, lo, scale, NBINS)
    cnt_p, s1_p = fr.hist_moments_plain(xf, lo, scale, NBINS)
    torch.cuda.synchronize()
    check(torch.equal(cnt, cnt_p), "K3 counts differ")
    fm_err = float(((s1 - s1_p).abs() / cnt.clamp(min=1.0)).max())
    # the finishing entry point (what the main path calls), plain and folded
    # around a per-column shift; twice: integer sums do not depend on order
    med = torch.nan_to_num(xf[::1000].nanmedian(0).values)
    hi_f = torch.maximum(hi - med, med - lo)
    scale_f = _hist_scale(torch.zeros_like(lo), hi_f, NBINS)
    for tag, args in (("", (xf, lo, scale, NBINS)),
                      (" folded", (xf, torch.zeros_like(lo), scale_f, NBINS,
                                   med))):
        cum, fm, tab = fr.hist_cdf_tables(*args)
        again = fr.hist_cdf_tables(*args)
        cum_p, fm_p, _ = fr.hist_cdf_tables_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(cum, cum_p), f"K3{tag}: prefix counts differ")
        err = float((fm - fm_p).abs().max())
        check(err <= 1e-4, f"K3{tag}: fm off its plain version by {err:.2e}")
        check(torch.equal(tab, fr.pack_tables(cum, fm)),
              f"K3{tag}: K4's table is not its cum and fm")
        check(all(torch.equal(a, b) for a, b in zip((cum, fm, tab), again)),
              f"K3{tag}: two runs differ")
        print(f"   K3 hist_cdf_tables{tag}: cum equal, fm within {err:.3e} "
              "(bound 1e-4), table equal to pack_tables(cum, fm), two runs "
              "bit-equal")
        fm_err = max(fm_err, err)
    report("K3 hist_moments", max_abs_err(s1, s1_p), fm_err, 1e-4,
           "counts equal; error of s1/cnt",
           time_ms(lambda: fr.hist_cdf_tables(xf, lo, scale, NBINS)),
           time_ms(lambda: fr.hist_cdf_tables_plain(xf, lo, scale, NBINS)),
           {**roofline(sample_bytes + 8.0 * NBINS * PARAMS),
            "deterministic": True, "ms_hist_moments": time_ms(
                lambda: fr.hist_moments(xf, lo, scale, NBINS)),
            "ms_folded": time_ms(lambda: fr.hist_cdf_tables(
                xf, torch.zeros_like(lo), scale_f, NBINS, med))})

    # K4 on K3's table: both round identically; bound one float32 ulp of a
    # rank near n = 1.28M (0.125), measured 0. Plain, then folded with the
    # constant column filled and the NaN column masked by the kernel
    cum, fm, tab = fr.hist_cdf_tables(xf, lo, scale, NBINS)
    fill = torch.full_like(lo, torch.nan).masked_fill(hi <= lo, (n + 1) * 0.5)
    _, _, tab_f = fr.hist_cdf_tables(xf, torch.zeros_like(lo), scale_f, NBINS,
                                     med)
    folded = (xf, torch.zeros_like(lo), scale_f, tab_f, NBINS)
    extras = dict(shift=med, fill=fill, bad=bad)
    err = max_abs_err(fr.rank_lookup(xf, lo, scale, tab, NBINS),
                      fr.rank_lookup_plain(xf, lo, scale, tab, NBINS))
    route = fr.rank_lookup.route
    err_f = max_abs_err(fr.rank_lookup(*folded, **extras),
                        fr.rank_lookup_plain(*folded, **extras))
    print(f"   K4 route {route} (kernel, columns a block, row chunks), chosen "
          f"by shape; with shift, fill and bad: max abs err {err_f:.3e}")
    check(route[0] == "wide", "K4 did not take its wide kernel at this shape")
    check(err_f == 0.0, "K4 with shift, fill and bad is not bit-equal")
    # the [C, cnt, off] stack of the first design goes through the L2 gather
    cnt_t = cum[1:] - cum[:-1]
    stack = torch.stack([cum[:-1], cnt_t, cnt_t * (0.5 - fm)])
    err_g = max_abs_err(fr.rank_lookup(xf, lo, scale, stack, NBINS),
                        fr.rank_lookup_plain(xf, lo, scale, stack, NBINS))
    check(fr.rank_lookup.route == ("gather",) and err_g == 0.0,
          "K4's gather route is not bit-equal")
    gather_ms = time_ms(lambda: fr.rank_lookup(xf, lo, scale, stack, NBINS))
    del stack, cnt_t
    report("K4 rank_lookup", err, err, 0.125, "one f32 ulp at rank 1.28M:",
           time_ms(lambda: fr.rank_lookup(xf, lo, scale, tab, NBINS)),
           time_ms(lambda: fr.rank_lookup_plain(xf, lo, scale, tab, NBINS)),
           {**roofline(2 * sample_bytes + 12.0 * NBINS * PARAMS),
            "kernel_by_shape": list(route), "ms_gather_kernel": gather_ms,
            "ms_folded_filled": time_ms(
                lambda: fr.rank_lookup(*folded, **extras))})

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
           {"ms_maxlag64": k1[64][1], "plain_ms_maxlag64": k1[64][2],
            **lag_bound(samples.shape[0], samples.shape[1] * PARAMS, 250),
            "bound_ms_maxlag64": lag_bound(
                samples.shape[0], samples.shape[1] * PARAMS, 64)["bound_ms"]})
    # rows in K2, K3, K4, K1 order -> K1..K4
    return [rows[3], rows[0], rows[1], rows[2]]


# K1 and K5 in float32 sums of another order than their plain versions,
# relative to the largest lag-0 value (phases 3, 6, 8 and 9)
LAG_REL_BOUND = 1e-5


def phase_lag_shapes() -> None:
    """K1 and K5 against their plain versions where the lag loop's tiling
    shows: lag counts on both sides of a block's span (68, 128, 256 lags),
    1001 draws (no multiple of a tile of 128 or 136), 259 series (no
    multiple of 4: 4-byte copies) and 148 (of 4, not of 32), and more lags
    than draws."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5
    from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as ma

    rng = np.random.default_rng(SEED + 8)
    worst = 0.0
    for niter, nchains, nparams, lags in (
            (1001, 7, 37, (0, 64, 65, 250, 255, 256, 300)),
            (1001, 4, 37, (64, 250, 300)),
            (300, 3, 7, (303,)), (7, 5, 3, (12,))):
        x = torch.from_numpy(
            ar1(rng, 0.5, (niter, nchains, nparams)) + np.float32(0.5)).cuda()
        for maxlag in lags:
            k = ma.moments_autocov(x, maxlag)
            p = ma.moments_autocov_plain(x, maxlag)
            centered = (x - p[0]).contiguous()
            k5_out = k5.direct_autocov(centered, maxlag)
            k5_plain = k5.direct_autocov_plain(centered, maxlag)
            torch.cuda.synchronize()
            scale = float(p[4][0].max())
            err1 = max(max_abs_err(a, b) for a, b in zip(k, p)) / scale
            err5 = max_abs_err(k5_out, k5_plain) / scale
            check(max_abs_err(k[2], p[2]) == 0 and max_abs_err(k[3], p[3]) == 0,
                  "K1 min/max differ")
            check(k[4].shape == (maxlag + 1, nchains, nparams)
                  and k5_out.shape == k[4].shape, "bad autocovariance shape")
            for out in (k[4], k5_out):
                check(not bool(out[niter:].any()),
                      "lags at or beyond niter are not 0")
            check(err1 <= LAG_REL_BOUND and err5 <= LAG_REL_BOUND,
                  f"K1 ({err1:.2e}) or K5 ({err5:.2e}) off its plain version "
                  f"at {(niter, nchains, nparams)}, maxlag {maxlag}")
            worst = max(worst, err1, err5)
    print(f"[3 K1/K5 shapes] 12 shapes across spans, tiles and series blocks: "
          f"max err relative to the largest c_0 {worst:.3e} (bound "
          f"{LAG_REL_BOUND:.0e})")


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

    # the plainest call, numpy float64 with no device: float32 on the card
    # (the JAX package's default), so K1-K4 run and give the tensor's result
    x_np = x3.cpu().numpy().astype(np.float64)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from_np = mtt.ess_rhat(x_np, kind="rank", rank_mode="fast")
    torch.cuda.synchronize()
    np_wall = time.perf_counter() - t0
    np_counts = kernels.launch_counts()
    del x_np
    np_ess = float((from_np.ess / fast.ess - 1).abs().max())
    np_rhat = float((from_np.rhat - fast.rhat).abs().max())
    print(f"[4 numpy float64, no device] {np_counts}; on {from_np.ess.device} "
          f"{from_np.ess.dtype}; vs the float32 tensor: ESS rel {np_ess:.3e}, "
          f"R-hat abs {np_rhat:.3e} (bounds 1e-6); wall {np_wall:.3f} s (the "
          "host cast and copy of 2.6 GB included)")
    for kid, least in (("K1", 1), ("K2", 1), ("K3", 2), ("K4", 2)):
        check(np_counts[kid] >= least, f"{kid} ran {np_counts[kid]} times in "
              f"the numpy float64 call, expected >= {least}")
    check(from_np.ess.device.type == "cuda"
          and from_np.ess.dtype == torch.float32
          and np_ess <= 1e-6 and np_rhat <= 1e-6,
          "numpy float64 input does not give the float32 tensor's result")

    walls = {
        "fast_s": wall_s(lambda: mtt.ess_rhat(x3, kind="rank", rank_mode="fast")),
        "exact_s": wall_s(lambda: mtt.ess_rhat(x3, kind="rank")),
    }
    print(f"[4 wall] fast {walls['fast_s']:.4f} s, exact {walls['exact_s']:.4f} s "
          f"(median of 3, {DRAWS}x{CHAINS}x{PARAMS} f32)")
    return {"counts": fast_counts, "fast": fast, "exact": exact,
            "numpy_float64_s": np_wall, **walls}


def geyer_stop_pairs(proxy: torch.Tensor, method: str, maxlag: int):
    """Per parameter, the index of the first nonpositive Geyer pair of the
    ESS of ``proxy`` (split in 2) with the autocovariance ``method``
    (``"kernel"``: K1, ``"direct_kernel"``: K5): where the truncation
    falls."""
    from mcmcdiagnostictools_jl_tpu_torch.ops.autocov import mean_autocov_curve
    from mcmcdiagnostictools_jl_tpu_torch.ops.moments import (
        chain_stats, fused_chain_stats_autocov)
    from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape

    samples = split_chains_reshape(proxy, 2)
    if method == "kernel":
        stats, acov = fused_chain_stats_autocov(samples, maxlag)
    else:
        stats = chain_stats(samples)
        acov = mean_autocov_curve(samples - stats.chain_mean[None],
                                  stats.chain_var, maxlag, method)
    rho = 1.0 - (stats.w[None] - acov) / stats.var_plus[None]
    npairs = (maxlag - 2) // 2
    stop = ~(rho[2:2 + 2 * npairs:2] + rho[3:3 + 2 * npairs:2] > 0)
    return torch.where(stop.any(0), stop.int().argmax(0), npairs).cpu()


def bulk_z(x3: torch.Tensor, rank_mode: str) -> torch.Tensor:
    from mcmcdiagnostictools_jl_tpu_torch.ops.fastrank import fast_rank_bulk_tail
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import rank_normalize

    return fast_rank_bulk_tail(x3)[0] if rank_mode == "fast" else rank_normalize(x3)


def phase_card_vs_cpu() -> None:
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    rng = np.random.default_rng(SEED + 1)
    x_cpu = torch.from_numpy(ar1(rng, 0.5, (2000, 32, 64)))
    x_gpu = x_cpu.cuda()
    maxlag = min(250, 2000 // 2 - 4)
    for mode in ("fast", "exact"):
        g = mtt.ess_rhat(x_gpu, kind="rank", rank_mode=mode)
        c = mtt.ess_rhat(x_cpu, kind="rank", rank_mode=mode)
        rhat_abs = (g.rhat.cpu() - c.rhat).abs()
        print(f"[5 {mode}] card vs CPU: R-hat abs {float(rhat_abs.max()):.3e} "
              "(bound 1e-4)")
        check(bool((rhat_abs <= 1e-4).all()), f"{mode}: R-hat card != CPU")
        check_agree(
            f"[5 {mode}] ESS card vs CPU", g.ess, c.ess, 1e-3,
            lambda: (geyer_stop_pairs(bulk_z(x_gpu, mode), "kernel", maxlag),
                     geyer_stop_pairs(bulk_z(x_cpu, mode), "kernel", maxlag)))

# ---- phase 6: the estimator path with DirectKernelAutocovMethod (K5) -------

# fast against exact quantile MCSE, pinned in tests/test_torch_mcse.py:
# measured at most 1.62e-2 on the CPU at 4000 x 16 x 32 (p = 0.05)
MCSE_Q_FAST_BOUND = 2.5e-2


def phase_direct_autocov(x3: torch.Tensor) -> dict:
    """K5 against its plain version and against K1's autocovariance on the
    split sample (5000, 256, 256), at maxlag 64 and 250; then K5 and K1
    against K6's variant A, the first form of the loop, on the same centered
    series: equal bit for bit where the production loop's tile is variant
    A's 128 draws (the same products added in the same order), else within
    ``LAG_REL_BOUND`` of the largest variance."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5
    from mcmcdiagnostictools_jl_tpu_torch.kernels import lagloop_study as ls
    from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as ma
    from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape

    samples = split_chains_reshape(with_bad_columns(x3), 2)
    centered = (samples - samples.mean(0)).contiguous()
    row = {"err": 0.0}
    for maxlag in (64, 250):
        k = k5.direct_autocov(centered, maxlag)
        p = k5.direct_autocov_plain(centered, maxlag)  # also the warm-up
        torch.cuda.synchronize()
        scale_var = float(p[0][~torch.isnan(p[0])].max())
        err = max_abs_err(k, p)
        mean1, _, _, _, acov1 = ma.moments_autocov(samples, maxlag)
        centered1 = (samples - mean1).contiguous()
        err_k1 = max_abs_err(k5.direct_autocov(centered1, maxlag), acov1)
        niter = samples.shape[0]
        err_a = max(
            max_abs_err(ls.lag_products(c.reshape(niter, -1), maxlag, "a"),
                        out.reshape(maxlag + 1, -1))
            for c, out in ((centered, k), (centered1, acov1)))
        del centered1
        # up to 68 lags the loop runs 4 warps x 17 lags on tiles of 136 draws
        tile = 136 if maxlag + 1 <= 68 else 128
        print(f"[6 K5 and K1 against K6a] maxlag {maxlag} (tile {tile}): max "
              f"abs diff {err_a:.3e}"
              + (" (must be 0)" if tile == 128 else
                 f", relative {err_a / scale_var:.3e} (bound "
                 f"{LAG_REL_BOUND:.0e})"))
        check(err_a == 0.0 if tile == 128
              else err_a / scale_var <= LAG_REL_BOUND,
              "K5 or K1 disagrees with the first form of the lag loop")
        ms = time_ms(lambda: k5.direct_autocov(centered, maxlag))
        plain_ms = time_ms(lambda: k5.direct_autocov_plain(centered, maxlag),
                           warmup=False)
        print(f"[6 K5 direct_autocov] maxlag {maxlag}: max abs err {err:.3e} "
              f"(relative to the largest variance {err / scale_var:.3e}, "
              f"bound 1e-5); against K1's acov {err_k1:.3e} (relative "
              f"{err_k1 / scale_var:.3e}); kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms")
        check(err / scale_var <= LAG_REL_BOUND,
              "K5 disagrees with its plain version")
        check(err_k1 / scale_var <= LAG_REL_BOUND, "K5 disagrees with K1's acov")
        sfx = "" if maxlag == 250 else "_maxlag64"
        row.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "max_abs_err_vs_k1" + sfx: err_k1,
                    "max_abs_err_vs_k6a" + sfx: err_a})
        row["err"] = max(row["err"], err)
    series = samples.shape[1] * PARAMS
    row.update(lag_bound(samples.shape[0], series, 250))
    row["bound_ms_maxlag64"] = lag_bound(samples.shape[0], series,
                                         64)["bound_ms"]
    return row


def estimator_calls():
    from mcmcdiagnostictools_jl_tpu_torch import Quantile

    return ([("ess", k) for k in ("mean", "std", "median", "mad",
                                  Quantile(0.99))]
            + [("mcse", k) for k in ("mean", "std", "median", Quantile(0.05),
                                     Quantile(0.99))])


def call_proxy(x3: torch.Tensor, fn: str, kind, rank_mode: str):
    """The series whose ESS the call ``fn(x3, kind=kind)`` computes."""
    from mcmcdiagnostictools_jl_tpu_torch import Quantile
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics.ess_rhat import (
        _expectand_proxy, _fast_expectand_proxy)

    if isinstance(kind, Quantile):
        est, q = "quantile", kind.p
    elif fn == "mcse" and kind == "median":
        est, q = "quantile", 0.5
    else:
        est, q = kind, None
    if rank_mode == "fast":
        return _fast_expectand_proxy(est, x3, q, NBINS)
    return _expectand_proxy(est, x3, q)


def mcse_quantile_p(fn: str, kind) -> float | None:
    """The probability of a quantile MCSE call, None for any other call."""
    from mcmcdiagnostictools_jl_tpu_torch import Quantile

    if fn != "mcse" or kind in ("mean", "std"):
        return None
    return kind.p if isinstance(kind, Quantile) else 0.5


def interval_ranks(x3: torch.Tensor, p: float, rank_mode: str, method):
    """``() -> (ess, l, u)`` on the host: the proxy ESS and the Beta interval
    ranks that ``mcse(x3, kind=Quantile(p))`` reads its order statistics at."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics.mcse import (
        _beta_interval_ranks)

    def run():
        s = mtt.ess(x3, kind=mtt.Quantile(p), rank_mode=rank_mode,
                    autocov_method=method)
        l, u = _beta_interval_ranks(s, p, x3.shape[0] * x3.shape[1])
        return s.double().cpu(), l.cpu(), u.cpu()
    return run


def phase_estimators(x3: torch.Tensor) -> dict:
    """``ess`` and ``mcse`` of the estimator kinds at full width, both rank
    modes, with the K5 marker and with ``"auto"``."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch import kernels

    marker = mtt.DirectKernelAutocovMethod()
    calls = [(fn, kind, mode) for fn, kind in estimator_calls()
             for mode in ("exact", "fast")]
    out = {}
    kernels.reset_launch_counts()
    for fn, kind, mode in calls:
        before = kernels.launch_counts()["K5"]
        out[fn, kind, mode, "marker"] = getattr(mtt, fn)(
            x3, kind=kind, rank_mode=mode, autocov_method=marker)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["K5"] > before,
              f"K5 did not run in {fn}(kind={kind!r}, rank_mode={mode!r}) "
              "with the marker")
    marker_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    for fn, kind, mode in calls:
        out[fn, kind, mode, "auto"] = getattr(mtt, fn)(
            x3, kind=kind, rank_mode=mode)
    torch.cuda.synchronize()
    auto_counts = kernels.launch_counts()
    print(f"[6 launches] marker calls {marker_counts}; auto calls {auto_counts}")
    check(auto_counts["K5"] == 0, "K5 ran in an autocov_method='auto' call")
    for v in out.values():
        check(v.shape == (PARAMS,) and v.device.type == "cuda",
              f"bad output shape/device {tuple(v.shape)} {v.device}")
        check(bool(torch.isfinite(v).all()), "non-finite ESS or MCSE")

    maxlag = 250
    for fn, kind, mode in calls:
        tag = f"[6 {fn} {kind!r} {mode}]"
        proxy = call_proxy(x3, fn, kind, mode)
        q = mcse_quantile_p(fn, kind)
        check_agree(
            f"{tag} marker vs auto", out[fn, kind, mode, "marker"],
            out[fn, kind, mode, "auto"], 1e-3,
            lambda: (geyer_stop_pairs(proxy, "direct_kernel", maxlag),
                     geyer_stop_pairs(proxy, "kernel", maxlag)),
            None if q is None else lambda: (
                interval_ranks(x3, q, mode, marker)(),
                interval_ranks(x3, q, mode, "auto")()))
    fast_dev = {}
    for fn, kind in estimator_calls():
        quantile_mcse = mcse_quantile_p(fn, kind) is not None
        fast_dev[f"{fn}_{kind}"] = check_agree(
            f"[6 {fn} {kind!r}] fast vs exact", out[fn, kind, "fast", "marker"],
            out[fn, kind, "exact", "marker"],
            MCSE_Q_FAST_BOUND if quantile_mcse else 1e-2,
            lambda: (geyer_stop_pairs(call_proxy(x3, fn, kind, "fast"),
                                      "direct_kernel", maxlag),
                     geyer_stop_pairs(call_proxy(x3, fn, kind, "exact"),
                                      "direct_kernel", maxlag)))

    Q99 = mtt.Quantile(0.99)
    walls = {}
    for name, fn, kw in (
            ("mcse_mean", mtt.mcse, dict(kind="mean")),
            ("mcse_q99_exact", mtt.mcse, dict(kind=Q99)),
            ("mcse_q99_fast", mtt.mcse, dict(kind=Q99, rank_mode="fast")),
            ("ess_mad_fast", mtt.ess, dict(kind="mad", rank_mode="fast"))):
        for tag, meth in (("marker", marker), ("auto", "auto")):
            walls[f"{name}_{tag}_s"] = wall_s(
                lambda: fn(x3, autocov_method=meth, **kw))
        print(f"[6 wall] {name}: marker {walls[f'{name}_marker_s']:.4f} s, "
              f"auto {walls[f'{name}_auto_s']:.4f} s (median of 3)")
    return {"k5_launches": marker_counts["K5"], "walls": walls,
            "fast_vs_exact_max_rel_dev": fast_dev}


def phase_estimators_card_vs_cpu() -> None:
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    rng = np.random.default_rng(SEED + 2)
    x_cpu = torch.from_numpy(ar1(rng, 0.5, (2000, 32, 64)))
    x_gpu = x_cpu.cuda()
    marker = mtt.DirectKernelAutocovMethod()
    maxlag = min(250, 2000 // 2 - 4)
    for fn, kind in estimator_calls():
        for mode in ("exact", "fast"):
            g = getattr(mtt, fn)(x_gpu, kind=kind, rank_mode=mode,
                                 autocov_method=marker)
            c = getattr(mtt, fn)(x_cpu, kind=kind, rank_mode=mode,
                                 autocov_method=marker)
            q = mcse_quantile_p(fn, kind)
            check_agree(
                f"[6 {fn} {kind!r} {mode}] card vs CPU", g, c, 1e-3,
                lambda: tuple(geyer_stop_pairs(call_proxy(x, fn, kind, mode),
                                               "direct_kernel", maxlag)
                              for x in (x_gpu, x_cpu)),
                None if q is None else lambda: tuple(
                    interval_ranks(x, q, mode, marker)()
                    for x in (x_gpu, x_cpu)))
    check_agree("[6 mcse SBM w.mean()] card vs CPU",
                mtt.mcse(x_gpu, kind=lambda w: w.mean()),
                mtt.mcse(x_cpu, kind=lambda w: w.mean()), 1e-3)
    ids = np.arange(32) % 4  # 4 superchains of 8 chains
    for kind in ("rank", "bulk", "tail", "basic"):
        d = float((mtt.rhat_nested(x_gpu, ids, kind=kind).cpu()
                   - mtt.rhat_nested(x_cpu, ids, kind=kind)).abs().max())
        print(f"   [6 rhat_nested {kind}] card vs CPU: abs {d:.3e} (bound 1e-4)")
        check(d <= 1e-4, f"rhat_nested {kind}: card != CPU")
    # float32 sums of 2000 terms in another order: relative 1e-5
    energy = x_cpu[:, :, 0] * 3.0 + 10.0
    check_agree("[6 bfmi] card vs CPU", mtt.bfmi(energy.cuda()),
                mtt.bfmi(energy), 1e-5)


# ---- phase 7: K4's fused z mode and the FUSE_BLOM_Z route ------------------

# K4's z mode against its plain version, in float32 ULPs of z: both read
# identical ranks and evaluate the same AS241 polynomial with the same
# round-to-nearest operations, so they are equal where the kernel's logf and
# PyTorch's come from one toolkit; a logf of another toolkit version may move
# z by an ULP or two
Z_MODE_ULPS = 4


def max_ulp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| in float32 ULPs of ``b`` over entries where neither is
    NaN (NaN masks must agree). Two float32 values within a factor 2 of each
    other subtract exactly, and an ULP is a power of 2."""
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN positions differ")
    ok = ~torch.isnan(b)
    w = b[ok].abs()
    ulp = torch.nextafter(w, torch.full_like(w, math.inf)) - w
    return float(((a[ok] - b[ok]).abs() / ulp).max()) if ok.any() else 0.0


def phase_fused_z(x3: torch.Tensor) -> dict:
    """K4's z mode at (1.28M, 256) with 4096 bins against its plain version,
    then the fast ``ess_rhat`` with ``FUSE_BLOM_Z`` off and on."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch import kernels
    from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as fr
    from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as ofr

    xf = with_bad_columns(x3).reshape(-1, PARAMS)
    n = xf.shape[0]
    cdf = ofr.build_hist_cdf(xf, NBINS)
    scale = ofr._hist_scale(cdf.lo, cdf.hi, NBINS)
    args = (xf, cdf.lo, scale, cdf.tab, NBINS)
    z_k = fr.rank_lookup(*args, blom_n=n)
    z_p = fr.rank_lookup_plain(*args, blom_n=n)
    err, ulps = max_abs_err(z_k, z_p), max_ulp_err(z_k, z_p)
    # with the constant column filled and the NaN column masked in the kernel
    extras = dict(fill=torch.full_like(cdf.lo, torch.nan).masked_fill(
        cdf.hi <= cdf.lo, 0.0), bad=cdf.bad)
    z_k = fr.rank_lookup(*args, blom_n=n, **extras)
    z_p = fr.rank_lookup_plain(*args, blom_n=n, **extras)
    check(bool(torch.isnan(z_k[:, 1]).all()) and not bool(z_k[:, 2].any()),
          "K4's z mode did not write the NaN and the constant column")
    ulps = max(ulps, max_ulp_err(z_k, z_p))
    del z_k, z_p
    ms = time_ms(lambda: fr.rank_lookup(*args, blom_n=n))
    plain_ms = time_ms(lambda: fr.rank_lookup_plain(*args, blom_n=n))
    rank_ms = time_ms(lambda: fr.rank_lookup(*args))
    print(f"[7 K4z rank_lookup z mode] max abs err in z {err:.3e}, max "
          f"{ulps:g} float32 ULP (bound {Z_MODE_ULPS}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; rank mode {rank_ms:.3f} ms")
    check(ulps <= Z_MODE_ULPS, "K4's z mode disagrees with its plain version")

    def run(fused: bool):
        old, ofr.FUSE_BLOM_Z = ofr.FUSE_BLOM_Z, fused
        try:
            return mtt.ess_rhat(x3, kind="rank", rank_mode="fast")
        finally:
            ofr.FUSE_BLOM_Z = old

    kernels.reset_launch_counts()
    fused = run(True)
    torch.cuda.synchronize()
    counts_on = kernels.launch_counts()
    kernels.reset_launch_counts()
    unfused = run(False)
    torch.cuda.synchronize()
    counts_off = kernels.launch_counts()
    print(f"[7 launches] FUSE_BLOM_Z on {counts_on}; off {counts_off}")
    check(counts_on["K4z"] == 2 and counts_on["K4"] == 2,
          "the fused route did not run K4's z mode for bulk and fold")
    check(counts_off["K4z"] == 0, "K4's z mode ran with FUSE_BLOM_Z off")
    for v in (*fused, *unfused):
        check(v.shape == (PARAMS,) and bool(torch.isfinite(v).all()),
              "bad ESS or R-hat shape or value")
    ess_rel = float((fused.ess / unfused.ess - 1).abs().max())
    rhat_abs = float((fused.rhat - unfused.rhat).abs().max())
    print(f"[7 fused vs unfused] ESS rel {ess_rel:.3e} (bound 1e-3), R-hat abs "
          f"{rhat_abs:.3e} (bound 1e-4)")
    check(ess_rel <= 1e-3 and rhat_abs <= 1e-4, "fused route != unfused")
    # in turns: off, on, on, off
    walls = {"off": [], "on": []}
    for fused_flag in (False, True, True, False):
        walls["on" if fused_flag else "off"].append(
            wall_s(lambda: run(fused_flag)))
    out = {f"wall_fast_fuse_{k}_s": statistics.median(v) for k, v in walls.items()}
    print(f"[7 wall] fast ess_rhat, FUSE_BLOM_Z off {walls['off']} s, on "
          f"{walls['on']} s (each a median of 3)")
    return {"row": dict(err=err, ms=ms, plain_ms=plain_ms, max_ulp=ulps,
                        rank_mode_ms=rank_ms,
                        **roofline(8.0 * n * PARAMS + 12.0 * NBINS * PARAMS)),
            "launches": counts_on["K4z"], "walls": out,
            "fused_vs_unfused": {"ess_rel": ess_rel, "rhat_abs": rhat_abs}}


# ---- phase 8: the classical suite ------------------------------------------

CLASSICAL = ("gelmandiag", "gelmandiag_multivariate", "gewekediag",
             "heideldiag", "rafterydiag")


def measure_call(tag: str, fn, x, k5_must_run: bool):
    """One call with its K5 launches and peak device memory (above what was
    allocated before it), then the median wall of 3 more."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = fn(x)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    k5 = kernels.launch_counts()["K5"]
    if k5_must_run:
        check(k5 >= 1, f"{tag}: K5 did not run")
    wall = wall_s(lambda: fn(x))
    print(f"[8 {tag}] wall {wall * 1e3:.2f} ms (median of 3), peak +{peak_gb:.3f} "
          f"GB, K5 launches {k5}")
    return res, {"wall_s": wall, "peak_gb": peak_gb, "k5": k5}


def check_classical(tag: str, name: str, res, shape) -> None:
    """Finite values of the expected shapes on the card (the multivariate
    PSRF: a finite Python float); the samples hold no NaN."""
    for field, v in zip(res._fields, res):
        if isinstance(v, float):
            check(math.isfinite(v), f"{tag} {name}.{field} is not finite")
            continue
        check(tuple(v.shape) == shape and v.device.type == "cuda",
              f"{tag} {name}.{field}: shape {tuple(v.shape)} on {v.device}")
        check(bool(torch.isfinite(v.double()).all()), f"{tag} {name}.{field} "
              "not finite")


def phase_classical(x3: torch.Tensor, bad_param: int) -> dict:
    """K5 on the flagship sample's Heidelberger and Geweke window stacks
    against its plain version, the five classical functions on BASELINE.md
    config 3 (10k x 8 x 100), and Geweke/Heidelberger/Raftery and the PSRF
    on the flagship sample."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics import batch
    from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5

    # K5 on the masked (n, 1, W S) stacks that heideldiag (6 windows,
    # 196,608 series) and gewekediag (2 windows) build from the flagship
    # sample, at maxlag 250; errors relative to the largest lag-0 sum / n
    out = {}
    flat, _ = batch._series_matrix(x3)
    stop1, start2 = batch._geweke_windows(DRAWS, 0.1, 0.5)
    for name, windows in (
            ("heideldiag", batch._heidel_windows(
                DRAWS, batch._heidel_starts(DRAWS)[0])),
            ("gewekediag", [(0, stop1), (start2, DRAWS)])):
        z, _ = batch._masked_window_stack(flat, windows)
        k = k5.direct_autocov(z, 250)
        p = k5.direct_autocov_plain(z, 250)
        torch.cuda.synchronize()
        err = max_abs_err(k, p) / float(p[0].max())
        ms = time_ms(lambda: k5.direct_autocov(z, 250), reps=1, warmup=False)
        plain_ms = time_ms(lambda: k5.direct_autocov_plain(z, 250), reps=1,
                           warmup=False)
        bnd = lag_bound(z.shape[0], z.shape[2], 250)
        print(f"[8 K5 on the {name} stack {tuple(z.shape)}] max abs err "
              f"relative to the largest variance {err:.3e} (bound 1e-5); "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}): "
              f"{bnd['bound_ms'] / ms:.1%} of the float32 peak")
        check(err <= 1e-5, f"K5 disagrees with its plain version on the "
              f"{name} window stack")
        out[f"k5_{name}_stack"] = {"series": z.shape[2], "err_rel_var": err,
                                   "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bnd["bound_ms"]}
        del z, k, p
    rng = np.random.default_rng(SEED + 3)
    cfg3 = torch.from_numpy(ar1(rng, 0.5, (10_000, 8, 100))).cuda()
    print("[8 config 3] AR(1) phi=0.5 10000x8x100 f32 on the card")
    for name in CLASSICAL:
        res, m = measure_call(f"config3 {name}", getattr(mtt, name), cfg3,
                              name in ("gewekediag", "heideldiag"))
        shape = (100,) if name.startswith("gelman") else (8, 100)
        check_classical("config3", name, res, shape)
        out[f"config3_{name}"] = m
    for name in ("gelmandiag", "gewekediag", "heideldiag", "rafterydiag"):
        res, m = measure_call(f"flagship {name}", getattr(mtt, name), x3,
                              name in ("gewekediag", "heideldiag"))
        shape = (PARAMS,) if name.startswith("gelman") else (CHAINS, PARAMS)
        check_classical("flagship", name, res, shape)
        if name == "gelmandiag":
            psrf = res.psrf
            rest = float(psrf[torch.arange(PARAMS, device="cuda") != bad_param].max())
            print(f"   PSRF of the shifted parameter {float(psrf[bad_param]):.4f}; "
                  f"max of the others {rest:.4f}")
            check(float(psrf[bad_param]) > 1.1 and rest < 1.1,
                  "badly mixed parameter not flagged by the PSRF")
        out[f"flagship_{name}"] = m
    return out


def phase_classical_card_vs_cpu() -> None:
    """Card against CPU at 2000 x 8 x 16 (Raftery with r = 0.01, nmin 937):
    Geweke z within 1e-3 abs + rel; Heidelberger p-values 1e-4 abs, decisions
    equal except series at a threshold (printed); Raftery's run lengths
    equal, its dependence factor within 1 float64 ULP; PSRF 1e-4 relative.
    1-d input (one series) alike."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    rng = np.random.default_rng(SEED + 4)
    x_np = ar1(rng, 0.5, (2000, 8, 16)) + np.float32(3.0)
    x_np[:400, 0, 0] += 2.0  # a transient
    x_cpu = torch.from_numpy(x_np)
    x_gpu = x_cpu.cuda()

    def as_t(v):  # a result field (tensor or Python scalar) on the host
        return torch.as_tensor(v).double().cpu()

    for xg, xc, tag in ((x_gpu, x_cpu, "N-d"),
                        (x_gpu[:, 0, 0], x_cpu[:, 0, 0], "1-d")):
        g, c = mtt.gewekediag(xg), mtt.gewekediag(xc)
        dz = (as_t(g.zscore) - as_t(c.zscore)).abs()
        bound = 1e-3 + 1e-3 * as_t(c.zscore).abs()
        print(f"[8 card vs CPU {tag}] Geweke z max abs {float(dz.max()):.3e}")
        check(bool((dz <= bound).all()), f"{tag} Geweke z: card != CPU")

        g, c = mtt.heideldiag(xg), mtt.heideldiag(xc)
        dp = (as_t(g.pvalue) - as_t(c.pvalue)).abs()
        print(f"[8 card vs CPU {tag}] Heidelberger p-value max abs "
              f"{float(dp.max()):.3e}")
        check(bool((dp <= 1e-4).all()),
              f"{tag} Heidelberger p-value: card != CPU")
        ratio = as_t(c.halfwidth) / as_t(c.mean).abs()
        near = (((as_t(c.pvalue) - 0.05).abs() <= 1e-4)
                | ((ratio - 0.1).abs() <= 1e-3))
        for field in ("burnin", "stationarity", "test"):
            diff = as_t(getattr(g, field)) != as_t(getattr(c, field))
            for j in torch.nonzero(diff.reshape(-1)).flatten().tolist():
                print(f"   {tag} {field} differs at series {j}: p-value "
                      f"{float(as_t(c.pvalue).reshape(-1)[j]):.6f}, halfwidth "
                      f"ratio {float(ratio.reshape(-1)[j]):.6f}")
            check(not bool((diff & ~near).any()),
                  f"{tag} Heidelberger {field} differs off the thresholds")

        g, c = mtt.rafterydiag(xg, r=0.01), mtt.rafterydiag(xc, r=0.01)
        for field in g._fields:
            a, b = as_t(getattr(g, field)), as_t(getattr(c, field))
            rtol = 2.0 ** -52 if field == "dependencefactor" else 0.0  # 1 ULP
            check(torch.equal(torch.isnan(a), torch.isnan(b))
                  and bool((((a - b).abs() <= rtol * b.abs())
                            | torch.isnan(b)).all()),
                  f"{tag} Raftery {field}: card != CPU")
        print(f"[8 card vs CPU {tag}] Raftery run lengths equal, dependence "
              "factor within 1 ULP")
    g, c = mtt.gelmandiag_multivariate(x_gpu), mtt.gelmandiag_multivariate(x_cpu)
    worst = max(float((a.cpu().double() / b.double() - 1).abs().max())
                for a, b in zip(g[:2], c[:2]))
    worst = max(worst, abs(g.psrfmultivariate / c.psrfmultivariate - 1))
    print(f"[8 card vs CPU] PSRF max rel {worst:.3e} (bound 1e-4)")
    check(worst <= 1e-4, "PSRF: card != CPU")


# ---- phases 9 and 10: the kernel studies ------------------------------------

# 32-bit operations a second outside the tensor cores (the float32 rate
# counts an FMA twice)
ALU_OPS = F32_FLOPS / 2


def ptxas_lines(build_log: str, kernel: str) -> str:
    """Registers and spills that ptxas reported for ``kernel``; the library
    is built in the same run unless a build directory was left behind."""
    lines, keep = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    return "; ".join(lines) if lines else "not available (cached build)"


def phase_lagloop(build_log: str) -> dict:
    """K6 through ``benchmarks.micro_lagloop``: variant A (the first form of
    the lag loop) and variant B (the loop K1 and K5 run) at the study's size
    and at K5's flagship shape, each against the plain version and against
    each other."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import micro_lagloop as ml
    from mcmcdiagnostictools_jl_tpu_torch.kernels import lagloop_study as ls

    regs_b = ptxas_lines(build_log, "lagloop_b_kernelILi32E")
    print(f"[9 K6b build] {regs_b}")
    rows = {v: {"err": 0.0} for v in ls.VARIANTS}
    launches = dict.fromkeys(ls.VARIANTS, 0)
    # the study's own size, then the split flagship sample's 65,536 series
    for series, sfx in ((ml.SERIES, ""), (2 * CHAINS * PARAMS, "_65536")):
        x = ml.make_input(SEED + 6, series=series)
        kernels.reset_launch_counts()
        outs, ms = {}, {}
        for v in ls.VARIANTS:
            outs[v], t = ml.run(v, x)
            ms[v] = t["ms"]
        counts = kernels.launch_counts()
        plain = ls.lag_products_plain(x, ml.MAXLAG)
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: ls.lag_products_plain(x, ml.MAXLAG),
                           reps=1, warmup=False)
        scale = float(plain[0].max())
        ab = max_abs_err(outs["a"], outs["b"]) / scale
        bnd = lag_bound(ml.NITER, series, ml.MAXLAG)
        for v in ls.VARIANTS:
            check(outs[v].shape == (ml.MAXLAG + 1, series), "K6: bad shape")
            err = max_abs_err(outs[v], plain)
            print(f"[9 K6{v} lag_products ({ml.NITER}, {series}), maxlag "
                  f"{ml.MAXLAG}] max abs err {err:.3e}, relative to the "
                  f"largest c_0 {err / scale:.3e} (bound {LAG_REL_BOUND:.0e}); "
                  f"kernel {ms[v]:.3f} ms, plain {plain_ms:.1f} ms, bound "
                  f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}): "
                  f"{bnd['bound_ms'] / ms[v]:.1%} of the float32 peak")
            check(err / scale <= LAG_REL_BOUND,
                  f"K6{v} disagrees with its plain version")
            rows[v]["err"] = max(rows[v]["err"], err)
            rows[v].update({"ms" + sfx: ms[v], "plain_ms" + sfx: plain_ms,
                            "bound_ms" + sfx: bnd["bound_ms"]})
            launches[v] += counts["K6" + v]
            check(counts["K6" + v] >= 1, f"K6{v} did not launch")
        rows["a"]["bound_by"] = rows["b"]["bound_by"] = bnd["bound_by"]
        print(f"   A against B: {ab:.3e} of the largest c_0 (bound "
              f"{LAG_REL_BOUND:.0e}); B is {ms['a'] / ms['b']:.2f}x A")
        check(ab <= LAG_REL_BOUND, "K6's variants disagree")
        del x, outs, plain
    rows["b"]["ptxas"] = regs_b
    return {"rows": rows, "launches": launches}


def phase_sort_study(build_log: str) -> dict:
    """K7, K8 and K9 through ``benchmarks.sort_microbench`` at 512 tiles of
    2048 rows x 128 columns (1.07 GB of keys and payload); K9 also at pods
    smaller than a chunk and column counts off the 8-column block."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import sort_microbench as sm
    from mcmcdiagnostictools_jl_tpu_torch.kernels import sort_study as ss

    ntiles, seed = 512, SEED + 7
    keys, payload = sm.make_arrays(ntiles, seed)
    moved = 2 * keys.numel() * 8  # both arrays read once and written once
    pass_bound = roofline(moved)
    want = ss.pass_plain(keys, payload, 16, 1)
    plain_ms = time_ms(lambda: ss.pass_plain(keys, payload, 16, 1))

    def add_(k, p):
        k.add_(1.0)
        p.add_(1)

    library_ms = time_ms(add_, setup=lambda: (keys.clone(), payload.clone()))
    print(f"[10 data] {keys.shape[0]} x {keys.shape[1]} float32 keys (uniform, "
          f"seed {seed}) + int32 payload, {keys.numel() * 8 / 1e9:.2f} GB; one "
          f"pass moves {moved / 1e9:.2f} GB, bound {pass_bound['bound_ms']:.3f} "
          f"ms; plain (keys + 1, payload + 1) {plain_ms:.3f} ms, add_ in place "
          f"{library_ms:.3f} ms")
    out = {}
    kernels.reset_launch_counts()
    runs = [("K7", f"pods {k} stride {s}", lambda k=k, s=s:
             sm.bench_dma_pass(ntiles, k, s, seed=seed))
            for k, s in ((16, 1), (16, 16), (8, 64))]
    runs += [("K8", f"pods {k}", lambda k=k:
              sm.bench_dma_contig(ntiles, k, seed=seed)) for k in (16, 4)]
    for kid, setting, run in runs:
        (k_out, p_out), t = run()
        torch.cuda.synchronize()
        same = torch.equal(k_out, want[0]) and torch.equal(p_out, want[1])
        print(f"[10 {kid} {setting}] equal to the plain version: {same}; "
              f"{t['ms']:.3f} ms, {t['gbps']:.0f} GB/s, "
              f"{t['gbps'] * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")
        check(same, f"{kid} ({setting}) differs from its plain version")
        row = out.setdefault(kid, dict(err=0.0, ms=t["ms"], plain_ms=plain_ms,
                                       library_ms=library_ms, **pass_bound,
                                       settings={}))
        row["settings"][setting] = {"ms": t["ms"], "gbps": t["gbps"]}
        del k_out, p_out
    counts = kernels.launch_counts()
    del want

    # K9: operations = 5 a compare-exchange (a compare, four selects)
    regs_k9 = ptxas_lines(build_log, "sort_chunk_kernel")
    print(f"[10 K9 build] chunk kernel: {regs_k9}; wide pass of 5 strides: "
          f"{ptxas_lines(build_log, 'sort_wide_kernelILi5E')}")
    gen = torch.Generator().manual_seed(seed)
    for rows, cols, pod_rows in ((96, 12, 32), (48, 4, 8), (1536, 20, 512),
                                 (8192, 12, 4096)):
        k = torch.randperm(rows * cols, generator=gen).float().reshape(
            rows, cols).cuda()
        p = torch.arange(rows * cols, dtype=torch.int32,
                         device="cuda").reshape(rows, cols)
        k_plain, p_plain = ss.bitonic_pod_sort_plain(k, p, pod_rows)
        k_lib = torch.sort(k.reshape(-1, pod_rows, cols), dim=1).values
        ss.bitonic_pod_sort(k, p, pod_rows)
        torch.cuda.synchronize()
        pods = k.reshape(-1, pod_rows, cols)
        same = (torch.equal(k, k_plain) and torch.equal(p, p_plain)
                and torch.equal(pods[0::2], k_lib[0::2])
                and torch.equal(pods[1::2], k_lib[1::2].flip(1)))
        print(f"[10 K9 {rows} x {cols}, pods of {pod_rows}] keys and payload "
              f"equal to the plain network and to torch.sort: {same}")
        check(same, f"K9 ({rows} x {cols}, pods of {pod_rows}) is wrong")
    kernels.reset_launch_counts()
    for pod_tiles, sfx in ((8, ""), (16, "_pod32768")):
        pod_rows = pod_tiles * sm.TILE
        (k_out, p_out), t = sm.bench_phase_a(ntiles, pod_tiles, seed=seed)
        t0 = time.perf_counter()
        k_plain, p_plain = ss.bitonic_pod_sort_plain(keys, payload, pod_rows)
        torch.cuda.synchronize()
        plain_k9_ms = (time.perf_counter() - t0) * 1e3
        keys_same = torch.equal(k_out, k_plain)
        payload_same = torch.equal(p_out, p_plain)
        consistent = torch.equal(keys.reshape(-1)[p_out.long()], k_out)
        del k_plain, p_plain
        (k_lib, _), t_lib = sm.bench_sort(ntiles, pod_tiles, seed=seed)
        pods = (-1, 2, pod_rows, keys.shape[1])
        lib_same = torch.equal(k_out.reshape(pods)[:, 0],
                               k_lib.reshape(pods)[:, 0])
        ops = 5.0 * t["stages"] * keys.numel() / 2
        bnd = {"bound_ms": max(moved / HBM_BYTES_PER_S, ops / ALU_OPS) * 1e3,
               "bound_by": ("bytes" if moved / HBM_BYTES_PER_S >= ops / ALU_OPS
                            else "operations")}
        print(f"[10 K9 pods of {pod_rows} rows, {t['stages']} stages] keys "
              f"equal to the plain network: {keys_same}, payload equal: "
              f"{payload_same}, payload consistent with the keys: "
              f"{consistent}, ascending pods equal to torch.sort: {lib_same}; "
              f"kernel {t['ms']:.3f} ms, plain {plain_k9_ms:.1f} ms (one call), "
              f"torch.sort + gather {t_lib['ms']:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
        check(keys_same and payload_same and consistent and lib_same,
              f"K9 (pods of {pod_rows}) is wrong")
        row = out.setdefault("K9", dict(err=0.0, ptxas=regs_k9, **bnd))
        row.update({"ms" + sfx: t["ms"], "plain_ms" + sfx: plain_k9_ms,
                    "library_ms" + sfx: t_lib["ms"],
                    "bound_ms" + sfx: bnd["bound_ms"]})
        del k_out, p_out, k_lib
    counts.update({"K9": kernels.launch_counts()["K9"]})
    for kid in ("K7", "K8", "K9"):
        check(counts[kid] >= 1, f"{kid} did not launch")
    return {"rows": out,
            "launches": {kid: counts[kid] for kid in ("K7", "K8", "K9")}}


# ---- phase 11: out of core ---------------------------------------------------

CONFIG4_PARAMS = 1000
# peak device memory of the resident fast call above its sample (PERF.md,
# where the time goes): what one chunk's pipeline may take
PIPELINE_PEAK_GB = 6.72


def config4_host_sample(x3: torch.Tensor) -> torch.Tensor:
    """BASELINE.md config 4 on the host, (10k, 128, 1000) float32: the first
    256 parameters are the resident sample; each further block of 256 (the
    last: 232) is that sample rolled along the draws by a seeded shift and
    scaled by a seeded factor, so every block keeps the shifted chains of its
    first parameter."""
    rng = np.random.default_rng(SEED + 5)
    xh = x3.cpu()
    host = torch.empty((DRAWS, CHAINS, CONFIG4_PARAMS), dtype=torch.float32)
    host[:, :, :PARAMS] = xh
    for lo in range(PARAMS, CONFIG4_PARAMS, PARAMS):
        w = min(PARAMS, CONFIG4_PARAMS - lo)
        shift = int(rng.integers(500, DRAWS - 500))
        scale = float(rng.uniform(0.5, 2.0))
        host[:DRAWS - shift, :, lo:lo + w] = xh[shift:, :, :w]
        host[DRAWS - shift:, :, lo:lo + w] = xh[:shift, :, :w]
        host[:, :, lo:lo + w] *= scale
    return host


def phase_streaming(x3: torch.Tensor, resident_fast, resident_exact) -> dict:
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch import kernels

    t0 = time.perf_counter()
    host = config4_host_sample(x3).numpy()
    print(f"[11 data] config 4 on the host: {host.shape} float32, "
          f"{host.nbytes / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s (the "
          "resident sample and three rolled, scaled copies of it)")
    chunk_gb = DRAWS * CHAINS * PARAMS * 4 / 1e9
    t0 = time.perf_counter()
    np.ascontiguousarray(host[:, :, :PARAMS])
    naive_s = time.perf_counter() - t0
    print(f"[11 gather] np.ascontiguousarray of one chunk ({chunk_gb:.2f} GB, "
          f"a strided slice) on one core: {naive_s:.3f} s")

    def run(source):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res, stats = mtt.ess_rhat_streaming(source, param_chunk=PARAMS,
                                            return_stats=True)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        return res, stats, kernels.launch_counts(), peak

    _, stats2, _, peak2 = run(host[:, :, :2 * PARAMS])
    cold_wall = None
    for _ in range(2):  # the first run of this size also pins its buffers
        res, stats, counts, peak = run(host)
        cold_wall = stats.wall_s if cold_wall is None else cold_wall
    n = stats.n_chunks
    print(f"[11 launches] {n} chunks: {counts}")
    check(n == 4, f"expected 4 chunks, got {n}")
    check(counts["K1"] >= n and counts["K2"] == n and counts["K3"] == 2 * n
          and counts["K4"] == 2 * n, "K1-K4 did not launch in every chunk")
    for v in res:
        check(v.shape == (CONFIG4_PARAMS,) and v.device.type == "cuda",
              f"bad output shape/device {tuple(v.shape)} {v.device}")
        check(bool(torch.isfinite(v).all()), "non-finite ESS or R-hat")
    # the same kernels on the same columns: only reductions tiled for
    # another width differ (K3 adds whole numbers: the same every run)
    ess_rel = float((res.ess[:PARAMS] / resident_fast.ess - 1).abs().max())
    rhat_abs = float((res.rhat[:PARAMS] - resident_fast.rhat).abs().max())
    print(f"[11 streamed vs resident, first {PARAMS} parameters] ESS rel "
          f"{ess_rel:.3e} (bound 1e-5), R-hat abs {rhat_abs:.3e} (bound 1e-6)")
    check(ess_rel <= 1e-5 and rhat_abs <= 1e-6, "streamed != resident")
    flagged = [float(res.rhat[j]) for j in range(0, CONFIG4_PARAMS, PARAMS)]
    rest = res.rhat.clone()
    rest[::PARAMS] = 0
    print(f"[11 mixing] R-hat of each block's shifted parameter {flagged}; "
          f"max of the others {float(rest.max()):.4f}")
    check(min(flagged) > 1.1 and float(rest.max()) < 1.1,
          "badly mixed parameters not flagged")
    limit = 3 * chunk_gb + PIPELINE_PEAK_GB
    print(f"[11 memory] peak +{peak:.3f} GB with 4 chunks, +{peak2:.3f} GB "
          f"with 2 (limit {limit:.2f} GB: three chunks + the pipeline's "
          f"{PIPELINE_PEAK_GB} GB)")
    check(peak <= limit, "peak device memory above three chunks + pipeline")
    check(peak <= peak2 + 0.1, "peak device memory grows with the chunks")
    sums = {k: sum(getattr(stats, k)) for k in
            ("fetch_s", "h2d_s", "compute_s", "wait_s")}
    ratio = stats.wall_s / max(sums["fetch_s"], sums["h2d_s"],
                               sums["compute_s"])
    print(f"[11 wall] {stats.wall_s:.3f} s (first run {cold_wall:.3f} s; 2 "
          f"chunks {stats2.wall_s:.3f} s); sums: gather {sums['fetch_s']:.3f}, "
          f"copy {sums['h2d_s']:.3f} ({host.nbytes / 1e9 / sums['h2d_s']:.1f} "
          f"GB/s), compute {sums['compute_s']:.3f}, host blocked "
          f"{sums['wait_s']:.3f} s; wall / largest sum = {ratio:.2f}, wall / "
          f"all three = "
          f"{stats.wall_s / (sums['fetch_s'] + sums['h2d_s'] + sums['compute_s']):.2f}")
    print(f"   per chunk: gather {[round(v, 3) for v in stats.fetch_s]}, copy "
          f"{[round(v, 3) for v in stats.h2d_s]}, compute "
          f"{[round(v, 3) for v in stats.compute_s]}")

    kernels.reset_launch_counts()
    exact = mtt.ess_rhat_streaming(host[:, :, :PARAMS], rank_mode="exact",
                                   param_chunk=64)
    torch.cuda.synchronize()
    check(kernels.launch_counts()["K1"] >= 4, "K1 did not run in every chunk")
    ess_rel_x = float((exact.ess / resident_exact.ess - 1).abs().max())
    rhat_abs_x = float((exact.rhat - resident_exact.rhat).abs().max())
    print(f"[11 exact mode, chunks of 64, vs resident] ESS rel {ess_rel_x:.3e} "
          f"(bound 1e-5), R-hat abs {rhat_abs_x:.3e} (bound 1e-6)")
    check(ess_rel_x <= 1e-5 and rhat_abs_x <= 1e-6,
          "streamed exact mode != resident")
    return {"host": host, "result": res,
            "wall_s": stats.wall_s, "first_run_wall_s": cold_wall,
            "wall_2_chunks_s": stats2.wall_s, **{"sum_" + k: v
                                                 for k, v in sums.items()},
            "wall_over_largest_sum": ratio, "peak_gb": peak,
            "peak_2_chunks_gb": peak2, "naive_gather_one_chunk_s": naive_s,
            "launches": counts,
            "streamed_vs_resident": {"ess_rel": ess_rel, "rhat_abs": rhat_abs,
                                     "exact_ess_rel": ess_rel_x,
                                     "exact_rhat_abs": rhat_abs_x}}


# ---- phases 12-15: discretediag, R*, float64 on the card --------------------


class CallTimer:
    """Wraps a module function for one phase: counts its calls and sums its
    wall time (synchronising the card around each call); put back by
    ``restore``. The module's callers find it through the module's
    namespace, so the wrapper sees every call they make."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.seconds = 0, 0.0

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        setattr(module, name, timed)

    def reset(self) -> None:
        self.calls, self.seconds = 0, 0.0

    def restore(self) -> None:
        setattr(self.module, self.name, self.orig)


def rel_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max relative deviation of ``a`` from ``b`` (float64, on the host) over
    entries where neither is NaN; NaN masks must agree."""
    a, b = a.double().cpu(), b.double().cpu()
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN positions differ")
    ok = ~torch.isnan(a) & (a != b)
    return float(((a[ok] - b[ok]).abs() / b[ok].abs()).max()) if ok.any() else 0.0


DISCRETE_METHODS = ("weiss", "hangartner", "billingsley", "DARBOOT", "MCBOOT",
                    "billingsleyBOOT")
# the bootstraps' df and p-values against the CPU's on the first parameters
# (each test depends on its own parameter only): on the same side of 0.05
# wherever the CPU's p lies more than three Monte Carlo standard errors from
# it, df within 15 % (the margins of tests/test_torch_discretediag.py)
BOOT_CPU_PARAMS = 4
P_MARGIN = 3 * math.sqrt(0.05 * 0.95 / 1000)


def boot_vs_cpu(method: str, part: str, g, c) -> tuple[int, float]:
    """Side-of-0.05 disagreements and the largest relative df deviation of
    the card's bootstrap ``g`` (every parameter) from the CPU's ``c`` (the
    first ``BOOT_CPU_PARAMS``), both at nsim=1000."""
    gp, gd = g.pvalue[:BOOT_CPU_PARAMS].cpu(), g.df[:BOOT_CPU_PARAMS].cpu()
    clear = (c.pvalue - 0.05).abs() > P_MARGIN
    flips = int(((gp < 0.05) != (c.pvalue < 0.05))[clear].sum())
    df_rel = float(((gd - c.df).abs() / c.df.abs()).max())
    check(flips == 0, f"{method} {part}: {flips} p-values on the other side "
          "of 0.05 from the CPU's")
    check(df_rel <= 0.15, f"{method} {part}: df {df_rel:.3f} from the CPU's")
    return flips, df_rel


def phase_discretediag() -> dict:
    """BASELINE.md config 3 (benchmarks/suite.py: a seeded standard-normal
    10k x 8 x 100 float32 sample digitized at -1, 0, 1) through all six
    methods at nsim=1000 on the card. The chi-squared methods against the
    port's CPU path (stat, df, p within 1e-9 relative); the bootstrap
    methods' statistic against the CPU's (it does not depend on the draws:
    nsim=1 there; 1e-12 relative, float64 sums of a few terms in another
    order), their df finite and p-values in [0, 1], and df and p-values
    against the CPU's at nsim=1000 on the first parameters (``boot_vs_cpu``);
    MCBOOT's NaN statistic and 0.0 p-value; a chain drawn from other category probabilities flagged
    by weiss and billingsley at p < 1e-3. Walls, and for the bootstrap
    methods the share of the wall spent in the loop over draws."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics import discretediag as dd

    rng = np.random.default_rng(0)
    z = rng.standard_normal((10_000, 8, 100)).astype(np.float32)
    cats = np.digitize(z, [-1.0, 0.0, 1.0]).astype(np.float32)
    x_cpu = torch.from_numpy(cats)
    x_gpu = x_cpu.cuda()
    print("[12 data] config 3 digitized at -1, 0, 1: 10000x8x100, 4 "
          "categories, on the card")
    mtt.discretediag(x_gpu)  # first use of these PyTorch ops on the card
    loop = CallTimer(dd, "_draw_loop")
    out = {}
    try:
        for method in DISCRETE_METHODS:
            loop.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mtt.discretediag(x_gpu, method=method, nsim=1000, rng=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            loop_s, loop_calls = loop.seconds, loop.calls
            boot = method.endswith("BOOT")
            share = loop_s / wall
            cpu = mtt.discretediag(x_cpu, method=method, nsim=1 if boot else
                                   1000, rng=0)
            if boot:
                t1 = time.perf_counter()
                cpu_slice = mtt.discretediag(x_cpu[:, :, :BOOT_CPU_PARAMS],
                                             method=method, nsim=1000, rng=0)
                cpu_slice_s = time.perf_counter() - t1
            for part, shape in (("between_chain", (100,)),
                                ("within_chain", (100, 8))):
                g, c = getattr(res, part), getattr(cpu, part)
                for field, v in zip(g._fields, g):
                    check(tuple(v.shape) == shape and v.device.type == "cuda"
                          and v.dtype == torch.float64,
                          f"{method} {part}.{field}: {tuple(v.shape)} "
                          f"{v.dtype} on {v.device}")
                if boot:
                    dev_stat = rel_dev(g.stat, c.stat)
                    check(dev_stat <= 1e-12, f"{method} {part} statistic: "
                          f"card != CPU ({dev_stat:.3e})")
                    check(bool(torch.isfinite(g.df).all()),
                          f"{method} {part}: df not finite")
                    check(bool(((g.pvalue >= 0) & (g.pvalue <= 1)).all()),
                          f"{method} {part}: p-value outside [0, 1]")
                    if method == "MCBOOT":
                        check(bool(torch.isnan(g.stat).all()
                                   and (g.pvalue == 0).all()),
                              "MCBOOT: statistic not NaN or p-value not 0")
                    dev = dev_stat
                    flips, df_rel = boot_vs_cpu(method, part, g,
                                                getattr(cpu_slice, part))
                    out.setdefault(method, {})[f"{part}_df_rel_vs_cpu"] = df_rel
                    out[method][f"{part}_p_side_flips"] = flips
                else:
                    dev = max(rel_dev(a, b) for a, b in zip(g, c))
                    check(dev <= 1e-9, f"{method} {part}: card != CPU "
                          f"({dev:.3e})")
                out.setdefault(method, {})[f"{part}_card_vs_cpu_rel"] = dev
            out[method].update(wall_s=wall, draw_loop_s=loop_s,
                               draw_loop_share=share)
            what = (f"draw loop {loop_s:.3f} s ({share:.1%}, {loop_calls} "
                    "chunks)" if boot else "no draw loop")
            print(f"[12 {method}] wall {wall:.3f} s, {what}; card vs CPU "
                  f"{'statistic ' if boot else 'stat/df/p '}max rel "
                  f"{max(out[method]['between_chain_card_vs_cpu_rel'], out[method]['within_chain_card_vs_cpu_rel']):.3e}")
            if boot:
                o = out[method]
                print(f"[12 {method} vs CPU, nsim=1000, first "
                      f"{BOOT_CPU_PARAMS} params] df max rel "
                      f"{max(o['between_chain_df_rel_vs_cpu'], o['within_chain_df_rel_vs_cpu']):.3e} "
                      f"(bound 0.15); p on the other side of 0.05 "
                      f"{o['between_chain_p_side_flips'] + o['within_chain_p_side_flips']} "
                      f"(bound 0, where the CPU's p lies more than "
                      f"{P_MARGIN:.4f} from 0.05); CPU {cpu_slice_s:.1f} s")
    finally:
        loop.restore()

    # what the loop over draws spends its time on: MCBOOT on the first 500
    # draws under the profiler (device time by kernel, idle share)
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import profile_calls

    prof = profile_calls.profile_call(
        lambda: mtt.discretediag(x_gpu[:500], method="MCBOOT", nsim=1000,
                                 rng=0), top=6)
    steps = 499 + 149  # between-chain and within-chain draws after the first
    print(f"[12 MCBOOT profile, 500 draws] wall {prof['wall_ms']:.1f} ms "
          f"({prof['wall_ms'] * 1e3 / steps:.0f} us a draw), device "
          f"{prof['device_ms']:.1f} ms, idle {prof['idle']:.1%}")
    for kernel, ms, n in prof["kernels"]:
        print(f"   {ms:8.3f} ms x{n:<5d} {kernel[:90]}")
    out["MCBOOT"]["profile_500_draws"] = {
        k: prof[k] for k in ("wall_ms", "device_ms", "idle")}

    # chain 0 of parameter 0 drawn from other category probabilities
    bad = cats.copy()
    bad[:, 0, 0] = rng.choice(4, size=10_000, p=[0.05, 0.15, 0.3, 0.5])
    xb = torch.from_numpy(bad).cuda()
    for method in ("weiss", "billingsley"):
        p = mtt.discretediag(xb, method=method).between_chain.pvalue
        rest = float(p[1:].min())
        print(f"[12 {method} flags the odd chain] p of parameter 0 "
              f"{float(p[0]):.3e} (bound 1e-3); min of the others {rest:.3e}")
        check(float(p[0]) < 1e-3, f"{method}: the odd chain is not flagged")
        out[method]["odd_chain_p"] = float(p[0])
    return out


def rstar_sample(rng, shift: bool) -> np.ndarray:
    """1000 draws x 8 chains x 100 params of AR(1) phi=0.5, parameter 0 of
    chain 0 shifted by one stationary sd (1 / sqrt(1 - phi^2)) if asked."""
    x = ar1(rng, 0.5, (1000, 8, 100))
    if shift:
        x[:, 0, 0] += np.float32(1.0 / math.sqrt(0.75))
    return x


def phase_rstar_dense() -> dict:
    """The default ``GBTClassifier()`` (100 rounds, depth 3, 64 bins) through
    ``rstar`` on a shifted and an unshifted sample, probabilistic (mean) and
    ``deterministic``: the shifted R* must exceed the unshifted, the dense
    fit must run. Then one fit on the card, and predict with that state on
    the card and on the CPU: logits within 1e-5."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch.models import gbt

    rng = np.random.default_rng(SEED + 13)
    xs = {name: torch.from_numpy(rstar_sample(rng, name == "shifted")).cuda()
          for name in ("shifted", "unshifted")}
    dense = CallTimer(gbt, "_fit_gbt")
    bigk = CallTimer(gbt, "_fit_gbt_bigk")
    out = {}
    try:
        for name, x in xs.items():
            for algo, clf in (("probabilistic", mtt.models.GBTClassifier()),
                              ("deterministic", mtt.models.deterministic(
                                  mtt.models.GBTClassifier()))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = mtt.rstar(clf, x, rng=0)
                wall = time.perf_counter() - t0
                val = r.mean() if algo == "probabilistic" else r
                check(math.isfinite(val), f"R* {name} {algo} not finite")
                out[f"{name}_{algo}"] = val
                out[f"{name}_{algo}_wall_s"] = wall
                print(f"[13 {name} {algo}] R* {val:.4f}; wall {wall:.3f} s")
        check(dense.calls == 4 and bigk.calls == 0,
              f"dense fits {dense.calls}, class-chunked {bigk.calls}: "
              "expected 4 and 0")
        for algo in ("probabilistic", "deterministic"):
            check(out[f"shifted_{algo}"] > out[f"unshifted_{algo}"],
                  f"{algo} R* of the shifted sample does not exceed the "
                  "unshifted")
    finally:
        dense.restore()
        bigk.restore()

    # one state, predicted on the card and on the CPU
    x = xs["shifted"]
    rows = x.permute(1, 0, 2).reshape(8000, 100)
    y = np.repeat(np.arange(16), 500)  # split chains, in order
    clf = mtt.models.GBTClassifier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = clf.fit(rows, y, 16)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg = clf.predict_logits(state, rows)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    state_cpu = type(state)(*(v.cpu() if isinstance(v, torch.Tensor) else v
                              for v in state))
    lc = clf.predict_logits(state_cpu, rows.cpu())
    err = max_abs_err(lg.cpu(), lc)
    print(f"[13 one state] fit {fit_s:.3f} s, predict {predict_s * 1e3:.2f} "
          f"ms on 8000 x 100 rows, 16 classes; logits card vs CPU max abs "
          f"{err:.3e} (bound 1e-5)")
    check(err <= 1e-5, "GBT logits: card != CPU")
    out.update(fit_s=fit_s, predict_s=predict_s, logits_card_vs_cpu=err,
               one_state=(clf, rows, y, state))
    return out


def profile_split(fn, labels) -> dict:
    """One call of ``fn`` under the profiler: device time (ms) of the
    kernels launched inside each ``record_function`` label and of the rest,
    by walking each launching op up to its labelled ancestor."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {lab: 0.0 for lab in labels}
    split["rest"] = 0.0
    for e in prof.events():
        if e.device_type.name != "CPU" or not e.kernels or e.name in labels:
            continue
        lab, p = "rest", e.cpu_parent
        while p is not None:
            if p.name in labels:
                lab = p.name
                break
            p = p.cpu_parent
        split[lab] += sum(k.duration for k in e.kernels
                          if k.name not in labels) / 1e3
    return split


def phase_rstar_bigk() -> dict:
    """BASELINE.md config 5's R* (benchmarks/suite.py: 100 draws x 10,000
    chains x 4 params, standard normal float32, seed 0) through
    ``GBTClassifier(n_rounds=20, n_bins=32, class_chunk=256)`` with rng=0:
    20,000 split-chain classes on ~700k training rows through the
    class-chunked fit, which must run; the mean must lie in [0.9, 1.1].
    Wall and peak device memory of one run, then the device time split
    between the logit products, the histograms and the rest from a second
    run under the profiler. Then the first 256 chains through the dense fit
    and the class-chunked fit (64 classes a chunk): splits equal, leaf
    values within 5e-6."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch.models import gbt

    x = np.random.default_rng(0).standard_normal((100, 10_000, 4)).astype(
        np.float32)
    xg = torch.from_numpy(x).cuda()
    clf = mtt.models.GBTClassifier(n_rounds=20, n_bins=32, class_chunk=256)
    bigk = CallTimer(gbt, "_fit_gbt_bigk")
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dist = mtt.rstar(clf, xg, rng=0)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        check(bigk.calls == 1, f"class-chunked fit ran {bigk.calls} times")
        fit_s = bigk.seconds
    finally:
        bigk.restore()
    mean = dist.mean()
    print(f"[14 config 5 R*] mean {mean:.4f} (bounds 0.9, 1.1), {dist.n} test "
          f"rows; wall {wall:.2f} s (fit {fit_s:.2f} s), peak +{peak:.2f} GB")
    check(0.9 <= mean <= 1.1, "config 5 R* outside [0.9, 1.1]")
    split = profile_split(lambda: mtt.rstar(clf, xg, rng=0),
                          ("gbt.logits", "gbt.hist"))
    total = sum(split.values())
    print(f"[14 device time] {total / 1e3:.2f} s: logit products "
          f"{split['gbt.logits'] / 1e3:.2f} s, histograms "
          f"{split['gbt.hist'] / 1e3:.2f} s, rest {split['rest'] / 1e3:.2f} s")

    # the first 256 chains (512 split-chain classes, 25,600 rows) through
    # the dense fit and the class-chunked fit: the same forest
    rows = xg[:, :256].permute(1, 0, 2).reshape(25_600, 4)
    y = np.repeat(np.arange(512), 50)
    states, walls = {}, {}
    for kc in (-1, 64):
        c = mtt.models.GBTClassifier(n_rounds=20, n_bins=32, class_chunk=kc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[kc] = c.fit(rows, y, 512)
        torch.cuda.synchronize()
        walls[kc] = time.perf_counter() - t0
    dense, chunked = states[-1], states[64]
    same = (torch.equal(dense.split_feature, chunked.split_feature)
            and torch.equal(dense.split_bin, chunked.split_bin))
    lv_err = max_abs_err(dense.leaf_value, chunked.leaf_value)
    print(f"[14 dense vs class-chunked, 256 chains] splits equal: {same}; leaf "
          f"values max abs {lv_err:.3e} (bound 5e-6); fits {walls[-1]:.2f} s "
          f"dense, {walls[64]:.2f} s in chunks of 64 classes")
    check(same and lv_err <= 5e-6,
          "class-chunked fit differs from the dense fit")
    return {"mean": mean, "wall_s": wall, "fit_s": fit_s, "peak_gb": peak,
            "device_ms": split, "slice_leaf_value_max_abs": lv_err,
            "slice_fit_dense_s": walls[-1], "slice_fit_chunked_s": walls[64]}


def phase_float64() -> dict:
    """Float64 on the card: ``ess_rhat(kind="rank")`` in both rank modes,
    ``mcse(kind="mean")`` and ``gewekediag`` on a 2000 x 32 x 64 float64
    sample run the plain versions on the card (no kernel may launch) and
    agree with the CPU within 1e-6 (relative; Geweke z 1e-6 abs + rel)."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch import kernels

    rng = np.random.default_rng(SEED + 15)
    x_cpu = torch.from_numpy(ar1(rng, 0.5, (2000, 32, 64)).astype(np.float64))
    x_gpu = x_cpu.cuda()
    calls = {
        "ess_rhat fast": lambda v: mtt.ess_rhat(v, kind="rank",
                                                rank_mode="fast"),
        "ess_rhat exact": lambda v: mtt.ess_rhat(v, kind="rank"),
        "mcse mean": lambda v: mtt.mcse(v, kind="mean"),
        "gewekediag": lambda v: mtt.gewekediag(v),
    }
    out = {}
    for name, fn in calls.items():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = fn(x_gpu)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        wall = wall_s(lambda: fn(x_gpu))
        counts = kernels.launch_counts()
        check(not any(counts.values()), f"float64 {name} launched {counts}")
        c = fn(x_cpu)
        g = g if isinstance(g, tuple) else (g,)
        c = c if isinstance(c, tuple) else (c,)
        worst = 0.0
        for a, b in zip(g, c):
            check(a.device.type == "cuda" and a.dtype == torch.float64,
                  f"float64 {name}: {a.dtype} on {a.device}")
            a, b = a.cpu(), b
            tol = 1e-6 * (1 + b.abs()) if name == "gewekediag" else 1e-6 * b.abs()
            check(bool(((a - b).abs() <= tol).all()),
                  f"float64 {name}: card != CPU")
            worst = max(worst, rel_dev(a, b))
        print(f"[15 float64 {name}] card vs CPU max rel {worst:.3e} (bound "
              f"1e-6); no kernel launched; wall {wall * 1e3:.1f} ms (median "
              f"of 3; first call {first * 1e3:.1f} ms)")
        out[name] = {"card_vs_cpu_rel": worst, "wall_s": wall,
                     "first_call_s": first}
    return out


# ---- phase 16: the sharded path on a world of one rank over NCCL -----------

NSUPER = 16  # superchains of the nested R-hat: 8 chains each


def start_world_of_one() -> None:
    """A process group of one rank over NCCL on card 0, from an in-memory
    store (NCCL takes one rank a card; this machine has one card)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)


def counted_call(fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after: ``(result, counts, first call s, median wall of 3 warm calls)``."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.launch_counts()
    return res, counts, first, wall_s(fn)


def check_launches(tag: str, counts: dict, want: dict) -> None:
    """Each kernel of ``want`` ran exactly that often (None: at least once);
    K1 and K2 (not on the sharded path) never."""
    shown = {k: counts[k] for k in ("K1", "K2", "K3", "K4", "K4z", "K5")}
    print(f"   {tag} launches: {shown}")
    for kid, n in {"K1": 0, "K2": 0, **want}.items():
        ok = counts[kid] >= 1 if n is None else counts[kid] == n
        check(ok, f"{tag}: {kid} ran {counts[kid]} times, expected "
              f"{'>= 1' if n is None else n}")


def phase_sharded(x3: torch.Tensor, fast, exact, in_core_walls: dict,
                  host: np.ndarray, streamed) -> dict:
    """``parallel.ess_rhat_sharded(kind="rank")`` on the full sample with the
    gather, ring and hist rank transforms, and ``rhat_nested_sharded`` on 16
    superchains, over a (1, 1) mesh of a world of one rank over NCCL: walls
    (median of 3 warm calls) beside the in-core calls', the K3/K4/K5
    launches of each call (hist: K3 and K4 twice each; every kind K5; K1
    and K2 never), and the largest differences from the in-core results
    (exact for gather and ring, the fast mode for hist): ESS 1e-3 relative,
    R-hat 1e-4 absolute (phase 6's K5-against-K1 limits). Then config 4
    through ``ess_rhat_streaming(mesh_cfg=...)`` against phase 11's streamed
    result under the same limits."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels, parallel

    import mcmcdiagnostictools_jl_tpu_torch as mtt

    cfg = parallel.make_mesh()
    check(cfg.device == torch.device("cuda", 0) and cfg.chain_shards == 1
          and cfg.param_shards == 1, f"mesh on {cfg.device}")
    maxlag = min(250, DRAWS // 2 - 4)
    out = {"ess_rhat": {}, "nested": {}}
    results = {}
    for impl in ("gather", "ring", "hist"):
        mode = "fast" if impl == "hist" else "exact"
        ref = fast if impl == "hist" else exact
        res, counts, first, wall = counted_call(
            lambda: parallel.ess_rhat_sharded(x3, cfg, kind="rank",
                                              rank_impl=impl))
        results[impl] = res
        tag = f"[16 ess_rhat_sharded {impl}]"
        print(f"{tag} wall {wall:.4f} s (first call {first:.3f} s); in-core "
              f"{mode} {in_core_walls[mode]:.4f} s")
        check_launches(tag, counts, {"K3": 2, "K4": 2, "K5": None}
                       if impl == "hist" else {"K3": 0, "K4": 0, "K5": None})
        for v in res:
            check(v.shape == (PARAMS,) and v.device.type == "cuda"
                  and bool(torch.isfinite(v).all()),
                  f"{tag}: bad output {tuple(v.shape)} on {v.device}")
        rhat_abs = float((res.rhat - ref.rhat).abs().max())
        print(f"   vs in-core {mode}: R-hat abs {rhat_abs:.3e} (bound 1e-4)")
        check(rhat_abs <= 1e-4, f"{tag}: R-hat != in-core")
        ess_rel = check_agree(
            f"{tag} ESS vs in-core {mode}", res.ess, ref.ess, 1e-3,
            lambda: (geyer_stop_pairs(bulk_z(x3, mode), "direct_kernel",
                                      maxlag),
                     geyer_stop_pairs(bulk_z(x3, mode), "kernel", maxlag)))
        out["ess_rhat"][impl] = {
            "wall_s": wall, "first_call_s": first,
            "in_core_wall_s": in_core_walls[mode], "ess_rel": ess_rel,
            "rhat_abs": rhat_abs,
            "launches": {k: counts[k] for k in ("K3", "K4", "K4z", "K5")}}
    ring, gather = results["ring"], results["gather"]
    rg_ess = float((ring.ess / gather.ess - 1).abs().max())
    rg_rhat = float((ring.rhat - gather.rhat).abs().max())
    print(f"[16 ring vs gather] ESS rel {rg_ess:.3e}, R-hat abs {rg_rhat:.3e} "
          "(bounds 1e-6: the same ranks; the tail moments are summed in "
          "another order)")
    check(rg_ess <= 1e-6 and rg_rhat <= 1e-6, "ring != gather")
    out["ring_vs_gather"] = {"ess_rel": rg_ess, "rhat_abs": rg_rhat}

    ids = np.repeat(np.arange(NSUPER), CHAINS // NSUPER)
    r_in, _, _, nested_wall = counted_call(lambda: mtt.rhat_nested(x3, ids))
    for impl in ("gather", "ring", "hist"):
        r, counts, first, wall = counted_call(
            lambda: parallel.rhat_nested_sharded(x3, ids, cfg,
                                                 rank_impl=impl))
        tag = f"[16 rhat_nested_sharded {impl}, {NSUPER} superchains]"
        bound = 1e-3 if impl == "hist" else 1e-4
        err = float((r - r_in).abs().max())
        print(f"{tag} wall {wall:.4f} s (first call {first:.3f} s); in-core "
              f"exact {nested_wall:.4f} s; R-hat abs vs in-core {err:.3e} "
              f"(bound {bound:.0e}{', the fast mode' if impl == 'hist' else ''})")
        check_launches(tag, counts, {"K3": 2, "K4": 2, "K5": 0}
                       if impl == "hist" else {"K3": 0, "K4": 0, "K5": 0})
        check(r.shape == (PARAMS,) and bool(torch.isfinite(r).all())
              and err <= bound, f"{tag}: != in-core")
        out["nested"][impl] = {"wall_s": wall, "first_call_s": first,
                               "in_core_wall_s": nested_wall,
                               "rhat_abs": err}

    # config 4 streamed onto the mesh (the hist transform), twice: the first
    # run also pins its buffers
    for _ in range(2):
        kernels.reset_launch_counts()
        res, stats = mtt.ess_rhat_streaming(host, param_chunk=PARAMS,
                                            mesh_cfg=cfg, return_stats=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    tag = "[16 config 4 streamed onto the mesh]"
    check_launches(tag, counts, {"K3": 2 * stats.n_chunks,
                                 "K4": 2 * stats.n_chunks, "K5": None})
    rhat_abs = float((res.rhat - streamed.rhat).abs().max())
    sums = {k: sum(getattr(stats, k)) for k in ("fetch_s", "h2d_s",
                                               "compute_s")}
    print(f"{tag} {stats.n_chunks} chunks; wall {stats.wall_s:.3f} s (sums: "
          f"gather {sums['fetch_s']:.3f}, copy {sums['h2d_s']:.3f}, compute "
          f"{sums['compute_s']:.3f}); in-core streamed (phase 11) "
          f"{in_core_walls['streamed']:.3f} s; R-hat abs vs phase 11 "
          f"{rhat_abs:.3e} (bound 1e-4)")
    check(res.ess.shape == (CONFIG4_PARAMS,) and rhat_abs <= 1e-4,
          "mesh streaming != in-core streaming")

    def stream_stops():
        # where each column's Geyer truncation falls with K5 and with K1,
        # on the in-core fast transform of each chunk
        stops = ([], [])
        for lo in range(0, CONFIG4_PARAMS, PARAMS):
            z = bulk_z(torch.from_numpy(np.ascontiguousarray(
                host[:, :, lo:lo + PARAMS])).cuda(), "fast")
            for acc, method in zip(stops, ("direct_kernel", "kernel")):
                acc.append(geyer_stop_pairs(z, method, maxlag))
        return torch.cat(stops[0]), torch.cat(stops[1])

    ess_rel = check_agree(f"{tag} ESS vs phase 11", res.ess, streamed.ess,
                          1e-3, stream_stops)
    out["streaming"] = {"wall_s": stats.wall_s, **sums, "ess_rel": ess_rel,
                        "rhat_abs": rhat_abs,
                        "in_core_wall_s": in_core_walls["streamed"]}
    return out


def phase_sharded_gbt(single, rows: torch.Tensor, y: np.ndarray, state,
                      fit_s: float) -> dict:
    """``ShardedGBTClassifier`` with the settings of phase 13's classifier
    ``single`` on its rows, over the world of one rank (every level's
    histograms and the leaf sums through an NCCL all-reduce): the forest of
    phase 13's fit, splits equal and leaf values within 1e-5."""
    import dataclasses

    import mcmcdiagnostictools_jl_tpu_torch as mtt

    clf = mtt.models.ShardedGBTClassifier(**dataclasses.asdict(single))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2 = clf.fit(rows, y, state.num_classes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = (torch.equal(s2.split_feature, state.split_feature)
            and torch.equal(s2.split_bin, state.split_bin))
    lv = max_abs_err(s2.leaf_value, state.leaf_value)
    print(f"[16 ShardedGBTClassifier, phase 13's rows] splits equal: {same}; "
          f"leaf values max abs {lv:.3e} (bound 1e-5); fit {wall:.3f} s "
          f"(GBTClassifier {fit_s:.3f} s)")
    check(same and lv <= 1e-5, "sharded GBT forest != GBTClassifier's")
    return {"fit_s": wall, "single_fit_s": fit_s, "leaf_value_max_abs": lv}


def main() -> int:
    dev = phase_device()
    # (fails outside the repo)
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import profile_calls

    build_log = phase_build()
    t0 = time.perf_counter()
    bad_param = 0
    # an eighth of the chains of parameter 0 sit 4 sd off: the rank-based
    # R-hat of 128 chains cannot be pushed past 1.1 by one chain alone
    x3 = profile_calls.make_sample(SEED, (DRAWS, CHAINS, PARAMS), device="cuda")
    print(f"[data] AR(1) phi=0.5 {DRAWS}x{CHAINS}x{PARAMS} f32 on the card "
          f"({x3.numel() * 4 / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")

    rows = phase_kernels(x3)
    phase_lag_shapes()
    e2e = phase_end_to_end(x3, bad_param)
    phase_card_vs_cpu()
    rows.append(phase_direct_autocov(x3))
    est = phase_estimators(x3)
    phase_estimators_card_vs_cpu()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matrix products are on; the PSRF needs full float32")
    fz = phase_fused_z(x3)
    rows.append(fz["row"])
    classical = phase_classical(x3, bad_param)
    phase_classical_card_vs_cpu()
    lag = phase_lagloop(build_log)
    sort = phase_sort_study(build_log)
    fast, exact = e2e.pop("fast"), e2e.pop("exact")
    streaming = phase_streaming(x3, fast, exact)
    start_world_of_one()
    sharded = phase_sharded(x3, fast, exact, {"fast": e2e["fast_s"],
                                              "exact": e2e["exact_s"],
                                              "streamed": streaming["wall_s"]},
                            streaming.pop("host"), streaming.pop("result"))
    del x3, fast, exact
    discrete = phase_discretediag()
    rstar_dense = phase_rstar_dense()
    sharded["gbt"] = phase_sharded_gbt(*rstar_dense.pop("one_state"),
                                       rstar_dense["fit_s"])
    torch.distributed.destroy_process_group()
    rstar_bigk = phase_rstar_bigk()
    float64 = phase_float64()

    src = f"{PKG}/csrc/"
    pallas = "mcmcdiagnostictools_jl_tpu/ops/pallas/"
    meta = [
        ("K1 moments_autocov", src + "moments_autocov.cu",
         pallas + "fused_basic_kernel.py:67"),
        ("K2 column_minmax", src + "fastrank.cu", pallas + "fastrank_kernel.py:360"),
        ("K3 hist_moments", src + "fastrank.cu", pallas + "fastrank_kernel.py:173"),
        ("K4 rank_lookup", src + "fastrank.cu", pallas + "fastrank_kernel.py:275"),
        ("K5 direct_autocov", src + "autocov.cu", pallas + "autocov_kernel.py:46"),
        ("K4z rank_lookup z mode (blom_n)", src + "fastrank.cu",
         pallas + "fastrank_kernel.py:275"),
        ("K6a lag_products variant a", src + "lagloop_study.cu",
         "benchmarks/micro_lagloop.py:72"),
        ("K6b lag_products variant b", src + "lagloop_study.cu",
         "benchmarks/micro_lagloop.py:72"),
        ("K7 pass_strided", src + "sort_study.cu",
         "benchmarks/sort_microbench.py:110"),
        ("K8 pass_contig", src + "sort_study.cu",
         "benchmarks/sort_microbench.py:171"),
        ("K9 bitonic_pod_sort", src + "sort_study.cu",
         "benchmarks/sort_microbench.py:307"),
    ]
    rows += [lag["rows"]["a"], lag["rows"]["b"]]
    rows += [sort["rows"][kid] for kid in ("K7", "K8", "K9")]
    # K1-K4 launches: the fast ess_rhat call of phase 4; K5: the marker
    # calls of phase 6; K4z: the FUSE_BLOM_Z call of phase 7; K6: the
    # micro_lagloop runs of phase 9; K7-K9: the sort_microbench runs of
    # phase 10 (K1-K4 in the streamed run: "streaming" in the line above)
    launches = {**e2e["counts"], "K5": est["k5_launches"],
                "K4z": fz["launches"], "K6a": lag["launches"]["a"],
                "K6b": lag["launches"]["b"], **sort["launches"]}
    kernels_out = []
    for (name, source, replaces), row in zip(meta, rows):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name.split()[0]],
                 "max_abs_err": row.pop("err"), "ms": row.pop("ms"),
                 "plain_ms": row.pop("plain_ms"),
                 "bound_ms": row.pop("bound_ms"),
                 "bound_by": row.pop("bound_by"),
                 "library_ms": row.pop("library_ms", None)}
        entry.update(row)
        kernels_out.append(entry)
    print(json.dumps({"wall_fast_s": e2e["fast_s"], "wall_exact_s": e2e["exact_s"],
                      "wall_numpy_float64_s": e2e["numpy_float64_s"],
                      **est["walls"],
                      "fast_vs_exact_max_rel_dev": est["fast_vs_exact_max_rel_dev"],
                      **fz["walls"], "fused_vs_unfused": fz["fused_vs_unfused"],
                      "classical": classical, "streaming": streaming,
                      "discretediag": discrete, "rstar_dense": rstar_dense,
                      "rstar_config5": rstar_bigk, "float64": float64,
                      "sharded": sharded}))
    print(dev["smi"])
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
