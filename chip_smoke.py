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
   K10 (the fold merge) and K11 (split-chain moments) on the exact tail
   transform's inputs, its rows (256, 1.28M), with a NaN row, a constant
   row, heavy ties and a row whose median is NaN (75 % +inf): K10's keys
   bit-identical to ``valley_sort_2d``'s and ``torch.sort(dim=1)``'s,
   payloads a permutation and equal up to ties, the NaN-median row unmoved;
   K11 two runs bit-equal and within 1e-6 (sums) and 1e-4 (R-hat) of its
   float64 plain version, and on the ring route's (1.28M, 256) layout
   (transposed views) bit-equal to the rows; K12 (tied ranks and Blom
   scores) on the same rows, sorted and scattered back by position with the
   NaN rows masked, and on K10's fold keys: ranks bit-equal to its plain
   version, z within 4 float32 ULP, the scatter equal to the plain scatter
   of its own values, two runs bit-equal, with the times of its Blom
   table's fill and of the scatter's two passes; each beside its bound, its
   plain version and a library yardstick; then the sample into rows and the
   bulk values back to (draw, chain) order, each two ways, timed; K13 (the
   row sort) on the sample's rows (256, 1.28M) with a NaN, a constant, a
   sign-bit NaN and a signed-zero column: keys bit for bit and positions
   equal to ``torch.sort(dim=1, stable=True)`` and to its plain version,
   its keys-only form equal, two runs bit-equal, timed beside both with its
   launches one by one; the flagship exact ``ess_rhat`` through K13 and
   through its plain version bit-equal, and the cub radix kernels that call
   launches (none may be left from the row sort); K14 (the ring's
   merge-count) in its four modes bit for bit its plain version's, at the
   sharded cell's block (50, 6.25M) of sorted normals against another and
   on the sorted rows phase 16's ring counts against the same rows on a
   grid of 1/4, timed at the block beside its bounds, its plain version
   and ``torch.searchsorted``; K15 (the ring's Blom scores from its counts)
   bit for bit its plain version's at the cell's block with n = 25M and on
   every count of a short row, timed beside its bound and the plain
   passes; then K1 and K5 at lag counts on both sides of a block's span (maxlag 0,
   64, 65, 250, 255, 256, 300), at a draw count off every tile, at series
   counts off 32 and off 4, and at ``maxlag >= niter``;
4. end to end: ``ess_rhat(x, kind="rank")`` in the fast and exact rank modes
   on that sample; checks that every kernel ran (the exact call K10, K11
   and K13 once each, K12 twice), that fast tracks exact, and that the badly mixed parameter is
   flagged; then the same sample as numpy float64 with no device, which must
   run K1-K4 on the card and give the float32 tensor's result; prints the
   wall times; then the exact call with ``fold_impl`` auto, sort and merge
   in turns (ESS bit-equal, R-hat within 1e-6; K13 twice with ``sort``),
   walls and peak memory;
5. card against CPU: the same calls at 2000 x 32 x 64 on the card and
   through the plain CPU path must agree, and the exact kinds ``tail`` and
   ``rank`` with ``fold_impl="merge"`` (R-hat 1e-4);
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
10. the sort study through ``benchmarks.sort_microbench`` and
    ``benchmarks.pass_study`` at 1,048,576 x 128 keys and payload: the pass
    kernel's SASS must hold bulk copies and no ``LDGSTS``; K7 at three
    (pods, stride) settings and K8 at two, equal to the plain version, then
    timed in turns with ``add_`` and the plain version (median of 15), with
    their ratio to ``add_`` and share of the memory rate; K9 at pods of
    16,384 and 32,768 rows against its plain version, beside ``torch.sort``,
    then at a pod smaller than a chunk and a column count off the 8-column
    block, with the chunk kernel's registers and spills from the build;
11. out of core: BASELINE.md config 4 (10k x 128 x 1000 float32, 5.12 GB) on
    the host through ``ess_rhat_streaming`` in chunks of 256 parameters: K1-K4
    must run in every chunk, the first 256 parameters must equal the resident
    call of phase 4, peak device memory must stay bounded whatever the number
    of chunks; prints the wall beside the sums of gather, copy and compute;
    then the exact rank mode in chunks of 64 against phase 4's exact result
    (K13 twice a chunk, on 64 rows: the sample's and, the streamed fold
    being a sort, the folded keys');
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
    must run, mean in [0.9, 1.1]; wall and peak memory; then its
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
    0 (hist: K3 and K4 twice, every ``ess_rhat_sharded`` call K5, gather and
    ring K11 once (nested: twice), gather K12 twice, ring K14 twice (the
    one shard's own block, bulk and fold) and K15 twice (the scores of
    both), K1, K2 and K10 never),
    its wall beside
    the in-core call's and its largest differences
    from the in-core results (ESS 1e-3 relative, R-hat 1e-4 absolute; ring
    against gather 1e-6); config 4 through ``ess_rhat_streaming(mesh_cfg=
    ...)`` against phase 11's result; ``ShardedGBTClassifier`` on phase 13's
    rows: the same forest;
17. sign-bit NaNs, run in phase 16's world on the flagship sample with one
    column of ``0xffc00000`` NaNs and one such NaN in another column (the
    card's radix sort puts it first): the exact ``ess_rhat(kind="rank")``
    with ``fold_impl`` sort and merge, ``ess`` median and mad, ``mcse`` of
    ``Quantile(0.25)``, ``ess_rhat_streaming`` in exact mode and
    ``ess_rhat_sharded`` gather and ring: those columns NaN, every other
    column bit-equal to the same sample's with ``+nan`` there; where the
    sort put the NaN, and the NaN-row test's time beside ``isnan().any``;
18. HMC on the card (``models.hmc_sample``, float32): BASELINE.md config 2
    (eight schools, 8 chains x 10 params x 1000 draws, step 0.2, 16
    leapfrog steps at most) with the properties of
    ``tests/test_integration.py::TestEightSchools`` (R-hat < 1.05, ESS >
    100, 0 < MCSE < posterior sd) and its MCSEs and BFMI; Cauchy at 128
    chains x 256 dims x 1000 draws (step 0.25) with those of
    ``TestCauchyHeavyTails`` (accept > 0.6, median tail-ESS < 0.8 x median
    bulk-ESS, median bulk-ESS > 50, BFMI < 1), and on its trace the fast
    and exact ``ess_rhat`` (K1-K4; K1, K10-K13) and ``mcse`` with
    ``PallasAutocovMethod`` (K5), each with its launches counted from 0;
    the deterministic core on the same float64 draws on the card and on the
    CPU (1e-8); the sampler's walls and rates, and over 20 draws of each
    target its device operations a leapfrog step and the card's idle share;
    ``utils.profiling.trace`` around one fast ``ess_rhat``: the trace file
    holds a K1 kernel and the annotated region.

Before them a line gives the run's total time, the build included. The
line before the last two is the card's name and power limit, the
second-to-last line the kernels' JSON record (each with its time, its plain
version's, its bound and, where one PyTorch call computes the same, that
call's; ``hmc_launches``: its launches in phase 18's diagnostics on the
Cauchy trace), the last line ``{"ok": true, "device": {...}}``. Only PyTorch and
numpy are used.
"""

from __future__ import annotations

import concurrent.futures
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


def keys_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit where not NaN, NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.view(torch.int32)[~na],
                                               b.view(torch.int32)[~nb])


def routed_ranks(fs: torch.Tensor, forder: torch.Tensor) -> torch.Tensor:
    """Tied-average ranks of sorted rows routed back by their payload: equal
    for two sorts whose payloads differ only in the order of tied keys."""
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import _avg_ranks_sorted

    r = _avg_ranks_sorted(fs)
    return torch.empty_like(r).scatter_(1, forder, r)


# K12's z against its plain version: the same Cephes operations on
# bit-equal ranks; its ``logf`` may come from another toolkit than the one
# PyTorch compiles ``ndtri`` with at run time (as for K4's z mode)
K12_Z_ULP = 4


def phase_k12(xs: torch.Tensor, order: torch.Tensor, bad: torch.Tensor,
              fs: torch.Tensor) -> dict:
    """K12 on the exact call's own inputs: the sorted rows ``xs`` (256,
    1.28M) of phase 3's sample (NaN, constant, tied and 75 % +inf rows) in
    sorted order (the mode of the fold) and scattered back by ``order`` with
    ``bad`` (the bulk's), and the fold's keys ``fs`` (K10's output), against
    its plain version: ranks bit-equal on every row, z within ``K12_Z_ULP``,
    the scatter equal to the plain scatter of the kernel's own sorted values,
    two runs bit-equal; times beside the bounds (8 B an entry sorted, 16
    scattered), the plain version (the operations it replaces), one
    ``ndtri`` pass over the same rows and one ``scatter_`` of them; the
    pieces of the scattered mode: the Blom table's fill, pass A and pass B
    (each summed over the groups of rows)."""
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import tiedrank_study
    from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank as k12

    p, n = xs.shape
    for keys in (xs, fs):
        check(torch.equal(k12.tied_blom(keys, blom=False),
                          k12.tied_blom_plain(keys, blom=False)),
              "K12 ranks differ from its plain version's")
    z = k12.tied_blom(xs)
    zp = k12.tied_blom_plain(xs)
    check(torch.equal(z, k12.tied_blom(xs)), "K12: two runs differ")
    ulps = {"sorted": max_ulp_err(z, zp)}
    err = max_abs_err(z, zp)
    del zp
    zs = k12.tied_blom(xs, order, bad)
    check(max_abs_err(zs, k12._scatter_rows(
        z.masked_fill(bad[:, None], torch.nan), order)) == 0.0,
        "K12's scatter differs from the plain scatter of its sorted values")
    del z
    zsp = k12.tied_blom_plain(xs, order, bad)
    ulps["scattered"] = max_ulp_err(zs, zsp)
    err = max(err, max_abs_err(zs, zsp))
    del zs, zsp
    zf, zfp = k12.tied_blom(fs), k12.tied_blom_plain(fs)
    ulps["fold"] = max_ulp_err(zf, zfp)
    err = max(err, max_abs_err(zf, zfp))
    del zf
    check(max(ulps.values()) <= K12_Z_ULP,
          f"K12's z off its plain version: {ulps} ULP")
    ms = time_ms(lambda: k12.tied_blom(xs))
    ms_fold = time_ms(lambda: k12.tied_blom(fs))
    ms_scat = time_ms(lambda: k12.tied_blom(xs, order, bad))
    plain_ms = time_ms(lambda: k12.tied_blom_plain(xs))
    plain_scat = time_ms(lambda: k12.tied_blom_plain(xs, order, bad))
    ndtri_ms = time_ms(lambda: torch.special.ndtri(zfp))
    del zfp
    scatter_ms = time_ms(lambda: k12._scatter_rows(xs, order))
    table_ms = time_ms(lambda: k12.blom_table(n, xs.device))
    pass_a_ms, pass_b_ms = tiedrank_study.pass_ms(xs, order, bad)
    bound, bound_scat = roofline(8.0 * n * p), roofline(16.0 * n * p)
    print(f"[3 K12 tied_blom] rows ({p}, {n}): ranks bit-equal to its plain "
          f"version (bulk rows and fold keys), z within {ulps} float32 ULP "
          f"(bound {K12_Z_ULP}), the scatter equal to the plain scatter of "
          f"its values, two runs bit-equal; sorted {ms:.3f} ms (fold keys "
          f"{ms_fold:.3f}), bound {bound['bound_ms']:.3f} "
          f"({bound['bound_ms'] / ms:.0%}); scattered by order with bad "
          f"{ms_scat:.3f} ms, bound {bound_scat['bound_ms']:.3f} "
          f"({bound_scat['bound_ms'] / ms_scat:.0%}): table fill "
          f"{table_ms:.3f} ms, pass A {pass_a_ms:.3f} ms, pass B "
          f"{pass_b_ms:.3f} ms, in groups of {k12.group_rows(p)} rows; "
          f"plain (the operations it replaces) {plain_ms:.3f} ms sorted, "
          f"{plain_scat:.3f} ms scattered; one ndtri pass {ndtri_ms:.3f} ms, "
          f"one scatter_ along the rows {scatter_ms:.3f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **bound,
                ms_fold=ms_fold, ms_scattered=ms_scat,
                plain_ms_scattered=plain_scat,
                bound_ms_scattered=bound_scat["bound_ms"], z_max_ulp=ulps,
                ndtri_ms=ndtri_ms, scatter_ms=scatter_ms, table_ms=table_ms,
                pass_a_ms=pass_a_ms, pass_b_ms=pass_b_ms,
                group_rows=k12.group_rows(p))


def phase_fold_kernels(x3: torch.Tensor) -> dict:
    """K10 and K11 on the exact tail transform's own inputs, the sorted rows
    (256, 1.28M) of the sample with a NaN row (1), a constant row (2), a row
    of heavy ties (3) and a row 75 % +inf (4: its median is NaN and it holds
    no NaN), medians as the transform takes them.

    K10 against its plain version (``valley_sort_2d``) and ``torch.sort``
    along the rows: keys bit-identical, payloads a permutation and equal up
    to the order of tied keys (tied-average ranks routed back by payload
    equal); a row whose median is NaN keeps its sorted order. K11 on the
    rank-normal values in K10's order: two runs bit-equal, the sums within
    1e-6 of the float64 plain version relative to max(|sum|, 1) (exact
    fixed-point sums rounded once to float32), min and max equal, the R-hat
    of the moments within 1e-4 of the float64 plain version's, and the ring
    route's layout (the same values as (N, P), passed transposed) bit-equal
    to the rows. Then the layout's own copies, each two ways, timed: the
    sample into rows (the port's two-pass transpose, ``.t().contiguous()``)
    and the bulk values back to (draw, chain) order (the port's scatter
    along the rows + transpose, one scatter straight into the row-major
    output)."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import seghist, valley
    from mcmcdiagnostictools_jl_tpu_torch.ops.moments import (
        chain_stats, stats_from_chain_moments)
    from mcmcdiagnostictools_jl_tpu_torch.kernels.tiedrank import (
        tied_blom_plain)
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import (
        _rows, _transpose, _unsort, sort_with_positions, sorted_quantile)
    from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape

    xk = with_bad_columns(x3)
    xk[:, :, 3] = torch.round(xk[:, :, 3] * 2) / 2
    gen = torch.Generator(device=xk.device).manual_seed(SEED)
    u = torch.rand(xk.shape[:2], generator=gen, device=xk.device)
    xk[:, :, 4] = torch.where(u < 0.75, torch.inf, xk[:, :, 4])
    xs, order, bad = sort_with_positions(xk)
    med = torch.where(bad, torch.nan, sorted_quantile(xs, 0.5))
    del xk
    p, n = xs.shape
    check(bool(torch.isnan(med[4])) and not bool(bad[4]),
          "row 4 should have a NaN median and no NaN")
    rows = []

    fs, forder = valley.valley_merge(xs, order, med)
    fp, fop = valley.valley_merge_plain(xs, order, med)
    ref_k, ref_i = torch.sort(torch.abs(xs - med[:, None]), dim=1, stable=True)
    torch.cuda.synchronize()
    check(fs.shape == (p, n) and keys_equal(fs, fp) and keys_equal(fs, ref_k),
          "K10 keys differ from valley_sort_2d's or torch.sort's")
    arange = torch.arange(n, device=xs.device).expand(p, n)
    check(torch.equal(torch.sort(forder, dim=1).values, arange),
          "K10 payload is not a permutation of each row's")
    want = routed_ranks(ref_k, order.gather(1, ref_i))
    check(torch.equal(routed_ranks(fs, forder), want)
          and torch.equal(routed_ranks(fp, fop), want),
          "K10 payloads differ beyond the order of ties")
    nan_med = torch.isnan(med)
    check(torch.equal(forder[nan_med], order[nan_med]),
          "K10 moved a row whose median is NaN")
    del fp, fop, ref_k, ref_i, want, arange
    ms = time_ms(lambda: valley.valley_merge(xs, order, med))
    plain_ms = time_ms(lambda: valley.valley_merge_plain(xs, order, med))
    lib_ms = time_ms(lambda: order.gather(1, torch.sort(
        torch.abs(xs - med[:, None]), dim=1).indices))
    bound = roofline(24.0 * n * p)
    print(f"[3 K10 valley_merge] rows ({p}, {n}): keys bit-identical to "
          f"valley_sort_2d and torch.sort(dim=1), payloads equal up to ties "
          f"(NaN, constant, tied and NaN-median rows); kernel {ms:.3f} ms, "
          f"bound {bound['bound_ms']:.3f} ({bound['bound_ms'] / ms:.0%}), "
          f"plain {plain_ms:.3f} ms, torch.sort(dim=1) + gather "
          f"{lib_ms:.3f} ms")
    rows.append(dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     **bound))

    k12_row = phase_k12(xs, order, bad, fs)
    zf = tied_blom_plain(fs)
    del fs
    a = seghist.segment_moments(zf, forder, DRAWS, CHAINS, 2)
    b = seghist.segment_moments(zf, forder, DRAWS, CHAINS, 2)
    c = seghist.segment_moments_plain(zf.double(), forder, DRAWS, CHAINS, 2)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(a, b)), "K11: two runs differ")
    check(torch.equal(a[2].double(), c[2]) and torch.equal(a[3].double(), c[3]),
          "K11 min/max differ")
    err = max(max_abs_err(u, v) for u, v in zip(a[:2], c[:2]))
    rel = max(float(((u.double() - v).abs() / v.abs().clamp(min=1.0)).max())
              for u, v in zip(a[:2], c[:2]))
    niter = DRAWS // 2

    def rhat(m):
        mean = m[0] / niter
        var = (m[1] - niter * mean * mean) / (niter - 1)
        return stats_from_chain_moments(mean, var, niter, m[2] == m[3]).rhat

    rhat_err = max_abs_err(rhat(a), rhat(c))
    check(rel <= 1e-6 and rhat_err <= 1e-4,
          f"K11 off its float64 plain version: rel {rel:.2e}, R-hat "
          f"{rhat_err:.2e}")
    ms = time_ms(lambda: seghist.segment_moments(zf, forder, DRAWS, CHAINS, 2))
    plain_ms = time_ms(
        lambda: seghist.segment_moments_plain(zf, forder, DRAWS, CHAINS, 2))
    # the ring route's layout: (N, P) blocks, passed as transposed views
    zf_t, forder_t = zf.t().contiguous().t(), forder.t().contiguous().t()
    d = seghist.segment_moments(zf_t, forder_t, DRAWS, CHAINS, 2)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(a, d)),
          "K11 on the (N, P) layout differs from the rows'")
    ring_ms = time_ms(
        lambda: seghist.segment_moments(zf_t, forder_t, DRAWS, CHAINS, 2))
    del zf_t, forder_t, d
    seg, valid = seghist.split_chain_ids_from_flat(forder, DRAWS, CHAINS, 2)
    idx = seg * p + torch.arange(p, device=seg.device)[:, None]
    w = torch.where(valid, zf, 0.0)
    nseg = CHAINS * 2

    def scatter_adds():
        zf.new_zeros(nseg * p).scatter_add_(0, idx.view(-1), w.view(-1))
        zf.new_zeros(nseg * p).scatter_add_(0, idx.view(-1), (w * w).view(-1))

    lib_ms = time_ms(scatter_adds)
    del seg, valid, idx, w
    old_ms = time_ms(lambda: chain_stats(split_chains_reshape(
        _unsort(zf, forder).reshape(DRAWS, CHAINS, p), 2)))
    bound = roofline(12.0 * n * p)
    print(f"[3 K11 segment_moments] two runs bit-equal; sums within "
          f"{rel:.3e} of the float64 plain version (relative, bound 1e-6), "
          f"R-hat {rhat_err:.3e} (bound 1e-4), min/max equal; kernel "
          f"{ms:.3f} ms on rows, {ring_ms:.3f} ms on the (N, P) layout "
          f"(bit-equal), bound {bound['bound_ms']:.3f} "
          f"({bound['bound_ms'] / ms:.0%}), plain {plain_ms:.3f} ms, two "
          f"scatter_add_ {lib_ms:.3f} ms, the scatter back + chain_stats it "
          f"replaces {old_ms:.3f} ms")
    rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     deterministic=True, ms_sample_major=ring_ms,
                     ms_unsort_chain_stats=old_ms, rhat_err=rhat_err, **bound))
    rows.append(k12_row)
    del zf, forder

    # the sample into rows and the bulk values back to (draw, chain) order:
    # the port's two-pass transpose against PyTorch's one copy, and the
    # scatter along the rows + transpose against one scatter straight into
    # the row-major output
    xf = x3.reshape(n, p)
    check(torch.equal(_rows(x3), xf.t().contiguous()), "_rows differs")
    rows_ms = time_ms(lambda: _rows(x3))
    rows_t_ms = time_ms(lambda: xf.t().contiguous())
    z = tied_blom_plain(xs)

    def direct():
        out = z.new_empty((n, p))
        out.t().scatter_(1, order, z)
        return out

    check(torch.equal(_unsort(z, order), direct()), "the two ways back differ")
    unsort_ms = time_ms(lambda: _unsort(z, order))
    direct_ms = time_ms(direct)
    back_ms = time_ms(lambda: _transpose(z))
    back_t_ms = time_ms(lambda: z.t().contiguous())
    print(f"[3 layout] into rows: two-pass transpose (the port's) "
          f"{rows_ms:.3f} ms, .t().contiguous() {rows_t_ms:.3f} ms; back to "
          f"(N, P): scatter along the rows + two-pass transpose (the port's) "
          f"{unsort_ms:.3f} ms, scatter straight into the row-major output "
          f"{direct_ms:.3f} ms; the transpose alone {back_ms:.3f} ms, "
          f".t().contiguous() {back_t_ms:.3f} ms")
    return {"rows": rows, "layout_ms": {
        "rows_two_pass": rows_ms, "rows_t_contiguous": rows_t_ms,
        "unsort_rows_then_transpose": unsort_ms,
        "unsort_direct_scatter": direct_ms, "transpose_back_two_pass": back_ms,
        "transpose_back_t_contiguous": back_t_ms}}


def phase_k13(x3: torch.Tensor) -> dict:
    """K13 on the exact call's own rows (256, 1.28M), from the sample with a
    NaN column (1), a constant one (2), one holding sign-bit NaNs (3) and one
    holding signed zeros (4): keys bit for bit and positions equal to
    ``torch.sort(dim=1, stable=True)``'s (the library call it replaces) and
    to its plain version's, the keys-only form's keys equal, two runs
    bit-equal; the three timed (behind the timer's queue; ``torch.sort``
    also by its device time under the profiler), with the bound of
    any sort (16 bytes an entry: the contract's ``bound_ms``) and of the
    design (68), and its launches one by one. Then the flagship exact
    ``ess_rhat`` through K13 and through its plain version (bit-equal), and
    the cub radix kernels launched in that call, under the profiler: none
    may be left from the row sort."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import (profile_calls,
                                                             radix_study)
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13
    from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm

    xk = with_bad_columns(x3)
    xk[::1001, :, 3] = torch.tensor(-math.nan)
    xk[::3, :, 4] = -0.0
    xr = ranknorm._rows(xk)
    del xk
    p, n = xr.shape
    got = k13.sort_rows(xr)
    again = k13.sort_rows(xr)
    want = torch.sort(xr, dim=1, stable=True)
    check(bool(torch.signbit(want[0][3, 0])) and bool(torch.isnan(want[0][3, 0])),
          "torch.sort did not put the sign-bit NaN first")
    check(radix_study.same_sort(got, want),
          "K13 differs from torch.sort(dim=1, stable=True)")
    check(radix_study.same_sort(got, again), "K13: two runs differ")
    del again, want
    check(radix_study.same_sort(got, k13.sort_rows_plain(xr)),
          "K13 differs from its plain version")
    check(torch.equal(k13.sort_rows_keys(xr).view(torch.int32),
                      got[0].view(torch.int32)),
          "K13's keys-only form differs")
    del got
    ms = time_ms(lambda: k13.sort_rows(xr))
    keys_ms = time_ms(lambda: k13.sort_rows_keys(xr))
    plain_ms = time_ms(lambda: k13.sort_rows_plain(xr))
    lib_ms = time_ms(lambda: torch.sort(xr, dim=1, stable=True))
    lib_device_ms = radix_study.device_ms(
        lambda: torch.sort(xr, dim=1, stable=True))
    pieces = [(radix_study._short(k), v)
              for k, v in radix_study.launches_ms(lambda: k13.sort_rows(xr))]
    bound = roofline(k13.floor_bytes(p, n))
    design = roofline(k13.design_bytes(p, n))["bound_ms"]
    print(f"[3 K13 sort_rows] rows ({p}, {n}) with NaN, constant, sign-bit "
          f"NaN and signed-zero rows: keys bit for bit and positions equal to "
          f"torch.sort(dim=1, stable=True) and to its plain version, keys "
          f"only equal, two runs bit-equal; kernel {ms:.3f} ms (keys only "
          f"{keys_ms:.3f}), bound {bound['bound_ms']:.3f} "
          f"({bound['bound_ms'] / ms:.0%}; the design's 68 B an entry "
          f"{design:.3f}, {design / ms:.0%}), plain {plain_ms:.3f} ms, "
          f"torch.sort {lib_ms:.3f} ms (host-bound: its ~1280 launches and "
          f"~1500 memsets outlast the timer's queue; device "
          f"{lib_device_ms:.3f} ms under the profiler); launches: "
          + ", ".join(f"{k} {v:.3f}" for k, v in pieces))
    del xr

    exact = mtt.ess_rhat(x3, kind="rank")
    keep = ranknorm.sort_rows
    ranknorm.sort_rows = k13.sort_rows_plain
    try:
        plain = mtt.ess_rhat(x3, kind="rank")
    finally:
        ranknorm.sort_rows = keep
    torch.cuda.synchronize()
    check(torch.equal(exact.ess, plain.ess) and torch.equal(exact.rhat,
                                                            plain.rhat),
          "the exact call through K13 differs from its plain route")
    prof = profile_calls.profile_call(lambda: mtt.ess_rhat(x3, kind="rank"),
                                      top=10**6)
    cub = sum(c for name, _, c in prof["kernels"] if "RadixSort" in name)
    print(f"[3 K13 exact call] ess_rhat(kind='rank') through K13 and through "
          f"its plain version: bit-equal; under the profiler: cub radix "
          f"launches {cub}, device {prof['device_ms']:.2f} ms, "
          f"{prof['launches']} device launches, idle {prof['idle']:.1%}")
    check(cub == 0, "the exact call still launches cub radix kernels")
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound,
                library_device_ms=lib_device_ms, keys_only_ms=keys_ms,
                design_bound_ms=design,
                launch_ms=pieces, exact_call_cub_radix_launches=cub,
                exact_call_device_ms=prof["device_ms"],
                exact_call_device_launches=prof["launches"])


# K14's modes: (first, positions); the own block with and without positions
# (a one-shard ring: phase 16), a visit with them and one of t alone
K14_MODES = {"own+pos": (True, True), "own t": (True, False),
             "visit+pos": (False, True), "visit t": (False, False)}
# the sharded cell's block on one rank: 50 params x 10,000 draws x 625 chains
K14_CELL_BLOCK = (50, 6_250_000)


def k14_bytes(first: bool, pos: bool) -> int:
    """K14's compulsory bytes an entry of ``a``: the rows read (``a`` alone
    where it counts against itself), the accumulators updated (8 B) or only
    written (4 B), as ``k14_roofline`` counts them."""
    return (4 if first else 8) + (4 if first else 8) * (2 if pos else 1)


def k14_against_plain(tag: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Every mode of K14 on ``a`` against ``b`` (the own block's modes
    against ``a``) bit for bit its plain version's from the same random
    accumulators, one counted launch each."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    start = [torch.randint(0, 2**20, a.shape, generator=g, device="cuda",
                           dtype=torch.int32) for _ in range(2)]
    for mode, (first, pos) in K14_MODES.items():
        for earlier in ((False,) if first else (True, False)):
            got = [x.clone() for x in start]
            want = [x.clone() for x in start]
            if not pos:
                got[1] = want[1] = None
            before = kernels.launch_counts()["K14"]
            k14.merge_count(a, a if first else b, *got, first=first,
                            earlier=earlier)
            check(kernels.launch_counts()["K14"] == before + 1,
                  f"{tag} {mode}: K14 did not launch once")
            k14.merge_count_plain(a, a if first else b, *want, first=first,
                                  earlier=earlier)
            check(all(w is None or torch.equal(x, w)
                      for x, w in zip(got, want)),
                  f"{tag} {mode} (earlier={earlier}): K14 differs from its "
                  "plain version")
            del got, want


def phase_k14(x3: torch.Tensor) -> dict:
    """K14 (the ring route's merge-count) in its four modes, bit for bit its
    plain version's (``merge_count_plain``, ``torch.searchsorted``), at the
    sharded cell's block (50, 6.25M) of sorted normals against another, and
    on the rows phase 16's ring counts (the sample's (256, 1.28M), sorted by
    K13) against the same rows on a grid of 1/4 (ties across the blocks);
    then timed at the cell's block (behind the timer's queue), each mode
    beside its bound (``k14_bytes``), the plain version of a visit with
    positions and one ``torch.searchsorted`` (the library call it
    replaces, two a block), with a visit's launches one by one."""
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import radix_study
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13
    from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm

    xs = k13.sort_rows_keys(ranknorm._rows(x3))
    k14_against_plain("[3 K14, phase 16's rows]", xs, torch.round(xs * 4) / 4)
    ring_shape = tuple(xs.shape)
    del xs

    p, n = K14_CELL_BLOCK
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.sort(torch.randn(K14_CELL_BLOCK, generator=g, device="cuda"),
                   dim=1).values
    b = torch.sort(torch.randn(K14_CELL_BLOCK, generator=g, device="cuda"),
                   dim=1).values
    k14_against_plain("[3 K14, the cell's block]", a, b)
    t = torch.zeros(K14_CELL_BLOCK, dtype=torch.int32, device="cuda")
    gpos = torch.zeros_like(t)
    ms, bound = {}, {}
    for mode, (first, pos) in K14_MODES.items():
        ms[mode] = time_ms(lambda f=first, q=pos: k14.merge_count(
            a, a if f else b, t, gpos if q else None, first=f, earlier=True))
        bound[mode] = roofline(p * n * k14_bytes(first, pos))["bound_ms"]
        t.zero_()
        gpos.zero_()
    plain_ms = time_ms(lambda: k14.merge_count_plain(a, b, t, gpos,
                                                     earlier=True))
    lib_ms = time_ms(lambda: torch.searchsorted(b, a, side="left",
                                                out_int32=True))
    pieces = [(name[:60], v) for name, v in radix_study.launches_ms(
        lambda: k14.merge_count(a, b, t, gpos, earlier=True))]
    del a, b, t, gpos
    print(f"[3 K14 merge_count] every mode bit for bit its plain version's "
          f"on rows {ring_shape} and at the cell's block {K14_CELL_BLOCK}; "
          "ms a launch at the block: "
          + ", ".join(f"{m} {ms[m]:.3f} (bound {bound[m]:.3f}, "
                      f"{bound[m] / ms[m]:.0%})" for m in K14_MODES)
          + f"; plain visit+pos {plain_ms:.3f} ms, torch.searchsorted "
          f"{lib_ms:.3f} ms a search (two a block); visit+pos launches: "
          + ", ".join(f"{k} {v:.3f}" for k, v in pieces))
    return dict(err=0.0, ms=ms["visit+pos"], plain_ms=plain_ms,
                bound_ms=bound["visit+pos"], bound_by="bytes",
                library_ms=lib_ms, shape=list(K14_CELL_BLOCK),
                ring_rows=list(ring_shape), mode_ms=ms, mode_bound_ms=bound,
                launch_ms=pieces)


# the sharded cell's rows of the chain group: 625 chains x 10,000 draws on
# each of four cards
K15_ROW_N = 4 * K14_CELL_BLOCK[1]


def phase_k15() -> dict:
    """K15 (the ring route's Blom scores from its counts) bit for bit its
    plain version's (``blom_scores(t + 1, n)``) on every count of a row of
    1000 entries and 1-7 entries past a multiple of 4, and at the sharded
    cell's block (50, 6.25M) of one rank of four (n = 25M: counts ``2 gpos
    + 1``, ``gpos = 4 j + r``); then timed there (behind the timer's queue,
    fresh counts each call) beside its bound (8 B an entry, as
    ``k15_roofline`` counts it), the plain passes it replaces and an int32
    ``add_`` in place (the library's elementwise rate on the same bytes)."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels
    from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank as k12

    def both(t, n):
        want = k12.blom_scores(t + 1, n, torch.float32)
        before = kernels.launch_counts()["K15"]
        got = k12.blom_from_counts(t.clone(), n)
        check(kernels.launch_counts()["K15"] == before + 1,
              "[3 K15] did not launch once")
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"[3 K15] differs from its plain version at n={n}, "
              f"{t.numel()} counts")

    short = torch.arange(2001, dtype=torch.int32, device="cuda")
    for length in (2001, 1, 2, 3, 5, 6, 7, 1995):
        both(short[:length], 1000)
    p, n_loc = K14_CELL_BLOCK
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    t0 = (8 * torch.arange(n_loc, dtype=torch.int32, device="cuda")
          + 2 * torch.randint(0, 4, K14_CELL_BLOCK, generator=g,
                              dtype=torch.int32, device="cuda") + 1)
    both(t0, K15_ROW_N)
    buf = torch.empty_like(t0)

    def fresh():
        buf.copy_(t0)
        return (buf,)

    ms = time_ms(lambda b: k12.blom_from_counts(b, K15_ROW_N), setup=fresh)
    plain_ms = time_ms(lambda b: k12.blom_scores(b.add_(1), K15_ROW_N,
                                                 torch.float32), setup=fresh)
    lib_ms = time_ms(lambda b: b.add_(1), setup=fresh)
    bound = roofline(p * n_loc * 8)
    del t0, buf
    print(f"[3 K15 blom_from_counts] bit for bit its plain version's on every "
          f"count of a row of 1000 and at the cell's block {K14_CELL_BLOCK}, "
          f"n = {K15_ROW_N}: {ms:.3f} ms (bound {bound['bound_ms']:.3f}, "
          f"{bound['bound_ms'] / ms:.0%}); plain passes {plain_ms:.3f} ms; "
          f"int32 add_ in place {lib_ms:.3f} ms")
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                shape=list(K14_CELL_BLOCK), row_n=K15_ROW_N, **bound)


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
    check(exact_counts["K10"] == 1 and exact_counts["K11"] == 1
          and exact_counts["K12"] == 2 and exact_counts["K13"] == 1,
          "the exact call did not launch K10, K11 and K13 once each, K12 "
          "twice")

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

    # the exact call's fold routes: "auto" (the merge here), "sort", "merge";
    # the bulk ESS does not depend on the fold, and K11's integer sums do not
    # depend on the order of the values
    routes = {}
    for impl in ("auto", "sort", "merge", "sort", "auto"):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = mtt.ess_rhat(x3, kind="rank", fold_impl=impl)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts = kernels.launch_counts()
        check(counts["K11"] == 1 and counts["K10"] == (impl != "sort")
              and counts["K12"] == 2
              and counts["K13"] == 1 + (impl == "sort"),
              f"fold_impl={impl!r}: K10 {counts['K10']}, K11 {counts['K11']}, "
              f"K12 {counts['K12']}, K13 {counts['K13']}")
        check(torch.equal(res.ess, exact.ess)
              and float((res.rhat - exact.rhat).abs().max()) <= 1e-6,
              f"fold_impl={impl!r} disagrees with the default")
        wall = wall_s(lambda: mtt.ess_rhat(x3, kind="rank", fold_impl=impl))
        routes.setdefault(impl, {"walls_s": [], "peak_gb": peak})
        routes[impl]["walls_s"].append(wall)
    for impl, r in routes.items():
        print(f"[4 exact, fold_impl={impl!r}] wall {r['walls_s']} s (median "
              f"of 3 each, in turns auto, sort, merge, sort, auto); peak "
              f"+{r['peak_gb']:.2f} GB above the sample; ESS bit-equal, "
              f"R-hat within 1e-6 of the default")
    return {"counts": fast_counts, "exact_counts": exact_counts,
            "fast": fast, "exact": exact, "numpy_float64_s": np_wall,
            "exact_routes": routes, **walls}


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
    from mcmcdiagnostictools_jl_tpu_torch import kernels

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
    # the exact kinds with a tail R-hat through the merge: K10 and K11 on
    # the card, valley_sort_2d and the plain segment sums on the CPU
    for kind in ("tail", "rank"):
        kernels.reset_launch_counts()
        g = mtt.ess_rhat(x_gpu, kind=kind, fold_impl="merge")
        counts = kernels.launch_counts()
        c = mtt.ess_rhat(x_cpu, kind=kind, fold_impl="merge")
        rhat_abs = float((g.rhat.cpu() - c.rhat).abs().max())
        print(f"[5 exact {kind}, fold_impl='merge'] card vs CPU: R-hat abs "
              f"{rhat_abs:.3e} (bound 1e-4); K10 {counts['K10']}, K11 "
              f"{counts['K11']}, K12 {counts['K12']}")
        check(rhat_abs <= 1e-4 and counts["K10"] == 1 and counts["K11"] == 1
              and counts["K12"] == (2 if kind == "rank" else 1),
              f"exact {kind} with the merge: card != CPU")

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


def phase_sort_study(build_log: str, sass_read) -> dict:
    """K7, K8 and K9 through ``benchmarks.sort_microbench`` and
    ``benchmarks.pass_study`` at 512 tiles of 2048 rows x 128 columns (1.07
    GB of keys and payload); K9 also at pods smaller than a chunk and column
    counts off the 8-column block. ``sass_read``: the future of
    ``pass_study.pass_sass`` (``cuobjdump`` takes ~10 s, so it runs from the
    build on, beside the phases before this one)."""
    from mcmcdiagnostictools_jl_tpu_torch import kernels
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import pass_study
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import sort_microbench as sm
    from mcmcdiagnostictools_jl_tpu_torch.kernels import _build
    from mcmcdiagnostictools_jl_tpu_torch.kernels import sort_study as ss

    ntiles, seed = 512, SEED + 7
    keys, payload = sm.make_arrays(ntiles, seed)
    moved = 2 * keys.numel() * 8  # both arrays read once and written once
    pass_bound = roofline(moved)
    want = ss.pass_plain(keys, payload, 16, 1)
    print(f"[10 data] {keys.shape[0]} x {keys.shape[1]} float32 keys (uniform, "
          f"seed {seed}) + int32 payload, {keys.numel() * 8 / 1e9:.2f} GB; one "
          f"pass moves {moved / 1e9:.2f} GB, bound {pass_bound['bound_ms']:.3f} "
          "ms")
    lib = _build.library()
    for kid, pods, stride in pass_study.GEOMETRIES:
        setting = pass_study.label(kid, pods, stride).split(" ", 1)[1]
        plan = ss.card_pass_plan(lib, keys, pods, stride or 1,
                                 contiguous=stride is None)
        k_out, p_out = keys.clone(), payload.clone()
        if stride is None:
            ss.pass_contig(k_out, p_out, pods)
        else:
            ss.pass_strided(k_out, p_out, pods, stride)
        torch.cuda.synchronize()
        same = torch.equal(k_out, want[0]) and torch.equal(p_out, want[1])
        print(f"[10 {kid} {setting}] equal to the plain version: {same}; "
              f"{plan['tasks']} tasks of {pods} segments of "
              f"{plan['seg_rows']} rows, stages of {plan['stage_bytes']} B x "
              f"{plan['stages']}, grid {plan['grid']} ({plan['blocks_per_sm']}"
              " a multiprocessor)")
        check(same, f"{kid} ({setting}) differs from its plain version")
        del k_out, p_out
    # in turns with add_ and the plain version, on one pair of arrays in place
    k_run, p_run = keys.clone(), payload.clone()
    kernels.reset_launch_counts()
    ms = pass_study.interleaved_ms(pass_study.pass_calls(k_run, p_run))
    counts = kernels.launch_counts()
    del k_run, p_run, want
    library_ms, plain_ms = ms.pop("add_"), ms.pop("plain")
    print(f"[10 K7/K8 in turns] median of {pass_study.ROUNDS}: add_ in place "
          f"{library_ms:.4f} ms, plain (keys + 1, payload + 1) {plain_ms:.4f}"
          " ms")
    out = {}
    for name, t in ms.items():
        kid, setting = name.split(" ", 1)
        gbps = moved / 1e9 / (t / 1e3)
        print(f"[10 {kid} {setting}] {t:.4f} ms, {t / library_ms:.3f} x add_, "
              f"{pass_bound['bound_ms'] / t:.1%} of the bound, {gbps:.0f} GB/s")
        row = out.setdefault(kid, dict(err=0.0, ms=t, plain_ms=plain_ms,
                                       library_ms=library_ms, **pass_bound,
                                       settings={}))
        row["settings"][setting] = {"ms": t, "gbps": gbps,
                                    "vs_add_": t / library_ms}
    # the pass kernel's copies, from the build: bulk copies, no cp.async
    print(f"[10 K7/K8 build] {ptxas_lines(build_log, 'pass_kernel')}")
    for name, sass in sass_read.result().items():
        print(f"[10 K7/K8 SASS] {name[:40]}...: bulk copies {sass['bulk']}, "
              f"LDGSTS {sass['LDGSTS']}")
        check(sum(sass["bulk"].values()) > 0 and sass["LDGSTS"] == 0,
              f"{name}: not moved by bulk copies alone")

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
    counts = kernels.launch_counts()
    check(counts["K1"] >= 4 and counts["K12"] == 8 and counts["K13"] == 8,
          "K1 did not run in every chunk, or K12 or K13 not twice in each")
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


def phase_rstar_bigk() -> dict:
    """BASELINE.md config 5's R* (benchmarks/suite.py: 100 draws x 10,000
    chains x 4 params, standard normal float32, seed 0) through
    ``GBTClassifier(n_rounds=20, n_bins=32, class_chunk=256)`` with rng=0:
    20,000 split-chain classes on ~700k training rows through the
    class-chunked fit, which must run; the mean must lie in [0.9, 1.1].
    Wall and peak device memory of one run. Then the first 256 chains
    through the dense fit and the class-chunked fit (64 classes a chunk):
    splits equal, leaf values within 5e-6."""
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
            "slice_leaf_value_max_abs": lv_err,
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
    K1, K2 and K10 (not on the sharded path) never."""
    shown = {k: counts[k] for k in ("K1", "K2", "K3", "K4", "K4z", "K5",
                                    "K10", "K11", "K12", "K13", "K14",
                                    "K15")}
    print(f"   {tag} launches: {shown}")
    for kid, n in {"K1": 0, "K2": 0, "K10": 0, **want}.items():
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
        check_launches(tag, counts, {"K3": 2, "K4": 2, "K5": None, "K11": 0,
                                     "K12": 0, "K14": 0, "K15": 0}
                       if impl == "hist" else
                       {"K3": 0, "K4": 0, "K5": None, "K11": 1,
                        "K12": 2 if impl == "gather" else 0,
                        "K14": 2 if impl == "ring" else 0,
                        "K15": 2 if impl == "ring" else 0})
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
            "launches": {k: counts[k] for k in ("K3", "K4", "K4z", "K5",
                                                 "K11", "K12", "K14",
                                                 "K15")}}
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
        check_launches(tag, counts, {"K3": 2, "K4": 2, "K5": 0, "K11": 0,
                                     "K12": 0, "K14": 0, "K15": 0}
                       if impl == "hist" else
                       {"K3": 0, "K4": 0, "K5": 0, "K11": 2,
                        "K12": 2 if impl == "gather" else 0,
                        "K14": 2 if impl == "ring" else 0,
                        "K15": 2 if impl == "ring" else 0})
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
                                 "K4": 2 * stats.n_chunks, "K5": None,
                                 "K12": 0, "K14": 0, "K15": 0})
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


# ---- phase 17: sign-bit NaNs in the exact rank mode -------------------------

NAN_COL, NAN_MIX_COL = 5, 6  # all sign-bit NaN; one among numbers


def with_nans(x3: torch.Tensor, bits: int) -> torch.Tensor:
    """A copy of the sample whose column NAN_COL holds only the float32 NaN
    with these bits, and column NAN_MIX_COL one such NaN among numbers."""
    nan = torch.tensor([bits], dtype=torch.int32).view(torch.float32)
    x = x3.clone()
    x[:, :, NAN_COL] = nan.to(x.device)
    x[DRAWS // 3, CHAINS // 2, NAN_MIX_COL] = nan.to(x.device)[0]
    return x


def phase_signed_nans(x3: torch.Tensor) -> dict:
    """The exact calls on the flagship sample with sign-bit NaNs
    (``0xffc00000``, which the card's radix sort may put first) in two
    columns, run on a world of one rank over NCCL: ``ess_rhat(kind="rank")``
    with ``fold_impl`` sort and merge, ``ess`` of the median and mad kinds,
    ``mcse`` of ``Quantile(0.25)``, ``ess_rhat_streaming`` in exact mode and
    ``ess_rhat_sharded`` (gather, ring). Those two columns must be NaN, and
    every other column bit-equal to the same sample's with ``+nan``
    (``0x7fc00000``) in their place. Also where the card's sort put the NaNs
    and what the NaN-row test costs beside the JAX package's rule."""
    from mcmcdiagnostictools_jl_tpu_torch import parallel
    from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm

    import mcmcdiagnostictools_jl_tpu_torch as mtt

    neg, pos = with_nans(x3, -0x400000), with_nans(x3, 0x7FC00000)
    check(int(neg[0, 0, NAN_COL].view(torch.int32)) == -0x400000
          and int(pos[0, 0, NAN_COL].view(torch.int32)) == 0x7FC00000,
          "NaN bits not as written")
    xs, _, bad = ranknorm.sort_with_positions(neg)
    ends = {c: (bool(torch.isnan(xs[c, 0])), bool(torch.isnan(xs[c, -1])))
            for c in (NAN_COL, NAN_MIX_COL)}
    order = ("first" if ends[NAN_MIX_COL] == (True, False) else
             "last" if ends[NAN_MIX_COL] == (False, True) else "elsewhere")
    print(f"[17 order] the card's sort puts the sign-bit NaN among numbers "
          f"(column {NAN_MIX_COL}) {order}: ends (first, last) NaN {ends}")
    check(bad.tolist() == [c in (NAN_COL, NAN_MIX_COL) for c in range(PARAMS)],
          "sort_with_positions missed a NaN row")
    helper_ms = time_ms(lambda: ranknorm._nan_rows(xs))
    any_ms = time_ms(lambda: torch.isnan(xs).any(1))
    del xs
    print(f"[17 cost] the NaN-row test on the sorted rows (256, 1.28M): two "
          f"ends {helper_ms:.4f} ms, isnan(xs).any(1) (the JAX package's "
          f"rule) {any_ms:.4f} ms")
    cfg = parallel.make_mesh()
    host = {"neg": neg.cpu().numpy(), "pos": pos.cpu().numpy()}
    calls = {
        "ess_rhat rank, fold sort":
            lambda x: mtt.ess_rhat(x, kind="rank", fold_impl="sort"),
        "ess_rhat rank, fold merge":
            lambda x: mtt.ess_rhat(x, kind="rank", fold_impl="merge"),
        "ess median": lambda x: mtt.ess(x, kind="median"),
        "ess mad": lambda x: mtt.ess(x, kind="mad"),
        "mcse Quantile(0.25)": lambda x: mtt.mcse(x, kind=mtt.Quantile(0.25)),
        "ess_rhat_streaming exact, chunks of 64":
            lambda x: mtt.ess_rhat_streaming(host[x], rank_mode="exact",
                                             param_chunk=64),
        "ess_rhat_sharded gather":
            lambda x: parallel.ess_rhat_sharded(x, cfg, rank_impl="gather"),
        "ess_rhat_sharded ring":
            lambda x: parallel.ess_rhat_sharded(x, cfg, rank_impl="ring"),
    }
    keep = torch.ones(PARAMS, dtype=torch.bool)
    keep[[NAN_COL, NAN_MIX_COL]] = False
    out = {"order": order, "nan_rows_ms": helper_ms, "isnan_any_ms": any_ms}
    for name, fn in calls.items():
        args = ("neg", "pos") if "streaming" in name else (neg, pos)
        t0 = time.perf_counter()
        got, want = (fn(a) for a in args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        for g, w in zip(got, want):
            g, w = g.cpu(), w.cpu()
            check(bool(torch.isnan(g[~keep]).all()),
                  f"[17 {name}]: a sign-bit NaN column is not NaN")
            check(bool(torch.isfinite(g[keep]).all())
                  and torch.equal(g[keep], w[keep]),
                  f"[17 {name}]: the other columns differ from +nan's")
        print(f"[17 {name}] columns {NAN_COL}, {NAN_MIX_COL} NaN, the other "
              f"{int(keep.sum())} bit-equal to the +nan sample's ({wall:.2f} s "
              "for both)")
        out[name] = wall
    return out


# ---- phase 18: HMC on the card, then the diagnostics on its trace -----------

HMC_MAX_LEAPFROG = 16
HMC_PROFILE_DRAWS = 20


def hmc_run(tag: str, smi: str, logpdf, chains: int, dim: int, draws: int,
            step: float, seed: int):
    """``models.hmc_sample`` from a seeded generator on the card, float32:
    ``(trace, wall s)``; prints the sampler's rates."""
    from mcmcdiagnostictools_jl_tpu_torch import models

    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = 0.5 * torch.randn((chains, dim), device="cuda", generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = models.hmc_sample(logpdf, init, gen, num_samples=draws,
                           step_size=step, max_leapfrog=HMC_MAX_LEAPFROG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tr.samples.shape == (draws, chains, dim)
          and tr.energy.shape == (draws, chains)
          and all(v.device.type == "cuda" and v.dtype == torch.float32
                  for v in tr)
          and bool(torch.isfinite(tr.energy).all()),
          f"{tag}: bad trace")
    steps = draws * HMC_MAX_LEAPFROG
    acc = tr.accept_rate
    print(f"{tag} {draws} draws x {chains} chains x {dim}: sampler wall "
          f"{wall:.2f} s, {draws / wall:.1f} draws/s, "
          f"{steps * chains / wall:.4g} gradient evaluations/s (one a chain "
          f"a leapfrog step; {steps / wall:.1f} batched gradients/s); accept "
          f"{float(acc.min()):.3f}..{float(acc.max()):.3f} ({smi})")
    return tr, wall


def phase_hmc(smi: str) -> dict:
    """HMC on the card at full width, then the diagnostics on its trace:
    BASELINE.md config 2 (eight schools, 8 chains x 10 params x 1000
    draws, as ``benchmarks/suite.py:config2``) with
    ``tests/test_integration.py::TestEightSchools``'s properties; Cauchy at
    the flagship's 128 chains x 256 params x 1000 draws with
    ``TestCauchyHeavyTails``'s, and the fast and exact ``ess_rhat`` (K1-K4;
    K10, K11) and ``mcse`` with ``PallasAutocovMethod`` (K5) on it, each
    with its launches counted from 0; the deterministic core on the same
    float64 draws on the card and on the CPU (1e-8); the sampler's device
    operations per leapfrog step and the card's idle share over 20 draws;
    ``utils.profiling.trace`` around one fast ``ess_rhat``."""
    import glob
    import os
    import tempfile

    from mcmcdiagnostictools_jl_tpu_torch import models
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import profile_calls
    from mcmcdiagnostictools_jl_tpu_torch.models.hmc import hmc_transitions
    from mcmcdiagnostictools_jl_tpu_torch.utils import profiling

    import mcmcdiagnostictools_jl_tpu_torch as mtt

    out = {}
    # config 2: eight schools
    tr, wall = hmc_run("[18 config 2, eight schools]", smi,
                       models.eight_schools_logpdf, 8, 10, 1000, 0.2, SEED)
    x, schools_last = tr.samples, tr.samples[-1]
    t0 = time.perf_counter()
    r = mtt.ess_rhat(x)
    se = {k: mtt.mcse(x, kind=kind) for k, kind in (
        ("mean", "mean"), ("std", "std"), ("q25", mtt.Quantile(0.25)))}
    b = mtt.bfmi(tr.energy)
    torch.cuda.synchronize()
    diag_s = time.perf_counter() - t0
    sd = x.reshape(-1, 10).std(0)
    print(f"[18 config 2] R-hat max {float(r.rhat.max()):.4f} (< 1.05), ESS "
          f"min {float(r.ess.min()):.1f} (> 100), MCSE mean / sd max "
          f"{float((se['mean'] / sd).max()):.4f} (in (0, 1)), MCSE std min "
          f"{float(se['std'].min()):.4g}, MCSE q25 min "
          f"{float(se['q25'].min()):.4g}; BFMI {[round(float(v), 3) for v in b]}"
          f"; diagnostics {diag_s:.3f} s ({smi})")
    check(bool((r.rhat < 1.05).all()) and bool((r.ess > 100).all()),
          "config 2: not converged")
    check(bool((se["mean"] > 0).all()) and bool((se["mean"] < sd).all()),
          "config 2: MCSE not within (0, posterior sd)")
    check(all(bool((v > 0).all() & torch.isfinite(v).all())
              for v in se.values()) and bool(torch.isfinite(b).all()),
          "config 2: MCSE or BFMI not finite and positive")
    out["config2"] = {"sampler_wall_s": wall, "draws_per_s": 1000 / wall,
                      "diagnostics_s": diag_s,
                      "rhat_max": float(r.rhat.max()),
                      "ess_min": float(r.ess.min())}

    # Cauchy at the flagship's widths
    tr, wall = hmc_run("[18 Cauchy]", smi, models.cauchy_logpdf, CHAINS,
                       PARAMS, 1000, 0.25, SEED + 1)
    x = tr.samples
    check(bool((tr.accept_rate > 0.6).all()), "Cauchy: an accept rate <= 0.6")
    launches, walls = {}, {}
    for name, fn, want in (
            ("ess_rhat fast", lambda: mtt.ess_rhat(x, kind="rank",
                                                   rank_mode="fast"),
             ("K1", "K2", "K3", "K4")),
            ("ess_rhat exact", lambda: mtt.ess_rhat(x, kind="rank"),
             ("K1", "K10", "K11", "K12", "K13")),
            ("mcse mean, PallasAutocovMethod",
             lambda: mtt.mcse(x, kind="mean",
                              autocov_method=mtt.PallasAutocovMethod()),
             ("K5",))):
        res, counts, first, w = counted_call(fn)
        for v in (res if isinstance(res, tuple) else (res,)):
            check(v.shape == (PARAMS,) and bool(torch.isfinite(v).all()),
                  f"Cauchy {name}: bad output")
        shown = {k: counts[k] for k in ("K1", "K2", "K3", "K4", "K5", "K10",
                                        "K11", "K12", "K13")}
        print(f"[18 Cauchy {name}] launches {shown}; wall {w:.4f} s (median "
              f"of 3; first call {first:.3f} s) ({smi})")
        for kid in want:
            check(counts[kid] >= 1, f"Cauchy {name}: {kid} did not launch")
        for kid, n in shown.items():
            launches[kid] = launches.get(kid, 0) + n
        walls[name] = w
    bulk, tail = mtt.ess(x, kind="bulk"), mtt.ess(x, kind="tail")
    b = mtt.bfmi(tr.energy)
    mb, mt = float(bulk.median()), float(tail.median())
    print(f"[18 Cauchy] median bulk-ESS {mb:.1f} (> 50), median tail-ESS "
          f"{mt:.1f} (< 0.8 x bulk), BFMI max {float(b.max()):.3f} (< 1)")
    check(mt < 0.8 * mb and mb > 50, "Cauchy: tail-ESS does not lag bulk-ESS")
    check(bool((b < 1).all()), "Cauchy: a BFMI >= 1")
    out["cauchy"] = {"sampler_wall_s": wall, "draws_per_s": 1000 / wall,
                     "grad_evals_per_s": 1000 * HMC_MAX_LEAPFROG * CHAINS
                     / wall, "diagnostics_walls_s": walls,
                     "median_bulk_ess": mb, "median_tail_ess": mt,
                     "bfmi_max": float(b.max()),
                     "accept_min": float(tr.accept_rate.min())}

    # the deterministic core, card against CPU, on the same float64 draws
    g = torch.Generator().manual_seed(SEED)
    dims = (16, PARAMS)
    inputs = (0.5 * torch.randn(dims, dtype=torch.float64, generator=g),
              torch.randn((50,) + dims, dtype=torch.float64, generator=g),
              torch.randint(1, HMC_MAX_LEAPFROG + 1, (50, 16), generator=g),
              torch.rand((50, 16), dtype=torch.float64, generator=g))
    kw = dict(step_size=0.25, max_leapfrog=HMC_MAX_LEAPFROG)
    cpu = hmc_transitions(models.cauchy_logpdf, *inputs, **kw)
    card = hmc_transitions(models.cauchy_logpdf,
                           *(v.cuda() for v in inputs), **kw)
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
    print(f"[18 core, card vs CPU] 16 chains x {PARAMS} x 50 draws, float64: "
          f"max abs diff {diff:.3e} (bound 1e-8)")
    check(diff <= 1e-8, "the HMC core differs between the card and the CPU")
    out["core_card_vs_cpu"] = diff

    # the sampler's device operations per leapfrog step and idle share,
    # from the last state of each run
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out["profile"] = {}
    for name, logpdf, init in (("Cauchy", models.cauchy_logpdf, x[-1]),
                               ("config 2", models.eight_schools_logpdf,
                                schools_last)):
        shape = (HMC_PROFILE_DRAWS,) + tuple(init.shape)
        draws = (torch.randn(shape, device="cuda", generator=gen),
                 torch.randint(1, HMC_MAX_LEAPFROG + 1, shape[:2],
                               device="cuda", generator=gen),
                 torch.rand(shape[:2], device="cuda", generator=gen))
        prof = profile_calls.profile_call(
            lambda: hmc_transitions(logpdf, init.contiguous(), *draws, **kw))
        per_step = prof["launches"] / (HMC_PROFILE_DRAWS * HMC_MAX_LEAPFROG)
        print(f"[18 profile] {HMC_PROFILE_DRAWS} {name} draws: wall "
              f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.2f} ms, "
              f"idle {prof['idle'] * 100:.1f} %, {prof['launches']} device "
              f"operations, {per_step:.1f} a leapfrog step; top "
              + ", ".join(f"{n[:40]} {ms:.2f} ms x{c}"
                          for n, ms, c in prof["kernels"][:4]) + f" ({smi})")
        out["profile"][name] = {"wall_ms": prof["wall_ms"],
                                "device_ms": prof["device_ms"],
                                "idle": prof["idle"],
                                "launches_per_leapfrog_step": per_step}

    # utils.profiling.trace around one fast ess_rhat
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            with profiling.annotate("mdt.smoke.fast_ess_rhat"):
                mtt.ess_rhat(x, kind="rank", rank_mode="fast")
        files = glob.glob(os.path.join(d, "*.pt.trace.json"))
        check(len(files) == 1, f"trace wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        k1 = [e for e in events if e.get("cat") == "kernel"
              and "moments_autocov_kernel" in e.get("name", "")]
        region = any(e.get("name") == "mdt.smoke.fast_ess_rhat"
                     for e in events)
        print(f"[18 trace] {os.path.getsize(files[0]) / 1e6:.2f} MB, "
              f"{len(events)} events, {len(k1)} K1 kernel events, the "
              f"annotated region {'present' if region else 'missing'}")
        check(bool(k1) and region, "the trace lacks K1 or the region")
    out["launches"] = launches
    return out


def main() -> int:
    started = time.perf_counter()
    dev = phase_device()
    # (fails outside the repo)
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import pass_study, profile_calls

    build_log = phase_build()
    sass_reader = concurrent.futures.ThreadPoolExecutor(1)
    sass_read = sass_reader.submit(pass_study.pass_sass)
    t0 = time.perf_counter()
    bad_param = 0
    # an eighth of the chains of parameter 0 sit 4 sd off: the rank-based
    # R-hat of 128 chains cannot be pushed past 1.1 by one chain alone
    x3 = profile_calls.make_sample(SEED, (DRAWS, CHAINS, PARAMS), device="cuda")
    print(f"[data] AR(1) phi=0.5 {DRAWS}x{CHAINS}x{PARAMS} f32 on the card "
          f"({x3.numel() * 4 / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")

    rows = phase_kernels(x3)
    fold = phase_fold_kernels(x3)
    k13_row = phase_k13(x3)
    k14_row = phase_k14(x3)
    k15_row = phase_k15()
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
    sort = phase_sort_study(build_log, sass_read)
    sass_reader.shutdown()
    fast, exact = e2e.pop("fast"), e2e.pop("exact")
    streaming = phase_streaming(x3, fast, exact)
    start_world_of_one()
    sharded = phase_sharded(x3, fast, exact, {"fast": e2e["fast_s"],
                                              "exact": e2e["exact_s"],
                                              "streamed": streaming["wall_s"]},
                            streaming.pop("host"), streaming.pop("result"))
    signed_nans = phase_signed_nans(x3)
    del x3, fast, exact
    discrete = phase_discretediag()
    rstar_dense = phase_rstar_dense()
    sharded["gbt"] = phase_sharded_gbt(*rstar_dense.pop("one_state"),
                                       rstar_dense["fit_s"])
    torch.distributed.destroy_process_group()
    rstar_bigk = phase_rstar_bigk()
    float64 = phase_float64()
    hmc = phase_hmc(dev["smi"])

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
        ("K10 valley_merge", src + "valley_merge.cu",
         "mcmcdiagnostictools_jl_tpu/ops/ranknorm.py:122"),
        ("K11 segment_moments", src + "segment_moments.cu",
         "mcmcdiagnostictools_jl_tpu/ops/seghist.py:55"),
        ("K12 tied_blom", src + "tied_ranks.cu",
         "mcmcdiagnostictools_jl_tpu/ops/ranknorm.py:65"),
        ("K13 sort_rows", src + "radix_sort.cu",
         "mcmcdiagnostictools_jl_tpu/ops/ranknorm.py:26"),
        ("K14 merge_count", src + "merge_count.cu",
         "mcmcdiagnostictools_jl_tpu/parallel/ring_rank.py:63"),
        ("K15 blom_from_counts", src + "tied_ranks.cu",
         "mcmcdiagnostictools_jl_tpu/parallel/ring_rank.py"
         "::rank_normal_from_counts"),
    ]
    rows += [lag["rows"]["a"], lag["rows"]["b"]]
    rows += [sort["rows"][kid] for kid in ("K7", "K8", "K9")]
    rows += fold["rows"] + [k13_row, k14_row, k15_row]
    # K1-K4 launches: the fast ess_rhat call of phase 4; K5: the marker
    # calls of phase 6; K4z: the FUSE_BLOM_Z call of phase 7; K6: the
    # micro_lagloop runs of phase 9; K7-K9: the sort_microbench runs of
    # phase 10; K10-K13: the exact ess_rhat call of phase 4 (K1-K4 in
    # the streamed run: "streaming" in the line above); K14 and K15: phase
    # 16's ring ess_rhat_sharded call (a one-shard ring: its own block
    # twice, the scores of each)
    launches = {**e2e["counts"], "K5": est["k5_launches"],
                "K10": e2e["exact_counts"]["K10"],
                "K11": e2e["exact_counts"]["K11"],
                "K12": e2e["exact_counts"]["K12"],
                "K13": e2e["exact_counts"]["K13"],
                "K14": sharded["ess_rhat"]["ring"]["launches"]["K14"],
                "K15": sharded["ess_rhat"]["ring"]["launches"]["K15"],
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
        kid = name.split()[0]
        if kid in hmc["launches"]:  # the diagnostics on the HMC trace
            entry["hmc_launches"] = hmc["launches"][kid]
        entry.update(row)
        kernels_out.append(entry)
    print(json.dumps({"wall_fast_s": e2e["fast_s"], "wall_exact_s": e2e["exact_s"],
                      "exact_fold_routes": e2e["exact_routes"],
                      "exact_layout_ms": fold["layout_ms"],
                      "wall_numpy_float64_s": e2e["numpy_float64_s"],
                      **est["walls"],
                      "fast_vs_exact_max_rel_dev": est["fast_vs_exact_max_rel_dev"],
                      **fz["walls"], "fused_vs_unfused": fz["fused_vs_unfused"],
                      "classical": classical, "streaming": streaming,
                      "discretediag": discrete, "rstar_dense": rstar_dense,
                      "rstar_config5": rstar_bigk, "float64": float64,
                      "sharded": sharded, "signed_nans": signed_nans,
                      "hmc": {k: v for k, v in hmc.items()
                              if k != "launches"}}))
    print(f"[total] {time.perf_counter() - started:.1f} s, the build "
          "included")
    print(dev["smi"])
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
