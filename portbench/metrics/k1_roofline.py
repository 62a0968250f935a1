"""k1_roofline (%): K1's share of its roofline, the least time the card
could take for the lags the call computes, over the device time of K1's
launches.

One launch over ``series`` split chains of ``n`` draws up to lag ``L``:

- operations: ``series x (2 sum_{l=0..L} (n - l) + 4 n)``: a multiply and
  an add for each lagged product, and per draw one add for the mean, one
  subtraction to centre it, one comparison each for the minimum and the
  maximum;
- bytes: ``series x 4 (n + 4 + L + 1)``: the series read once, its mean,
  variance, minimum, maximum and ``L + 1`` autocovariances written once.

The least time is the larger of operations / float32 peak and bytes / HBM
rate (``peaks.json``). The lags: the call clamps ``maxlag`` (250) to ``n -
4``; from 128 lags on it computes lags 0..64 first and the full ``maxlag``
only where some series' Geyer walk has not stopped, so a pass's launches
(the port's K1 counter) say which of the two it made. A pass that calls the
port once a parameter slice makes the probe once a call, over that call's
series, and the full depth in as many calls as it has launches beyond them.
"""

from portbench.readers import device_s, matching, peaks

MAXLAG, PROBE, PROBE_FROM, SPLIT = 250, 64, 128, 2


def ops_bytes(n: int, series: int, lag: int) -> tuple[int, int]:
    products = (lag + 1) * n - lag * (lag + 1) // 2
    return series * (2 * products + 4 * n), series * 4 * (n + 4 + lag + 1)


def lags_of_pass(n: int, launches: int, calls: int = 1) -> list[int]:
    maxlag = min(MAXLAG, n - 4)
    if maxlag >= PROBE_FROM:
        probes = min(launches, calls)
        return [PROBE] * probes + [maxlag] * (launches - probes)
    return [maxlag] * launches


def read(ctx):
    pk = peaks(ctx)
    ev = matching(ctx, ("moments_autocov_kernel",))
    if pk is None or not ev:
        return None
    c = ctx.config
    n = c["draws"] // SPLIT
    series = c["chains"] * SPLIT * c["params"] // ctx.calls_a_pass
    a_pass = round(ctx.launches.get("K1", 0) / ctx.trace.passes)
    lags = lags_of_pass(n, a_pass, ctx.calls_a_pass)
    if not lags:
        return None
    least = 0.0
    for lag in lags:
        ops, nbytes = ops_bytes(n, series, lag)
        least += max(ops / pk["fp32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least * ctx.trace.passes / device_s(ev)
