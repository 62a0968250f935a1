"""pass_p95_ms (ms): the 95th percentile, by nearest rank, of every pass in
the window, each timed on the host clock from its call to its results on
the host."""

import math


def p95(values):
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def read(ctx):
    return p95(ctx.pass_s) * 1e3 if ctx.pass_s else None
