"""diag_rate (Gvalues/s): draws x chains x params of every pass completed in
the window, over the whole window's seconds (host clock; each pass ends
with its results on the host)."""


def read(ctx):
    if not ctx.passes or ctx.window_s <= 0:
        return None
    return ctx.passes * ctx.values_per_pass / ctx.window_s / 1e9
