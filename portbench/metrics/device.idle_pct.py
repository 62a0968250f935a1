"""device.idle_pct (%): the share of the traced window in which no device
operation ran: 1 - (union of the device's intervals) / window."""

from portbench import trace


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    lo, hi = tr.window
    return 100.0 * (1.0 - trace.busy_us(tr) / (hi - lo))
