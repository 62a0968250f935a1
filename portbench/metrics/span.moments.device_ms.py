"""span.moments.device_ms (ms): device ms a pass launched inside the port's
``mdt.moments`` regions: the split chains and their copies, the split-chain
moments, the autocovariance (K1, or K5 where a call takes it) and the
autocorrelation. By region (``portbench/spans.py``); None where the
program opens no such region."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx.trace, ("mdt.moments",))
