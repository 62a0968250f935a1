"""span.nested.device_ms (ms): device ms a pass launched inside the port's
``mdt.nested`` regions: nested R-hat's superchain gather, split and
two-level reduction. By region (``portbench/spans.py``); None where the
program opens no such region."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx.trace, ("mdt.nested",))
