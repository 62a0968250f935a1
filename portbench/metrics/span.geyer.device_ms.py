"""span.geyer.device_ms (ms): device ms a pass launched inside the port's
``mdt.geyer`` regions: Geyer's reduction of the autocorrelation to an ESS.
By region (``portbench/spans.py``); None where the program opens no such
region."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx.trace, ("mdt.geyer",))
