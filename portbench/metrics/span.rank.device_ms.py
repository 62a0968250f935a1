"""span.rank.device_ms (ms): device ms a pass launched inside the port's
rank-transform regions (``mdt.rank.exact``, ``mdt.rank.fast``): every
operation of the exact or the fast rank transforms, the kernels and the
generic PyTorch glue around them (transposes, median, Blom and fold), and
the tail R-hat's moments, whatever the kernels are named. By region
(``portbench/spans.py``); None where the program opens no such region."""

from portbench.spans import RANK, device_ms


def read(ctx):
    return device_ms(ctx.trace, RANK)
