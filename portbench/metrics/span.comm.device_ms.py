"""span.comm.device_ms (ms): device ms a pass launched inside the port's
``mdt.comm`` regions, on rank 0 of a world: every collective of the sharded
path and the ring route's block exchanges, NCCL's kernels on NCCL's own
stream included (each paired with its launch by correlation id). By region
(``portbench/spans.py``); None where the program opens no such region."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx.trace, ("mdt.comm",))
