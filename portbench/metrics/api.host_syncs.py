"""api.host_syncs (syncs): the port's host waits for the device a pass, by
its own counter (``utils.profiling.sync_counts()``: one a pass through a
host-sync site). The counter runs from the process's start, so it is read
once the traced window has closed, over every pass the run made: the
warm-up and the traced passes. None where the program has no counter."""

from portbench.run import WARMUP_PASSES


def read(ctx):
    try:
        from mcmcdiagnostictools_jl_tpu_torch.utils.profiling import sync_counts
    except ImportError:
        return None
    if ctx.trace is None or not ctx.passes:
        return None
    return sum(sync_counts().values()) / (ctx.passes + WARMUP_PASSES)
