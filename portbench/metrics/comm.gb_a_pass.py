"""comm.gb_a_pass (GB): the bytes rank 0 of a world sent and received a pass
through the port's collectives, by its own counter
(``utils.profiling.comm_counts()``: the block exchanges' bytes, and the
all-reduces' and all-gathers' as the ring algorithm moves them), in 1e9
bytes. The counter runs from the process's start, so it is read once the
traced window has closed, over every pass the run made: the warm-up and the
traced passes. None where the program has no counter or counted nothing."""

from portbench.run import WARMUP_PASSES


def read(ctx):
    try:
        from mcmcdiagnostictools_jl_tpu_torch.utils.profiling import comm_counts
    except ImportError:
        return None
    counts = comm_counts()
    if ctx.trace is None or not ctx.passes or not counts:
        return None
    moved = sum(c["sent"] + c["received"] for c in counts.values())
    return moved / 1e9 / (ctx.passes + WARMUP_PASSES)
