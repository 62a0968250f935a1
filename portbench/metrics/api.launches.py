"""api.launches (launches): device operations a pass (kernels, memsets and
copies, as the profiler records them) in the traced window; the public
API's cost in launches, each of which the host has to issue."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.trace.passes
