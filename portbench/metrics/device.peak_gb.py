"""device.peak_gb (GB): ``torch.cuda.max_memory_allocated()`` over the window
(peak statistics reset after the warm-up) above what was allocated before
it, the resident sample; what a pass needs beside its input."""


def read(ctx):
    if ctx.device_kind == "cpu":
        return None
    return ctx.peak_above_sample_bytes / 1e9
