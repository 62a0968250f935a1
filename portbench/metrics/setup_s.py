"""setup_s (s): from the start of the harness's process to the first timed
pass: imports, the CUDA context, the kernel library (built on a checkout's
first run), the sample made on the card and the warm-up passes."""


def read(ctx):
    return ctx.setup_s
