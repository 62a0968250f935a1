"""api.idle_in_call_ms (ms): idle ms a pass inside the port's public call
regions (``mdt.ess_rhat``, ``mdt.ess``, ``mdt.rhat``, ``mdt.rhat_nested``):
the stretches of the traced window in which no device operation ran while
the port's own host code ran a call. None where the program opens no such
region."""

from portbench.spans import idle_in_calls


def read(ctx):
    if ctx.trace is None:
        return None
    return idle_in_calls(ctx.trace)
