"""span.ring.device_ms (ms): device ms a pass launched inside the port's
``mdt.rank.ring`` regions, on rank 0 of a world: the ring route's rank
transforms, its local sorts, the merge-counts of its own block against
each visiting one, the Blom scores, the median's local part and the fold.
By region (``portbench/spans.py``); None where the program opens no such
region."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx.trace, ("mdt.rank.ring",))
