"""k15_roofline (%): K15's share of its roofline in a world of ranks: the
compulsory bytes of rank 0's Blom scores from the ring's counts over the
device time of K15's launches (``blom_counts_kernel``). None outside a
world or where K15 did not run.

A launch turns the int32 counts of a rank's block of ``params x draws x
chains / chain shards`` entries over the calls a pass makes (every rank of
the world holds as many chains; the harness's mesh shards the chains over
the whole world) into float32 scores written over them: 8 B an entry, the
count read and the score written, at the card's HBM rate
(``peaks.json``)."""

import torch.distributed as dist

from portbench.readers import device_s, matching, peaks

ENTRY_B = 8  # the int32 count read, the float32 score written


def read(ctx):
    if not (dist.is_available() and dist.is_initialized()):
        return None
    pk = peaks(ctx)
    ev = matching(ctx, ("blom_counts_kernel",))
    if pk is None or not ev:
        return None
    c = ctx.config
    entries = (c["params"] * c["draws"] * c["chains"]
               // (dist.get_world_size() * ctx.calls_a_pass))
    nbytes = entries * ENTRY_B * len(ev)
    return 100.0 * nbytes / pk["hbm_bytes_per_s"] / device_s(ev)
