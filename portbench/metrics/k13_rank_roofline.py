"""k13_rank_roofline (%): K13's share of its roofline in a world of ranks,
on the rows one rank sorts: ``k13_roofline``'s bytes and device time (its
histograms and digit passes, rank 0's), with a call's entries those of this
rank's block, ``params x draws x chains / chain shards`` over the calls a
pass makes. The harness's mesh shards the chains over the whole world
(``make_mesh(chain_shards=world)``), so the chain shards are the world's
size; ``k13_roofline`` counts the global chains and reads four times too
high there. None outside a world or where K13 did not run."""

import torch.distributed as dist

from portbench import spec
from portbench.readers import device_s, matching, peaks


def read(ctx):
    if not (dist.is_available() and dist.is_initialized()):
        return None
    pk = peaks(ctx)
    ev = matching(ctx, ("radix_histogram", "radix_digit_pass"))
    if pk is None or not ev:
        return None
    sorts = sum("radix_histogram" in e[0] for e in ev)
    with_pos = sum("radix_digit_pass<true, true>" in e[0] for e in ev)
    c = ctx.config
    entries = (c["params"] * c["draws"] * c["chains"]
               // (dist.get_world_size() * ctx.calls_a_pass))
    nbytes = spec.metric_reader("k13_roofline").sort_bytes(entries, sorts,
                                                           with_pos)
    return 100.0 * nbytes / pk["hbm_bytes_per_s"] / device_s(ev)
