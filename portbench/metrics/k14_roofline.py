"""k14_roofline (%): K14's share of its roofline in a world of ranks: the
compulsory bytes of rank 0's merge-counts over the device time of K14's
launches (its partitions and its counts). None outside a world or where
K14 did not run.

A count launch (``merge_count_kernel<kFirst, kPos>``) counts a rank's block
of ``params x draws x chains / chain shards`` entries over the calls a pass
makes against a block of as many (every rank of the world holds as many
chains; the harness's mesh shards the chains over the whole world), and
moves, an entry of the local block:

- 4 B for every entry of either block read: 8 B, or 4 B with ``kFirst``,
  where the block counted against is the rank's own, read once;
- 8 B for every accumulator entry updated (read and written), 4 B for one
  only written: ``t`` and, with ``kPos``, ``gpos``.

So 12 B an entry writing both (the rank's own block, ``<true, true>``), 8 B
writing ``t`` alone (``<true, false>``, the fold's own block), 24 B adding
to both (``<false, true>``) and 16 B adding to ``t`` alone
(``<false, false>``), at the card's HBM rate (``peaks.json``)."""

import re

import torch.distributed as dist

from portbench.readers import device_s, matching, peaks

_COUNT = re.compile(r"merge_count_kernel<(true|false), (true|false)>")
READ_B = {"true": 4, "false": 8}  # the own block alone, or both blocks
ACC_B = {"true": 4, "false": 8}  # an accumulator written, or updated


def count_bytes(name: str) -> int:
    """Bytes an entry of the local block of the count launch ``name``."""
    first, pos = _COUNT.search(name).groups()
    return READ_B[first] + ACC_B[first] * (1 + (pos == "true"))


def read(ctx):
    if not (dist.is_available() and dist.is_initialized()):
        return None
    pk = peaks(ctx)
    ev = matching(ctx, ("merge_count_",))
    counts = [e[0] for e in ev if _COUNT.search(e[0])]
    if pk is None or not counts:
        return None
    c = ctx.config
    entries = (c["params"] * c["draws"] * c["chains"]
               // (dist.get_world_size() * ctx.calls_a_pass))
    nbytes = entries * sum(count_bytes(name) for name in counts)
    return 100.0 * nbytes / pk["hbm_bytes_per_s"] / device_s(ev)
