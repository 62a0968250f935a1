"""The sample a cell diagnoses, made on the device from ``--seed``.

A configuration's ``profile`` states the chains: AR(1) series along the
draws with unit marginal variance, ``x_0 = e_0``, ``x_t = phi x_(t-1) +
sqrt(1 - phi^2) e_t``, ``phi`` spread evenly over ``profile["phi"]`` across
the parameters, and an ``offset`` added to a run of chains of one parameter,
so that it has not mixed. The noise comes from one seeded
``torch.Generator`` on the device in one call; the recursion runs in place,
a draw at a time. Every seed gives the same sizes and the same profile.

In a world of ranks (``world.py``) rank ``r`` of ``k`` makes only its own
block of chains, ``[r c / k, (r + 1) c / k)``, on its own card
(``make_block``): the same profile over global chain indices, from a
generator seeded by ``--seed`` and ``r``. No rank holds the global sample.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_sample(config: dict, seed: int, device) -> torch.Tensor:
    """``(draws, chains, params)`` in the configuration's dtype."""
    d, c, p = config["draws"], config["chains"], config["params"]
    dtype = DTYPES[config["dtype"]]
    prof = config["profile"]
    x = torch.randn((d, c, p), generator=generator(seed, device),
                    device=device, dtype=dtype)
    lo, hi = prof["phi"]
    phi = torch.linspace(lo, hi, p, device=device, dtype=torch.float64)
    scale = torch.sqrt(1.0 - phi * phi).to(dtype)
    phi = phi.to(dtype)
    for t in range(1, d):
        x[t].mul_(scale).addcmul_(x[t - 1], phi)
    off = prof.get("offset")
    if off:
        c0, c1 = off["chains"]
        x[:, c0:c1, off["param"]] += off["shift"]
    return x


# rank r's generator takes seed + r * BLOCK_STRIDE (mod 2^64): an odd stride,
# so that the ranks' seeds differ for every seed, and rank 0 takes the seed
BLOCK_STRIDE = 0x9E3779B97F4A7C15


def block_seed(seed: int, rank: int) -> int:
    return (int(seed) + rank * BLOCK_STRIDE) % (1 << 64)


def make_block(config: dict, seed: int, rank: int, world: int,
               device) -> torch.Tensor:
    """Rank ``rank``'s ``(draws, chains / world, params)`` block of the
    sample: ``make_sample`` of its own chains, the ``offset`` kept where its
    global chains meet this block. A world of one makes ``make_sample``'s
    sample."""
    chains = config["chains"]
    if chains % world:
        raise ValueError(f"{chains} chains do not divide over {world} ranks")
    c_loc = chains // world
    c0 = rank * c_loc
    prof = {k: v for k, v in config["profile"].items() if k != "offset"}
    off = config["profile"].get("offset")
    if off:
        lo, hi = max(off["chains"][0], c0), min(off["chains"][1], c0 + c_loc)
        if lo < hi:
            prof["offset"] = dict(off, chains=[lo - c0, hi - c0])
    local = dict(config, chains=c_loc, profile=prof)
    return make_sample(local, block_seed(seed, rank), device)
