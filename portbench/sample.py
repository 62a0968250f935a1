"""The sample a cell diagnoses, made on the device from ``--seed``.

A configuration's ``profile`` states the chains: AR(1) series along the
draws with unit marginal variance, ``x_0 = e_0``, ``x_t = phi x_(t-1) +
sqrt(1 - phi^2) e_t``, ``phi`` spread evenly over ``profile["phi"]`` across
the parameters, and an ``offset`` added to a run of chains of one parameter,
so that it has not mixed. The noise comes from one seeded
``torch.Generator`` on the device in one call; the recursion runs in place,
a draw at a time. Every seed gives the same sizes and the same profile.
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
