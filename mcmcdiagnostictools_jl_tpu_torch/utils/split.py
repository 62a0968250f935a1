"""Chain splitting with the reference's exact remainder-discard rule
(counterpart of the JAX package's ``utils/split.py``).

Each chain's draws split into ``split`` consecutive sub-chains. With
``d = draws % split > 0``, one draw is discarded after each of the first
``d`` splits (reference ``copyto_split!``, src/utils.jl:13-41): split ``k``
reads draws ``[k*niter + min(k, d), k*niter + min(k, d) + niter)``.
"""

from __future__ import annotations

import torch


def split_chains_reshape(x: torch.Tensor, split: int) -> torch.Tensor:
    """Split ``(draws, chains, P)`` into a contiguous
    ``(draws // split, chains * split, P)``.

    Output chains are chain-major (all splits of chain 0, then chain 1, ...),
    as in the reference's column layout (src/utils.jl:32-38).
    """
    if split < 1:
        raise ValueError("split_chains must be >= 1")
    if split == 1:
        return x.contiguous()
    ndraws, nchains = x.shape[0], x.shape[1]
    niter = ndraws // split
    d = ndraws % split
    parts = [
        x[k * niter + min(k, d): k * niter + min(k, d) + niter]
        for k in range(split)
    ]
    y = torch.stack(parts, dim=2)  # (niter, chains, split, P)
    return y.reshape(niter, nchains * split, *x.shape[2:])
