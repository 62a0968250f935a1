"""Grouping and stratified-split index utilities on the host (counterpart
of the JAX package's ``utils/indices.py``): they act on small integer id
vectors in the nested R-hat and R* paths, never on draws."""

from __future__ import annotations

import numpy as np


def unique_indices(x):
    """Sorted unique values of ``x`` and, for each, the ascending positions
    where it occurs: ``(uniques, indices)`` (reference ``unique_indices``,
    src/utils.jl:50-64)."""
    x = np.asarray(x).reshape(-1)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    boundaries = np.flatnonzero(np.concatenate(([True], xs[1:] != xs[:-1])))
    uniques = xs[boundaries]
    indices = [np.sort(g) for g in np.split(order, boundaries[1:])]
    return uniques, indices


def split_chain_indices(chain_inds, split: int = 2):
    """Relabel a chain-id vector so each chain becomes ``split`` chains.

    Entries of each chain are assumed ordered by iteration. The partition is
    non-greedy: with ``n = len(chain)`` and ``r = n % split``, the first ``r``
    splits get ``n // split + 1`` draws and the rest ``n // split`` (reference
    src/utils.jl:78-105). New chain ids are consecutive from 1, grouped by the
    sorted original ids.
    """
    chain_inds = np.asarray(chain_inds)
    out = np.empty_like(chain_inds, dtype=np.int64)
    if split == 1:
        return chain_inds.astype(np.int64).copy()
    _, indices = unique_indices(chain_inds)
    next_id = 1
    for inds in indices:
        base, rem = divmod(len(inds), split)
        start = 0
        for j in range(split):
            take = base + (1 if j < rem else 0)
            out[inds[start:start + take]] = next_id
            start += take
            next_id += 1
    return out


def shuffle_split_stratified(rng: np.random.Generator, group_ids, frac: float):
    """Split the indices of ``group_ids`` into two groups with per-class
    balance: for each class, ``round(N_class * frac)`` shuffled indices go to
    the first group and the rest to the second (reference
    src/utils.jl:120-141; banker's rounding, like Julia's ``round(Int,
    x)``). Draws from ``rng`` in the JAX package's order, so one generator
    gives both packages the same split."""
    group_ids = np.asarray(group_ids)
    inds1, inds2 = [], []
    _, indices = unique_indices(group_ids)
    for inds in indices:
        n1 = int(np.rint(len(inds) * frac))
        perm = rng.permutation(inds)
        inds1.append(perm[:n1])
        inds2.append(perm[n1:])
    return np.concatenate(inds1), np.concatenate(inds2)
