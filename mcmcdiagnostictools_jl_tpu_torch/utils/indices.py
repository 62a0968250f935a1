"""Grouping index utilities on the host (counterpart of the JAX package's
``utils/indices.py``): they act on small integer id vectors, never on
draws."""

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
