"""The JAX side of the repository never runs in a benchmark process."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mcmcdiagnostictools_jl_tpu"})


def loaded(modules=None) -> list[str]:
    """Forbidden top-level names among ``modules`` (default
    ``sys.modules``), each name compared whole: the part before the first
    dot. ``mcmcdiagnostictools_jl_tpu_torch`` is not
    ``mcmcdiagnostictools_jl_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in list(names)} & FORBIDDEN)
