"""Hand-written CUDA kernels of the port and their wrappers.

| id | wrapper | replaces (JAX package) |
|----|---------|------------------------|
| K1 | ``moments_autocov.moments_autocov`` | ``ops/pallas/fused_basic_kernel.py::pallas_moments_autocov`` |
| K2 | ``fastrank.column_minmax`` | ``ops/pallas/fastrank_kernel.py::pallas_column_minmax`` |
| K3 | ``fastrank.hist_moments`` | ``ops/pallas/fastrank_kernel.py::pallas_hist_moments`` |
| K4 | ``fastrank.rank_lookup`` | ``ops/pallas/fastrank_kernel.py::pallas_rank_lookup`` |
| K5 | ``autocov.direct_autocov`` | ``ops/pallas/autocov_kernel.py::pallas_autocov`` |

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), so a run can show that the main path went through
the kernels; K4 also counts its z-mode launches (``blom_n``) on their own,
reported as ``"K4z"``. Importing this package builds nothing; the first
launch does.
"""

from . import autocov, fastrank, moments_autocov

# name -> (wrapper, counter attribute)
COUNTERS = {
    "K1": (moments_autocov.moments_autocov, "launches"),
    "K2": (fastrank.column_minmax, "launches"),
    "K3": (fastrank.hist_moments, "launches"),
    "K4": (fastrank.rank_lookup, "launches"),
    "K4z": (fastrank.rank_lookup, "z_launches"),
    "K5": (autocov.direct_autocov, "launches"),
}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset (``K4z``: the z-mode
    launches of K4, which ``K4`` counts too)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
