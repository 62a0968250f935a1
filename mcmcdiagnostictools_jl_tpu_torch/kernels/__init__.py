"""Hand-written CUDA kernels of the port and their wrappers.

| id | wrapper | replaces (JAX package) |
|----|---------|------------------------|
| K1 | ``moments_autocov.moments_autocov`` | ``ops/pallas/fused_basic_kernel.py::pallas_moments_autocov`` |
| K2 | ``fastrank.column_minmax`` | ``ops/pallas/fastrank_kernel.py::pallas_column_minmax`` |
| K3 | ``fastrank.hist_moments`` | ``ops/pallas/fastrank_kernel.py::pallas_hist_moments`` |
| K4 | ``fastrank.rank_lookup`` | ``ops/pallas/fastrank_kernel.py::pallas_rank_lookup`` |

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), so a run can show that the main path went through
the kernels. Importing this package builds nothing; the first launch does.
"""

from . import fastrank, moments_autocov

WRAPPERS = {
    "K1": moments_autocov.moments_autocov,
    "K2": fastrank.column_minmax,
    "K3": fastrank.hist_moments,
    "K4": fastrank.rank_lookup,
}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
