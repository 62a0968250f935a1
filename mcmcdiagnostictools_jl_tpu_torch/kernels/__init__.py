"""Hand-written CUDA kernels of the port and their wrappers.

| id | wrapper | replaces (JAX package) |
|----|---------|------------------------|
| K1 | ``moments_autocov.moments_autocov`` | ``ops/pallas/fused_basic_kernel.py::pallas_moments_autocov`` |
| K2 | ``fastrank.column_minmax`` | ``ops/pallas/fastrank_kernel.py::pallas_column_minmax`` |
| K3 | ``fastrank.hist_moments``, ``fastrank.hist_cdf_tables`` (the same kernel, its second pass emitting the finished CDF) | ``ops/pallas/fastrank_kernel.py::pallas_hist_moments`` |
| K4 | ``fastrank.rank_lookup`` | ``ops/pallas/fastrank_kernel.py::pallas_rank_lookup`` |
| K5 | ``autocov.direct_autocov`` | ``ops/pallas/autocov_kernel.py::pallas_autocov`` |
| K6a, K6b | ``lagloop_study.lag_products`` (``variant="a"`` / ``"b"``) | ``benchmarks/micro_lagloop.py::_run`` (``_kernel_a`` / ``_kernel_b``) |
| K7 | ``sort_study.pass_strided`` | ``benchmarks/sort_microbench.py::bench_dma_pass`` |
| K8 | ``sort_study.pass_contig`` | ``benchmarks/sort_microbench.py::bench_dma_contig`` |
| K9 | ``sort_study.bitonic_pod_sort`` | ``benchmarks/sort_microbench.py::bench_phase_a`` |

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), so a run can show that the main path went through
the kernels; both entry points of K3 count into ``hist_moments.launches``;
K4 also counts its z-mode launches (``blom_n``) on their own, reported as
``"K4z"``, and K6 counts each variant on its own. Importing this package builds nothing; the first
launch does.
"""

from . import autocov, fastrank, lagloop_study, moments_autocov, sort_study

# name -> (wrapper, counter attribute)
COUNTERS = {
    "K1": (moments_autocov.moments_autocov, "launches"),
    "K2": (fastrank.column_minmax, "launches"),
    "K3": (fastrank.hist_moments, "launches"),
    "K4": (fastrank.rank_lookup, "launches"),
    "K4z": (fastrank.rank_lookup, "z_launches"),
    "K5": (autocov.direct_autocov, "launches"),
    "K6a": (lagloop_study.lag_products, "a_launches"),
    "K6b": (lagloop_study.lag_products, "b_launches"),
    "K7": (sort_study.pass_strided, "launches"),
    "K8": (sort_study.pass_contig, "launches"),
    "K9": (sort_study.bitonic_pod_sort, "launches"),
}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset (``K4z``: the z-mode
    launches of K4, which ``K4`` counts too)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
