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
| K10 | ``valley.valley_merge`` | ``ops/ranknorm.py::valley_sort_2d`` (XLA, not a Pallas kernel) |
| K11 | ``seghist.segment_moments`` | ``ops/seghist.py::weighted_segment_moments`` (XLA, not a Pallas kernel) |
| K12 | ``tiedrank.tied_blom`` | ``ops/ranknorm.py::_avg_ranks_sorted`` + ``ndtri`` + the inverse sort (XLA, not a Pallas kernel) |
| K13 | ``radix_sort.sort_rows``, ``radix_sort.sort_rows_keys`` (the keys alone) | ``ops/ranknorm.py::_sort_pair`` (``lax.sort``, XLA, not a Pallas kernel) |
| K14 | ``mergecount.merge_count`` | ``parallel/ring_rank.py::_count_block`` (two sorts of the concatenation and run-boundary scans, XLA, not a Pallas kernel) |
| K15 | ``tiedrank.blom_from_counts`` | ``parallel/ring_rank.py::rank_normal_from_counts`` (elementwise XLA, not a Pallas kernel) |

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), so a run can show that the main path went through
the kernels; both entry points of K3 count into ``hist_moments.launches``,
both of K13 into ``sort_rows.launches`` (one a call, whose launches are a
memset, the histograms and the digit passes);
K4 also counts its z-mode launches (``blom_n``) on their own, reported as
``"K4z"``, and K6 counts each variant on its own. Importing this package builds nothing; the first
launch does.
"""

from . import (autocov, fastrank, lagloop_study, mergecount, moments_autocov,
               radix_sort, seghist, sort_study, tiedrank, valley)

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
    "K10": (valley.valley_merge, "launches"),
    "K11": (seghist.segment_moments, "launches"),
    "K12": (tiedrank.tied_blom, "launches"),
    "K13": (radix_sort.sort_rows, "launches"),
    "K14": (mergecount.merge_count, "launches"),
    "K15": (tiedrank.blom_from_counts, "launches"),
}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset (``K4z``: the z-mode
    launches of K4, which ``K4`` counts too)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
