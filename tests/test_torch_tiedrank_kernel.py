"""K12's plain version (``kernels.tiedrank``) and the exact rank mode's
transforms that now run it, against the JAX package, on the CPU.

The port works on rows ``(P, N)``, one a parameter; the JAX package on
``(N, P)``, so each comparison takes the JAX function on the transpose.
Float64 throughout:

- the tied ranks of ``tied_blom_plain(blom=False)`` equal the JAX package's
  ``_avg_ranks_sorted`` exactly, and its Blom scores ``ndtri((r - 0.375) /
  (n + 0.25))`` within BASELINE.md's 1e-6, on rows with ties, one run over
  the whole row, ``+-0.0``, ``+-inf`` and NaN, of lengths 1, 2, 3, 17 and
  300;
- with ``bad`` on and off and ``order`` present and absent: NaN rows where
  ``bad`` is set, the values scattered to ``order`` where it is given;
  ``rank_normalize_from_sort`` against the JAX function of that name, and
  ``folded_rank_values_sorted`` against the JAX package's on the same fold;
- on a CPU tensor ``tied_blom`` is its plain version and launches nothing
  (K12's count stays 0), also at lengths on the edges of the kernel's
  scatter buckets (``_BUCKET - 1`` to ``2 _BUCKET + 3``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import ndtri

from mcmcdiagnostictools_jl_tpu.ops import ranknorm as jrn
from mcmcdiagnostictools_jl_tpu_torch import kernels
from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank
from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm as rn
from torch_parity import assert_close, t

KINDS = ["ties", "one_run", "signed_zeros", "infinities", "nan", "mixed"]
LENGTHS = [1, 2, 3, 17, 300]


def _sorted_rows(kind: str, n: int, p: int = 4, seed: int = 0) -> np.ndarray:
    """``(p, n)`` float64 rows, each ascending with NaN last (numpy's
    order), holding what ``kind`` names."""
    rng = np.random.default_rng(seed + n)
    x = np.round(rng.standard_normal((p, n)) * 2) / 2  # ties
    if kind == "one_run":
        x[:] = 0.75
    elif kind == "signed_zeros":
        x[:, ::2] = -0.0
        x[:, 1::2] = 0.0
        x[0, n // 2:] = 1.0
    elif kind == "infinities":
        x[:, : (3 * n) // 4] = np.inf
        x[1, 0] = -np.inf
    elif kind == "nan":
        x[:, ::3] = np.nan
        x[2] = np.nan
    elif kind == "mixed":
        x[0, ::5] = np.nan
        x[1, : n // 2] = -np.inf
        x[2] = rng.standard_normal(n)
        x[3, ::2] = -0.0
    return np.sort(x, axis=1)


def _jax_ranks(xs: np.ndarray) -> np.ndarray:
    return np.asarray(jrn._avg_ranks_sorted(jnp.asarray(xs.T))).T


def _jax_blom(xs: np.ndarray) -> np.ndarray:
    n = xs.shape[1]
    return np.asarray(ndtri((jnp.asarray(_jax_ranks(xs)) - 0.375)
                            / (n + 0.25)))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_ranks_equal_jax(kind, n):
    xs = _sorted_rows(kind, n)
    got = tiedrank.tied_blom_plain(t(xs), blom=False)
    assert got.dtype == torch.float64 and got.shape == xs.shape
    np.testing.assert_array_equal(got.numpy(), _jax_ranks(xs))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_blom_scores_match_jax(kind, n):
    xs = _sorted_rows(kind, n)
    got = tiedrank.tied_blom_plain(t(xs))
    assert bool(torch.isfinite(got).all())
    assert_close(got, _jax_blom(xs))


def _inputs(kind: str, n: int, with_order: bool, with_bad: bool):
    """Sorted rows, a permutation of each row (or None) and a ``bad`` mask
    with rows 0 and 2 set (or None)."""
    xs = _sorted_rows(kind, n, seed=1)
    rng = np.random.default_rng(n + 11)
    order = (np.stack([rng.permutation(n) for _ in range(xs.shape[0])])
             if with_order else None)
    bad = np.array([True, False, True, False]) if with_bad else None
    return xs, order, bad


# the kernel's scatter works in buckets of _BUCKET columns: lengths at their
# edges
B = tiedrank._BUCKET


@pytest.mark.parametrize("with_bad", [False, True], ids=["bad_off", "bad_on"])
@pytest.mark.parametrize("with_order", [False, True],
                         ids=["sorted", "scattered"])
@pytest.mark.parametrize("blom", [True, False], ids=["blom", "ranks"])
@pytest.mark.parametrize("kind,n", [("mixed", 1), ("mixed", 2), ("ties", 3),
                                    ("mixed", 300), ("nan", 17),
                                    ("mixed", B - 1), ("ties", B),
                                    ("nan", B + 1), ("mixed", 2 * B + 3)])
def test_wrapper_on_the_cpu_is_the_plain_version(kind, n, blom, with_order,
                                                 with_bad):
    xs, order, bad = _inputs(kind, n, with_order, with_bad)
    want = np.array(_jax_blom(xs) if blom else _jax_ranks(xs))
    if bad is not None:
        want[bad] = np.nan
    if order is not None:
        back = np.empty_like(want)
        np.put_along_axis(back, order, want, axis=1)
        want = back
    kernels.reset_launch_counts()
    got = tiedrank.tied_blom(t(xs), None if order is None else t(order),
                             None if bad is None else t(bad), blom=blom)
    assert kernels.launch_counts()["K12"] == 0
    assert got.shape == xs.shape and got.dtype == torch.float64
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    if blom:
        assert_close(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    plain = tiedrank.tied_blom_plain(
        t(xs), None if order is None else t(order),
        None if bad is None else t(bad), blom=blom)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(plain))


@pytest.mark.parametrize("n", [1, 2, 3, 300])
@pytest.mark.parametrize("with_bad", [False, True], ids=["bad_off", "bad_on"])
def test_rank_normalize_from_sort_matches_jax(with_bad, n):
    xs, order, bad = _inputs("mixed", n, True, with_bad)
    if bad is None:  # every row that holds a NaN is masked by its caller
        bad = np.isnan(xs).any(1)
    got = rn.rank_normalize_from_sort(t(xs), t(order), t(bad))
    want = jrn.rank_normalize_from_sort(
        jnp.asarray(xs.T), jnp.asarray(order.T.astype(np.int32)),
        jnp.asarray(bad))
    assert got.shape == (n, xs.shape[0])
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("merge", [None, "two_sort"], ids=["sort", "merge"])
@pytest.mark.parametrize("n", [3, 300])
def test_folded_rank_values_match_jax(n, merge):
    xs, order, _ = _inputs("ties", n, True, False)
    med = np.median(xs, axis=1)
    kernels.reset_launch_counts()
    zf, forder = rn.folded_rank_values_sorted(t(xs), t(order), t(med),
                                              merge=merge)
    assert kernels.launch_counts()["K12"] == 0
    wz, wo = jrn.folded_rank_values_sorted(
        jnp.asarray(xs.T), jnp.asarray(order.T.astype(np.int32)),
        jnp.asarray(med), merge=merge)
    # the keys are sorted alike; tied keys may carry their positions in
    # another order, so the scores are compared routed back by position
    back = np.empty_like(xs)
    np.put_along_axis(back, forder.numpy(), zf.numpy(), axis=1)
    want = np.empty_like(xs)
    np.put_along_axis(want, np.asarray(wo).T, np.asarray(wz).T, axis=1)
    assert_close(back, want)
