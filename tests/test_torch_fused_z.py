"""K4's fused z mode (Blom + AS241 ``ppnd7``) and the ``FUSE_BLOM_Z`` route
of the fast rank-normal transform, against the JAX package.

Tolerances, as measured on the CPU:

- the plain ``ppnd7`` against JAX's ``ppnd7`` on float32: 3 float32 ULP.
  The polynomials are evaluated operation for operation alike; PyTorch's
  and XLA's float32 ``log`` differ by up to 1 ULP, which the cancellation
  in ``r - 1.6`` near ``p = 0.94`` turns into 3 ULP of z (2 ULP or less
  elsewhere on the grid);
- ``ppnd7`` against ``torch.special.ndtri`` on float64: rtol = atol = 2e-7,
  AS241's own accuracy (the JAX package's test of its ``ppnd7``);
- the port's fused route against the JAX package's fused route
  (``impl="pallas_interpret"``) on float32: 1e-6 absolute in z (measured
  7.2e-7: the same polynomial, the 1-ULP logs, and the histogram's frac
  sums added in another order);
- the fused route against the port's unfused route (``ndtri``): rtol 1e-5,
  atol 1e-4, as the JAX package holds its two routes (extreme ranks
  amplify ``ppnd7``'s 1e-7 by ``1/phi(z)``).

The kernel against its plain version on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import ndtri as jndtri

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu.ops import fastrank as jfr
from mcmcdiagnostictools_jl_tpu.ops.pallas import fastrank_kernel as jpk
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as fr
from torch_parity import assert_close, t

# the p grid of the JAX package's ppnd7 test: central, far lower tail, upper tail
_P = np.concatenate([
    np.linspace(1e-7, 1 - 1e-7, 2001),
    np.geomspace(1e-30, 1e-2, 200),
    1 - np.geomspace(1e-7, 1e-2, 200),
])


def test_ppnd7_matches_jax_float32():
    p = _P.astype(np.float32)
    got = kfr.ppnd7(t(p)).numpy()
    want = np.asarray(jpk.ppnd7(jnp.asarray(p)))
    assert got.dtype == want.dtype == np.float32
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= 3 * ulp)


def test_ppnd7_matches_ndtri():
    got = kfr.ppnd7(t(_P))
    assert_close(got, torch.special.ndtri(t(_P)), rtol=2e-7, atol=2e-7)
    assert_close(got, jndtri(jnp.asarray(_P)), rtol=2e-7, atol=2e-7)


def test_ppnd7_nan_and_symmetry():
    # 0.25/0.75 (central) and 2^-5 / 1 - 2^-5 (tails) are exact mirror images
    p = t(np.array([np.nan, 0.5, 0.25, 0.75, 0.03125, 0.96875, 1e-20]))
    z = kfr.ppnd7(p)
    assert torch.isnan(z[0]) and float(z[1]) == 0.0
    assert float(z[2]) == -float(z[3]) and float(z[4]) == -float(z[5])
    assert_close(z[1:], torch.special.ndtri(p[1:]), rtol=2e-7, atol=2e-7)


def _sample(rng):
    """The JAX package's fused-route input (ties, a constant column) plus a
    column holding a NaN."""
    x = rng.standard_normal((5000, 5)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2] * 2) / 2
    x[:, 3] = 1.25
    x[7, 4] = np.nan
    return x


def test_fused_route_matches_jax_fused(rng, monkeypatch):
    x = _sample(rng)
    monkeypatch.setattr(jfr, "FUSE_BLOM_Z", True)
    monkeypatch.setattr(fr, "FUSE_BLOM_Z", True)
    want, _ = jfr.fast_rank_normalize_flat(x, 1024, impl="pallas_interpret")
    got, _ = fr.fast_rank_normalize_flat(t(x), 1024)
    assert got.dtype == torch.float32
    assert torch.isnan(got[:, 4]).all() and not torch.isnan(got[:, :4]).any()
    assert_close(got, want, rtol=0, atol=1e-6, equal_nan=True)


def test_fused_route_matches_unfused(rng, monkeypatch):
    x = t(_sample(rng))
    unfused, _ = fr.fast_rank_normalize_flat(x, 1024)
    monkeypatch.setattr(fr, "FUSE_BLOM_Z", True)
    fused, _ = fr.fast_rank_normalize_flat(x, 1024)
    assert_close(fused, unfused, rtol=1e-5, atol=1e-4, equal_nan=True)
    # the degenerate column carries the tied rank's z exactly
    assert torch.equal(fused[:, 3], unfused[:, 3])


def test_fused_route_reaches_the_z_mode(rng, monkeypatch):
    """``fast_rank_bulk_tail`` (bulk and fold) and ``ess_rhat`` take the
    route; on a CPU tensor the plain z mode runs, never the kernel."""
    calls = []
    real = kfr.rank_lookup_plain

    def spy(*args, **kw):
        calls.append(args[5] if len(args) > 5 else kw.get("blom_n"))
        return real(*args, **kw)

    monkeypatch.setattr(kfr, "rank_lookup_plain", spy)
    x3 = t(rng.standard_normal((400, 4, 3)))
    before = (kfr.rank_lookup.launches, kfr.rank_lookup.z_launches)
    unfused = mtt.ess_rhat(x3, rank_mode="fast", device="cpu")
    assert calls == [None, None]
    monkeypatch.setattr(fr, "FUSE_BLOM_Z", True)
    fused = mtt.ess_rhat(x3, rank_mode="fast", device="cpu")
    assert calls[2:] == [1600, 1600]  # bulk and fold, blom_n = draws * chains
    assert before == (kfr.rank_lookup.launches, kfr.rank_lookup.z_launches)
    assert_close(fused.ess, unfused.ess, rtol=1e-4, atol=0)
    assert_close(fused.rhat, unfused.rhat, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_bulk_tail_matches_jax_unfused(rng, monkeypatch, dtype):
    """The fold transform takes the fused route too; both outputs track the
    JAX package's (unfused, float64-capable) XLA path within the fused
    route's bound."""
    x3 = rng.standard_normal((1000, 4, 6)).astype(dtype)
    x3[:, :, 1] = np.round(x3[:, :, 1] * 2) / 2
    x3[:, :, 2] = 0.5
    x3[3, 0, 4] = np.nan
    monkeypatch.setattr(fr, "FUSE_BLOM_Z", True)
    got = fr.fast_rank_bulk_tail(t(x3), 1024)
    want = jfr.fast_rank_bulk_tail(x3, 1024, impl="xla")
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.from_numpy(x3).dtype
        assert_close(g, w, rtol=1e-5, atol=1e-4, equal_nan=True)
    assert_close(got[2], want[2], rtol=1e-6, atol=1e-12, equal_nan=True)


def test_blom_n_must_be_a_count():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="blom_n"):
        kfr.rank_lookup(x, torch.zeros(2), torch.ones(2),
                        torch.zeros((3, 8, 2)), 8, blom_n=0)
