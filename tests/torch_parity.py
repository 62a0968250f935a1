"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

One seeded numpy input goes through the JAX package and through the port;
these helpers carry the data across and hold the results to the stated
tolerances.
"""

import numpy as np
import pytest
import torch

from mcmcdiagnostictools_jl_tpu_torch.convert import to_numpy

# BASELINE.md's parity bound between implementations at float64
PARITY_F64 = dict(rtol=1e-6, atol=1e-12)


def t(x, dtype=None):
    """A numpy array as a CPU tensor (optionally cast)."""
    out = torch.from_numpy(np.array(x, copy=True, order="C"))
    return out if dtype is None else out.to(dtype)


def assert_close(port, ref, **tol):
    """Port output (tensor, tuple or float) against a JAX/numpy result."""
    np.testing.assert_allclose(np.asarray(to_numpy(port), dtype=np.float64),
                               np.asarray(to_numpy(ref), dtype=np.float64),
                               **(tol or PARITY_F64))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test when there is none. Decided
    when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
