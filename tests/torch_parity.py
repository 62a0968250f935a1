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


def old_ring_counts(blocks, index):
    """``(cl, ce, gpos)`` of block ``index`` of a ring of ``blocks`` (sorted
    rows ``(P, n)``, on any one device) as the ring route formed them with
    ``torch.searchsorted`` before its two accumulators ``(t, gpos)``: the
    global counts of smaller and of equal entries, and each copy's global
    position, ties held by ring-earlier blocks first."""
    xs, k = blocks[index], len(blocks)
    cl = torch.searchsorted(xs, xs, side="left")
    gpos = torch.arange(xs.shape[1], device=xs.device).sub(cl)
    ce = torch.searchsorted(xs, xs, side="right").sub_(cl)
    for step in range(1, k):
        buf = blocks[(index - step) % k]
        less = torch.searchsorted(buf, xs, side="left")
        neq = torch.searchsorted(buf, xs, side="right").sub_(less)
        cl.add_(less)
        ce.add_(neq)
        if (index - step) % k < index:
            gpos.add_(neq)
    return cl, ce, gpos.add_(cl)
