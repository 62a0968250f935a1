"""Bayesian fraction of missing information (counterpart of the JAX
package's ``diagnostics/bfmi.py``): ``mean(diff(E)^2) / var(E)`` per chain
(reference src/bfmi.jl:36-43)."""

from __future__ import annotations

import torch

from .. import backend
from ..convert import to_tensor


def _bfmi_along_axis0(energy: torch.Tensor) -> torch.Tensor:
    d = torch.diff(energy, dim=0)
    num = (d * d).mean(0)
    c = energy - energy.mean(0, keepdim=True)
    var = (c * c).sum(0) / (energy.shape[0] - 1)  # ddof = 1
    return num / var


def bfmi(energy, *, dims: int = 0, device=None):
    """BFMI of Hamiltonian ``energy`` draws: a Python float for a vector,
    one value per chain for a matrix, whose draw axis is ``dims`` (0, the
    default, for ``(draws, chains)``; Julia's ``dims`` is 1-based). Devices
    as in ``ess``."""
    energy = to_tensor(energy, device)
    if not energy.is_floating_point():
        energy = energy.to(torch.get_default_dtype())
    backend.use_kernels(energy)  # a CUDA tensor that is not float32 raises
    if energy.ndim == 1:
        return _bfmi_along_axis0(energy[:, None])[0].item()
    if energy.ndim != 2:
        raise ValueError(
            "energy must be a vector or a matrix of shape (draws, chains)")
    if dims not in (0, 1):
        raise ValueError("dims must be 0 or 1")
    return _bfmi_along_axis0(energy.T if dims == 1 else energy)
