"""Canonical array layout helpers (counterpart of the JAX package's
``utils/layout.py``).

The sample layout is ``(draws, chains[, parameters...])``; every diagnostic
works on the flattened ``(draws, chains, P)`` form and the public API
restores the parameter shape, collapsing to a Python scalar for <=2-d
inputs (reference src/utils.jl:197-215).
"""

from __future__ import annotations

import torch

from ..convert import to_tensor


def canonicalize(x, device=None, min_ndim: int = 1):
    """``x`` of shape ``(draws[, chains[, params...]])`` as ``(draws, chains,
    P)`` plus the original parameter shape.

    A tensor is computed where it lives, in its dtype; any other input
    (numpy, lists) goes to ``device``, by default the current card, float64
    as float32 there (``device="cpu"`` for the host; with no card and no
    ``device`` this raises; ``convert.to_tensor``). Integers and bools
    promote to ``torch.get_default_dtype()``. A 1-d input gains a
    singleton chain axis; <=2-d inputs have ``pshape == ()``.
    """
    x3, pshape = canonical_dims(to_tensor(x, device), min_ndim)
    if not x3.is_floating_point():
        x3 = x3.to(torch.get_default_dtype())
    return x3, pshape


def canonical_dims(x, min_ndim: int = 1):
    """A tensor or numpy array ``(draws[, chains[, params...]])`` reshaped to
    ``(draws, chains, P)`` where it lies, plus the parameter shape."""
    if x.ndim < min_ndim:
        raise ValueError(
            f"samples must have at least {min_ndim} dimensions (draws, chains[, parameters...])"
        )
    if x.ndim == 0:
        raise ValueError("samples must have at least 1 dimension")
    if x.ndim == 1:
        x = x[:, None]
    pshape = tuple(x.shape[2:])
    return x.reshape(x.shape[0], x.shape[1], -1), pshape


def restore_param_shape(values: torch.Tensor, pshape: tuple) -> torch.Tensor:
    """Reshape a flat ``(P,)`` (or ``(..., P)``) result back to ``pshape``."""
    return values.reshape(tuple(values.shape[:-1]) + tuple(pshape))


def maybe_scalar(values: torch.Tensor, pshape: tuple):
    """A Python float for empty ``pshape`` (one device-to-host copy), else a
    tensor shaped ``pshape`` on the values' device."""
    values = restore_param_shape(values, pshape)
    if pshape == ():
        return values.reshape(()).item()
    return values
