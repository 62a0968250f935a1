"""Data carried between numpy, the JAX package's input form, and the port.

The slice has no weights: its state is the sample. Both packages take the
``(draws, chains, params...)`` layout; these helpers put a numpy sample on a
named device and bring the port's outputs back to numpy, so that one seeded
numpy input can go through both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor. A tensor stays on its own device (``device``, if
    given, must name that device); anything else goes through
    ``np.asarray`` to ``device`` (default: the CPU)."""
    if isinstance(x, torch.Tensor):
        if device is not None and torch.device(device) != x.device:
            raise ValueError(
                f"tensor lives on {x.device} but device={device!r} was given; "
                "move it with .to() first"
            )
        return x
    return torch.as_tensor(np.asarray(x), device=device or "cpu")


def to_numpy(obj):
    """The port's outputs as numpy: tensors become arrays, Python scalars
    stay, and tuples (``ESSRhat`` included) convert field by field."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        vals = [to_numpy(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj
