"""Data carried between numpy, the JAX package's input form, and the port.

The library has no weights of its own: its state is the sample, and the R*
classifier's fitted forest. Both packages take the ``(draws, chains,
params...)`` layout; these helpers put a numpy sample on a device (the card,
in float32, unless the caller names another), bring the port's outputs back
to numpy, and carry a forest fitted by the JAX package across as numpy
arrays, so that one seeded numpy input can go through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device


def to_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor. A tensor stays on its own device and dtype
    (``device``, if given, must name that device): passing a CPU tensor asks
    for the CPU, a CUDA float64 tensor for float64 on the card. Anything else
    (numpy, lists, scalars) goes through ``np.asarray`` to ``device``, by
    default the current card; with no card that raises and names
    ``device="cpu"``. On the card float64 becomes float32, the dtype the
    kernels take, as the JAX package's default (no x64) casts it; on the CPU
    it stays float64 (the parity mode)."""
    if isinstance(x, torch.Tensor):
        if device is not None and resolve_device(device) != x.device:
            raise ValueError(
                f"tensor lives on {x.device} but device={device!r} was given; "
                "move it with .to() first"
            )
        return x
    arr = np.asarray(x)
    device = resolve_device(device)
    if device.type == "cuda" and arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def to_numpy(obj):
    """The port's outputs as numpy: tensors become arrays, Python scalars
    stay, and tuples (``ESSRhat`` included) convert field by field."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        vals = [to_numpy(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


def gbt_state_from_numpy(state, device=None):
    """A fitted forest given as numpy arrays, as the port's
    ``models.GBTState`` on ``device`` (default: the card). ``state`` is any
    object with the JAX package's ``GBTState`` fields (``split_feature``,
    ``split_bin``, ``leaf_value``, ``bin_edges``, ``num_classes``), its own
    state included: each array is copied through ``np.array``."""
    from .models.gbt import GBTState

    device = resolve_device(device)

    def put(name, dtype):
        return torch.as_tensor(np.array(getattr(state, name)), dtype=dtype,
                               device=device).contiguous()

    return GBTState(put("split_feature", torch.int64),
                    put("split_bin", torch.int64),
                    put("leaf_value", torch.float32),
                    put("bin_edges", torch.float32),
                    int(state.num_classes))
