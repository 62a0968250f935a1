"""The one device/dtype resolver of the port.

The JAX package probes the platform in three places (``_auto_method`` and
``_resolve_fold_merge`` in ``diagnostics/ess_rhat.py``, ``resolve_fast_impl``
in ``ops/fastrank.py``). Here a tensor's own device decides, once:

- a CUDA float32 tensor goes to the hand-written kernels (``kernels/``);
- a CPU tensor goes to the plain PyTorch versions beside them;
- a CUDA tensor of any other dtype raises ``NotImplementedError``: no float64
  path for the card is ported yet (ROADMAP.md, queue A).

There is no silent route from a CUDA tensor to a plain version.
"""

from __future__ import annotations

import torch


def use_kernels(x: torch.Tensor) -> bool:
    """True when ``x`` must go through the hand-written kernels, False when
    the plain PyTorch version serves it (CPU tensors). Raises for a CUDA
    tensor that is not float32 and for any other device."""
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"CUDA tensors must be float32, got {x.dtype}: the float64 "
                "card path is not ported yet (ROADMAP.md, queue A)"
            )
        return True
    if x.device.type == "cpu":
        return False
    raise NotImplementedError(f"unsupported device {x.device}")
