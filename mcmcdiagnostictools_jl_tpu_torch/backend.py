"""The one device/dtype resolver of the port.

The JAX package probes the platform in three places (``_auto_method`` and
``_resolve_fold_merge`` in ``diagnostics/ess_rhat.py``, ``resolve_fast_impl``
in ``ops/fastrank.py``). Here a tensor's own device decides, once:

- a CUDA float32 tensor goes to the hand-written kernels (``kernels/``);
- a CPU tensor goes to the plain PyTorch versions beside them;
- a CUDA tensor of any other dtype raises ``NotImplementedError``: no float64
  path for the card is ported yet (ROADMAP.md, queue A).

There is no silent route from a CUDA tensor to a plain version. Entry points
that take host data and no tensor (the out-of-core executor, the kernel
studies) run on the card unless the caller names a device: ``resolve_device``.
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


def resolve_device(device=None) -> torch.device:
    """``device`` with its index filled in, or the current card when none is
    named; raises where there is no card rather than running on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this entry point runs on the card by default and there is "
                "none; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
