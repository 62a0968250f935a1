"""The one device/dtype resolver of the port.

The JAX package probes the platform in three places (``_auto_method`` and
``_resolve_fold_merge`` in ``diagnostics/ess_rhat.py``, ``resolve_fast_impl``
in ``ops/fastrank.py``). Here a tensor's own device decides, once:

- a CUDA float32 tensor goes to the hand-written kernels (``kernels/``);
- a CUDA float64 tensor goes to the plain PyTorch versions beside them, on
  the card (the JAX package sends float64 down plain XLA the same way): no
  kernel is written in float64;
- a CPU tensor goes to the plain PyTorch versions;
- a CUDA tensor of any other dtype raises ``NotImplementedError``.

The route is chosen by device and dtype alone: a CUDA float32 tensor whose
kernel fails to build or launch raises, it never falls back to a plain
version. Non-tensor input (numpy, lists) and the entry points that take host
data (the out-of-core executor, the kernel studies) run on the card unless
the caller names a device: ``resolve_device``.
"""

from __future__ import annotations

import torch


def use_kernels(x: torch.Tensor) -> bool:
    """True when ``x`` must go through the hand-written kernels, False when
    the plain PyTorch version serves it (CPU tensors, and CUDA float64
    tensors, on the card). Raises for a CUDA tensor of any other dtype and
    for any other device."""
    if x.device.type == "cuda":
        if x.dtype == torch.float64:
            return False
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"CUDA tensors must be float32 (the kernels) or float64 (the "
                f"plain versions on the card), got {x.dtype}"
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
