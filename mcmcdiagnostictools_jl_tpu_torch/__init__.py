"""MCMC diagnostics in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``mcmcdiagnostictools_jl_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100. This slice covers the flagship
``ess`` / ``rhat`` / ``ess_rhat`` with the ``basic``, ``bulk``, ``tail`` and
``rank`` kinds in both rank modes (exact: ``torch.sort``; fast: histogram
CDF).

Same layout and contracts as the JAX package: ``(draws, chains[,
params...])`` input, a Python float for input without parameter dims, NaN in
a parameter slice poisons only that parameter. A tensor is computed on its
own device: a CUDA float32 tensor goes through the kernels in ``kernels/``,
a CPU tensor through their plain PyTorch versions; numpy input goes to the
``device=`` argument (default: the CPU).
"""

from .diagnostics.ess_rhat import (
    AutocovMethod,
    BDAAutocovMethod,
    ESSRhat,
    FFTAutocovMethod,
    KernelAutocovMethod,
    Quantile,
    ess,
    ess_rhat,
    rhat,
)

__version__ = "0.1.0"

__all__ = [
    "ess",
    "ess_rhat",
    "rhat",
    "AutocovMethod",
    "FFTAutocovMethod",
    "BDAAutocovMethod",
    "KernelAutocovMethod",
    "ESSRhat",
    "Quantile",
]
