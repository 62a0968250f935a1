"""MCMC diagnostics in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``mcmcdiagnostictools_jl_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100. It covers ``ess`` (every kind:
``basic``, ``bulk``, ``tail``, and the estimators ``mean``, ``std``,
``median``, ``mad``, ``Quantile(p)``), ``rhat``, ``ess_rhat``, ``mcse``,
``rhat_nested`` and ``bfmi``, in both rank modes (exact: ``torch.sort``;
fast: histogram CDF, with ``ops.fastrank.FUSE_BLOM_Z`` selecting kernel K4's
fused z mode), and the classical suite ``gelmandiag``,
``gelmandiag_multivariate``, ``gewekediag``, ``heideldiag`` and
``rafterydiag``, the discrete diagnostic ``discretediag``, the classifier
diagnostic ``rstar`` (with its histogram GBT in ``models/``), and the
out-of-core executor ``stream_param_chunks`` / ``ess_rhat_streaming`` for a
host sample larger than device memory. ``parallel`` runs ESS / R-hat and
nested R-hat over a ``(chains, params)`` mesh of ``torch.distributed``
ranks, one process a device (``make_mesh``, ``ess_rhat_sharded``,
``rhat_nested_sharded``; ``ess_rhat_streaming(mesh_cfg=...)``), and
``models.ShardedGBTClassifier`` fits R*'s classifier over the ranks. The
kernel studies (lag-loop formulations, sort passes and the pod sort) live
in ``benchmarks/``.

Same layout and contracts as the JAX package: ``(draws, chains[,
params...])`` input, a Python float for input without parameter dims, NaN in
a parameter slice poisons only that parameter. A tensor is computed on its
own device: a CUDA float32 tensor goes through the kernels in ``kernels/``,
a CUDA float64 tensor through their plain PyTorch versions on the card, a
CPU tensor through the plain versions on the host. Numpy and other
non-tensor input goes to the ``device=`` argument, by default the current
card, where float64 becomes float32 (the JAX package's default) and so runs
the kernels: pass ``device="cpu"`` (or a CPU tensor) to compute on the host,
float64 kept.
"""

from . import models, parallel
from .diagnostics.bfmi import bfmi
from .diagnostics.discretediag import (
    DiscreteDiagResult,
    DiscreteDiagValues,
    discretediag,
)
from .diagnostics.gelmandiag import (
    GelmanMultivariateResult,
    GelmanResult,
    gelmandiag,
    gelmandiag_multivariate,
)
from .diagnostics.gewekediag import GewekeResult, gewekediag
from .diagnostics.heideldiag import HeidelResult, heideldiag
from .diagnostics.ess_rhat import (
    AutocovMethod,
    BDAAutocovMethod,
    DirectKernelAutocovMethod,
    ESSRhat,
    FFTAutocovMethod,
    KernelAutocovMethod,
    Quantile,
    ess,
    ess_rhat,
    rhat,
)
from .diagnostics.mcse import mcse
from .diagnostics.rafterydiag import RafteryResult, rafterydiag
from .diagnostics.rhat_nested import rhat_nested
from .diagnostics.rstar import rstar
from .streaming import StreamStats, ess_rhat_streaming, stream_param_chunks

__version__ = "0.1.0"

__all__ = [
    "ess",
    "ess_rhat",
    "rhat",
    "mcse",
    "rhat_nested",
    "bfmi",
    "gelmandiag",
    "gelmandiag_multivariate",
    "gewekediag",
    "heideldiag",
    "rafterydiag",
    "discretediag",
    "rstar",
    "ess_rhat_streaming",
    "stream_param_chunks",
    "StreamStats",
    "AutocovMethod",
    "FFTAutocovMethod",
    "BDAAutocovMethod",
    "KernelAutocovMethod",
    "DirectKernelAutocovMethod",
    "ESSRhat",
    "Quantile",
    "GelmanResult",
    "GelmanMultivariateResult",
    "GewekeResult",
    "HeidelResult",
    "RafteryResult",
    "DiscreteDiagResult",
    "DiscreteDiagValues",
    "models",
    "parallel",
]
