"""Profiling hooks (counterpart of the JAX package's ``utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records the host's activity, and the card's where there is one, and writes
  a TensorBoard trace of everything inside the block into ``log_dir``;
- :func:`annotate`: a named region (``torch.profiler.record_function``) that
  shows up by name in a profile.

The JAX package's third hook, ``enable_compilation_cache``, persists XLA's
compiled programs and has no counterpart: the port compiles no programs at
run time, and its kernels are built once into a cached directory
(``kernels/_build.py``).

Example::

    from mcmcdiagnostictools_jl_tpu_torch.utils.profiling import trace
    with trace("mdt-trace"):
        mtt.ess_rhat(x)
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block into ``log_dir`` (TensorBoard
    format, one ``*.pt.trace.json`` file a block); yields the
    ``torch.profiler.profile`` object, whose events can be read after the
    block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside it


def annotate(name: str):
    """A named region for profiles: ``with annotate("mdt.fold"): ...``."""
    return torch.profiler.record_function(name)
