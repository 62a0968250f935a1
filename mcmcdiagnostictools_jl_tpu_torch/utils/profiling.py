"""Profiling hooks (counterpart of the JAX package's ``utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records the host's activity, and the card's where there is one, and writes
  a TensorBoard trace of everything inside the block into ``log_dir``;
- :func:`annotate`: a named region (``torch.profiler.record_function``) that
  shows up by name in a profile. With no profiler running it is one shared
  no-op context, so a region costs one flag check;
- :func:`host_sync`: a region around a place where the host waits for the
  device, counted by :func:`sync_counts` (reset by
  :func:`reset_sync_counts`), one count a pass through the site whatever
  the device.
- :func:`count_comm`: the bytes a collective of the sharded diagnostics
  (``parallel/comm.py``) sends and receives on this rank, by kind, read by
  :func:`comm_counts` (reset by :func:`reset_comm_counts`).

The diagnostics open these regions (names, outermost first):

| region | what it holds |
|---|---|
| ``mdt.ess_rhat``, ``mdt.ess``, ``mdt.rhat``, ``mdt.rhat_nested`` | a public call, after its argument checks |
| ``mdt.rank.exact``, ``mdt.rank.fast`` | one rank transform of the call: transposes, sorts, ranks, median, Blom and fold, in both rank modes the tail R-hat's moments |
| ``mdt.moments`` | the split chains, their moments and autocovariance (K1 / K5) and the autocorrelation |
| ``mdt.geyer`` | Geyer's reduction of the autocorrelation to an ESS |
| ``mdt.nested`` | nested R-hat's superchain gather, split and two-level reduction; on a mesh the split-chain moments (K11) and the local superchain reductions |
| ``mdt.rank.ring`` | on a mesh, the ring route's rank transforms: the local sorts, the merge-counts against each visiting block, the Blom scores, the quantiles' local part and the fold |
| ``mdt.comm`` | on a mesh, every collective and ring exchange (``parallel/comm.py``) |
| ``mdt.sync.<site>`` | a host wait: ``geyer_probe`` (the adaptive lag probe's answer), ``superchain_ids`` (the chain permutation to the device), ``quantile_offset`` (the exact median's interpolation weight to the device), ``hist_rank`` (the fast median's rank to the device) |

The layer regions (every region above but the calls and ``mdt.sync.*``)
do not nest in each other; a ``mdt.sync.*`` region may sit inside one. On
a mesh a layer region closes before a collective and opens again after
it (:func:`comm_region`), so that callers open one region around work
that holds collectives. Every device operation of a public call on these
paths is launched inside one of them, or inside the call's own region (its
last elementwise step and the results' shape).

The JAX package's third hook, ``enable_compilation_cache``, persists XLA's
compiled programs and has no counterpart: the port compiles no programs at
run time, and its kernels are built once into a cached directory
(``kernels/_build.py``).

Example::

    from mcmcdiagnostictools_jl_tpu_torch.utils.profiling import trace
    with trace("mdt-trace") as prof:
        mtt.ess_rhat(x)
    # prof.events() holds mdt.ess_rhat, mdt.rank.exact, mdt.moments, ...
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

_OFF = contextlib.nullcontext()
_SYNCS: dict[str, int] = {}
_COMM: dict[str, dict[str, int]] = {}
CALLS = ("mdt.ess_rhat", "mdt.ess", "mdt.rhat", "mdt.rhat_nested")
_OPEN: list = []  # the open regions but the calls', innermost last
_RF = torch.profiler.record_function


class _Region(_RF):
    """A region, on ``_OPEN`` while it is open unless it is a call's."""

    def __enter__(self):
        if self.name not in CALLS:
            _OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.name not in CALLS:
            _OPEN.pop()


@contextlib.contextmanager
def _between(name: str):
    """The region ``name`` with the regions of ``_OPEN`` closed around it."""
    closed = _OPEN[::-1]
    for region in closed:
        _RF.__exit__(region, None, None, None)
    try:
        with _RF(name):
            yield
    finally:
        for region in reversed(closed):
            _RF.__enter__(region)


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
    """A named region for profiles: ``with annotate("mdt.fold"): ...``; the
    shared no-op context while no profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return _Region(name)
    return _OFF


def comm_region():
    """``mdt.comm``, a collective's region, with the open layer regions
    closed around it; the shared no-op context while no profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return _between("mdt.comm")
    return _OFF


def host_sync(site: str):
    """The region ``mdt.sync.<site>`` around a host wait for the device,
    counted once a ``with``: ``with host_sync("geyer_probe"): ...``."""
    _SYNCS[site] = _SYNCS.get(site, 0) + 1
    return annotate("mdt.sync." + site)


def sync_counts() -> dict:
    """Passes through each host-sync site since the last reset."""
    return dict(_SYNCS)


def reset_sync_counts() -> None:
    _SYNCS.clear()


def count_comm(kind: str, sent: int, received: int) -> None:
    """Count ``sent`` and ``received`` bytes of one collective of ``kind``
    on this rank."""
    c = _COMM.setdefault(kind, {"sent": 0, "received": 0})
    c["sent"] += sent
    c["received"] += received


def comm_counts() -> dict:
    """Bytes this rank sent and received since the last reset, by kind:
    ``{kind: {"sent": bytes, "received": bytes}}``."""
    return {k: dict(v) for k, v in _COMM.items()}


def reset_comm_counts() -> None:
    _COMM.clear()
