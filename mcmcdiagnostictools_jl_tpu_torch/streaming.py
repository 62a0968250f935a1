"""Out-of-core execution over the parameter axis (counterpart of the JAX
package's ``streaming.py``).

A sample that does not fit device memory (BASELINE.md config 4, 10k draws x
128 chains x 1000 params float32, is 5.12 GB; the north-star workload 400 GB)
stays on the host, in an array, an ``np.memmap`` or behind a
``source(start, size)`` callable, and goes through the card in chunks of
``param_chunk`` parameters. Every diagnostic of the library is independent per
parameter, so chunking is exact. Two entry points:

- :func:`stream_param_chunks`, the generic executor: any function from a
  device chunk ``(draws, chains, param_chunk)`` to a tensor, tuple, list or
  dict of ``(param_chunk,)`` tensors;
- :func:`ess_rhat_streaming`: ESS and R-hat (kinds rank/bulk/tail/basic, fast
  or exact rank mode) through the port's ``_ess_rhat_pipeline``, which on the
  card runs kernels K1-K4 on every chunk.

The schedule on the card: two pinned host staging buffers, two device
buffers, one copy stream beside the compute stream (the caller's current
stream), events in both directions, and one fetch thread. While the calling
thread runs chunk k (the pipeline synchronises with the card once a chunk),
the fetch thread gathers chunk k + 1 from the source into a staging buffer;
its copy then runs on the copy stream under what is left of compute k;
compute k + 1 waits for that copy; the copy of chunk k + 2 waits until
compute k has released the device buffer, and the gather of chunk k + 2
until copy k has released the staging buffer. The
device buffers live for the whole run, so the allocator never hands a chunk's
memory to another tensor while a kernel reads it. Peak device memory is two
chunks plus the pipeline's own, whatever the number of chunks, and results
stay on the card until the end: no host readback per chunk. With
``device="cpu"`` the schedule degenerates to a plain loop.
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .backend import resolve_device
from .diagnostics.ess_rhat import (
    DEFAULT_NBINS,
    ESSRhat,
    _check_maxlag,
    _check_rank_mode,
    _ess_rhat_pipeline,
    _method_name,
)


@dataclass
class StreamStats:
    """Per-run accounting of the executor, one entry per chunk in each list.

    ``fetch_s``: host time to read the chunk from the source and gather it
    (cast, zero-padded) into its staging buffer; from the second chunk on
    this runs on the fetch thread, beside the previous chunk's ``fn``.
    ``wait_s``: time the calling thread was blocked on the card outside
    ``fn`` while the chunk was current: until the staging buffer of the next
    chunk was free and, for the last chunk, until the run had finished (with
    ``device="cpu"``: the time in ``fn``). ``h2d_s`` and ``compute_s``: the
    chunk's copy and its ``fn`` call on the card, from CUDA events (with
    ``device="cpu"``: 0 and the host time in ``fn``). ``wall_s``: end to end.
    A run that overlaps well has ``wall_s`` near the largest of the three
    sums, not near their total.
    """

    n_chunks: int = 0
    param_chunk: int = 0
    wall_s: float = 0.0
    fetch_s: list = field(default_factory=list)
    wait_s: list = field(default_factory=list)
    h2d_s: list = field(default_factory=list)
    compute_s: list = field(default_factory=list)


def _make_source(source, nparams):
    """Normalize the input to ``(source_fn, nparams, pshape, dims)``.

    Arrays (``np.memmap`` and CPU tensors included) stream as slices of the
    flattened parameter axis, views that are gathered straight into a
    staging buffer; a callable is used as it is: ``source(start, size) ->
    (draws, chains, size)`` host array. ``pshape`` is the trailing parameter
    shape of an array (``()`` for 2-d input) and ``None`` for a callable
    (results stay flat); ``dims`` is ``(draws, chains)``, ``None`` for a
    callable.
    """
    if callable(source):
        if nparams is None:
            raise ValueError("nparams is required with a callable source")
        return source, int(nparams), None, None
    if isinstance(source, torch.Tensor):
        if source.device.type != "cpu":
            raise ValueError(
                "streaming reads a host sample; a tensor that is on the card "
                "already goes to ess_rhat")
        source = source.detach().numpy()
    arr = source
    if arr.ndim < 2:
        raise ValueError("streaming expects (draws, chains[, params...])")
    pshape = tuple(arr.shape[2:])
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim > 3:
        arr = arr.reshape(arr.shape[0], arr.shape[1], -1)
    if nparams is not None and int(nparams) != arr.shape[2]:
        raise ValueError(
            f"nparams = {nparams} but the array has {arr.shape[2]} parameters")

    def slice_source(start, size):
        return arr[:, :, start:start + size]

    return slice_source, int(arr.shape[2]), pshape, tuple(arr.shape[:2])


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _check_chunk(host, start, size, dims):
    """A chunk as the source gave it: ``(draws, chains, size)``."""
    if host.ndim != 3 or host.shape[2] != size:
        raise ValueError(
            f"source returned shape {tuple(host.shape)} for chunk "
            f"[{start}:{start + size}); expected (draws, chains, {size})")
    if dims is not None and tuple(host.shape[:2]) != tuple(dims):
        raise ValueError(
            f"source returned (draws, chains) = {tuple(host.shape[:2])} for "
            f"chunk [{start}:{start + size}); expected {tuple(dims)}")


def _gather(staging: torch.Tensor, host: np.ndarray, size: int) -> None:
    """``host`` (any strides, any real dtype) into ``staging[:, :, :size]``,
    zeros behind it. The copy is PyTorch's, which casts and spreads a large
    strided gather over its host threads."""
    if host.flags.writeable:
        src = torch.from_numpy(host)
    else:
        with warnings.catch_warnings():
            # a read-only memmap is only read here
            warnings.filterwarnings("ignore", message=".*not writable.*")
            src = torch.from_numpy(host)
    staging[:, :, :size].copy_(src)
    if size < staging.shape[2]:
        staging[:, :, size:].zero_()


def _tree_map(f, *trees):
    """``f`` over the tensors of equally shaped trees (a tensor, or a tuple,
    named tuple, list or dict of trees)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return f(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(f, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        vals = [_tree_map(f, *parts) for parts in zip(*trees)]
        return (type(first)(*vals) if hasattr(first, "_fields")
                else type(first)(vals))
    raise TypeError(
        f"fn must return tensors, tuples, lists or dicts, got {type(first)}")


def stream_param_chunks(fn, source, *, nparams=None, param_chunk: int = 256,
                        return_stats: bool = False, device=None,
                        dtype=torch.float32):
    """Drive ``fn`` over parameter chunks of a host sample.

    ``fn(chunk) -> tree of (param_chunk,) tensors`` gets a ``(draws, chains,
    param_chunk)`` tensor of ``dtype`` on ``device`` and must be independent
    per parameter. Every chunk has the same width: the ragged last one is
    zero-padded, and its surplus results are sliced off. ``fn`` must not keep
    the chunk: its buffer is overwritten two chunks later (the results are
    copied out of it). Returns the tree of ``(nparams,)`` tensors on
    ``device``, with a :class:`StreamStats` if ``return_stats``.

    ``source``: a host array / ``np.memmap`` / CPU tensor shaped ``(draws,
    chains, params...)``, or a callable ``source(start, size)`` (then
    ``nparams`` is required). ``device``: default the card (raises if there
    is none); ``"cpu"`` runs a plain loop. Whatever is wrong with
    ``param_chunk``, ``nparams`` or the shape of the source's first chunk is
    raised before anything is allocated on or copied to the card.
    """
    if isinstance(param_chunk, bool) or not isinstance(param_chunk, (int, np.integer)):
        raise TypeError(f"param_chunk must be an int, got {param_chunk!r}")
    if param_chunk <= 0:
        raise ValueError(f"param_chunk must be positive, got {param_chunk}")
    param_chunk = int(param_chunk)
    src, nparams, _, dims = _make_source(source, nparams)
    if nparams <= 0:
        raise ValueError("streaming requires at least one parameter")
    device = resolve_device(device)
    dtype = _torch_dtype(dtype)
    starts = list(range(0, nparams, param_chunk))
    sizes = [min(param_chunk, nparams - s) for s in starts]
    stats = StreamStats(n_chunks=len(starts), param_chunk=param_chunk)

    t_run = time.perf_counter()
    t0 = time.perf_counter()
    first = np.asarray(src(0, sizes[0]))
    _check_chunk(first, 0, sizes[0], dims)
    dims = tuple(first.shape[:2])
    shape = dims + (param_chunk,)
    on_card = device.type == "cuda"

    def read(k):
        host = first if k == 0 else np.asarray(src(starts[k], sizes[k]))
        _check_chunk(host, starts[k], sizes[k], dims)
        return host

    def keep(out, k):
        # out of the chunk's buffer (fn may have returned views of it)
        return _tree_map(lambda v: v[:sizes[k]].clone(), out)

    results = []
    if not on_card:
        for k in range(len(starts)):
            if k:
                t0 = time.perf_counter()
            chunk = torch.empty(shape, dtype=dtype)
            _gather(chunk, read(k), sizes[k])
            t1 = time.perf_counter()
            results.append(keep(fn(chunk), k))
            t2 = time.perf_counter()
            stats.fetch_s.append(t1 - t0)
            stats.wait_s.append(t2 - t1)
            stats.compute_s.append(t2 - t1)
            stats.h2d_s.append(0.0)
    else:
        with torch.cuda.device(device):
            compute = torch.cuda.current_stream(device)
            copy = torch.cuda.Stream(device)
            staging = [torch.empty(shape, dtype=dtype, pin_memory=True)
                       for _ in range(min(2, len(starts)))]
            chunks = [torch.empty(shape, dtype=dtype, device=device)
                      for _ in range(len(staging))]
            # the copy stream must not write a buffer before its allocation
            # (made on the compute stream) is in effect, and the allocator
            # must not reuse one under a copy if the run ends early
            copy.wait_stream(compute)
            for buf in chunks:
                buf.record_stream(copy)
            ev = [{name: torch.cuda.Event(enable_timing=True)
                   for name in ("h2d0", "h2d1", "fn0", "fn1")}
                  for _ in starts]

            def gather(k):
                """Chunk k from the source into its staging buffer (on the
                fetch thread for k >= 1); returns the time it took."""
                tg = time.perf_counter()
                _gather(staging[k % 2], read(k), sizes[k])
                return time.perf_counter() - tg

            def enqueue_copy(k):
                if k >= 2:  # compute k - 2 must have released the buffer
                    copy.wait_event(ev[k - 2]["fn1"])
                with torch.cuda.stream(copy):
                    ev[k]["h2d0"].record()
                    chunks[k % 2].copy_(staging[k % 2], non_blocking=True)
                    ev[k]["h2d1"].record()

            stats.fetch_s.append(time.perf_counter() - t0 + gather(0))
            enqueue_copy(0)
            with ThreadPoolExecutor(max_workers=1) as fetcher:
                for k in range(len(starts)):
                    waited, pending = 0.0, None
                    if k + 1 < len(starts):
                        if k >= 1:  # the staging buffer's last copy is done
                            tw = time.perf_counter()
                            ev[k - 1]["h2d1"].synchronize()
                            waited = time.perf_counter() - tw
                        pending = fetcher.submit(gather, k + 1)
                    compute.wait_event(ev[k]["h2d1"])
                    ev[k]["fn0"].record(compute)
                    results.append(keep(fn(chunks[k % 2]), k))
                    ev[k]["fn1"].record(compute)
                    if pending is not None:
                        stats.fetch_s.append(pending.result())
                        enqueue_copy(k + 1)
                    stats.wait_s.append(waited)
            tw = time.perf_counter()
            compute.synchronize()
            stats.wait_s[-1] += time.perf_counter() - tw
            for e in ev:
                stats.h2d_s.append(e["h2d0"].elapsed_time(e["h2d1"]) / 1e3)
                stats.compute_s.append(e["fn0"].elapsed_time(e["fn1"]) / 1e3)
    merged = _tree_map(lambda *leaves: torch.cat(leaves), *results)
    stats.wall_s = time.perf_counter() - t_run
    if return_stats:
        return merged, stats
    return merged


def ess_rhat_streaming(
    source,
    *,
    nparams: int | None = None,
    param_chunk: int = 256,
    kind: str = "rank",
    split_chains: int = 2,
    maxlag: int = 250,
    autocov_method="auto",
    relative: bool = False,
    tail_prob: float = 0.1,
    rank_mode: str = "fast",
    rank_nbins: int = DEFAULT_NBINS,
    dtype=torch.float32,
    return_stats: bool = False,
    device=None,
):
    """ESS and R-hat of a host sample too large for device memory, an
    ``ESSRhat(ess, rhat)`` of tensors on ``device``.

    ``source`` is a host array / ``np.memmap`` / CPU tensor shaped ``(draws,
    chains, params...)`` or a callable ``source(start, size)`` yielding host
    chunks (then ``nparams`` is required, one column is read first to learn
    ``(draws, chains)``, and results are flat ``(nparams,)``). An array is
    not read to learn its shape, and keeps ``ess_rhat``'s output shape: the
    trailing parameter shape, 0-d tensors for 2-d input. ``kind``: rank,
    bulk, tail or basic. The default rank mode is the histogram fast mode,
    the streaming regime being the throughput regime; ``rank_mode="exact"``
    sorts. A NaN poisons only its parameter. ``niter <= 4`` raises.

    ``device``: default the card, where float32 chunks run kernels K1-K4 and
    float64 chunks their plain versions (any other ``dtype`` raises there);
    ``"cpu"`` runs the plain versions in a plain loop. With ``return_stats=True`` also returns the
    :class:`StreamStats` of the run.

    The JAX function's ``mesh_cfg`` and ``rank_impl`` (streaming onto a
    device mesh through the sharded pipeline) have no counterpart yet: they
    wait for the port of ``parallel/`` (ROADMAP.md, queue A) and are not
    parameters here, rather than being accepted and ignored.
    """
    if kind not in ("rank", "bulk", "tail", "basic"):
        raise ValueError(
            f"the `kind` `{kind}` is not supported by `ess_rhat_streaming`"
        )
    _check_rank_mode(rank_mode)
    _check_maxlag(maxlag)
    device = resolve_device(device)
    dtype = _torch_dtype(dtype)
    src, nparams, pshape, dims = _make_source(source, nparams)
    if nparams <= 0:
        raise ValueError("streaming requires at least one parameter")
    if dims is None:
        # callable source: one single-column read discovers (draws, chains)
        probe = np.asarray(src(0, 1))
        _check_chunk(probe, 0, 1, None)
        dims = tuple(probe.shape[:2])
    niter = dims[0] // split_chains
    if niter <= 4:
        raise ValueError("streaming ess_rhat requires >4 draws per split "
                         "chain")
    method = _method_name(autocov_method)
    q = tail_prob if kind == "tail" else None

    def checked_source(start, size):
        # every chunk must have the draws and chains the lag budget assumes
        host = np.asarray(src(start, size))
        _check_chunk(host, start, size, dims)
        return host

    def fn(chunk):
        return _ess_rhat_pipeline(
            chunk, kind=kind, split_chains=split_chains,
            maxlag=min(maxlag, niter - 4), method=method, relative=relative,
            q=q, rank_mode=rank_mode, rank_nbins=rank_nbins,
        )

    (ess, rhat), stats = stream_param_chunks(
        fn, checked_source, nparams=nparams, param_chunk=param_chunk,
        return_stats=True, device=device, dtype=dtype,
    )
    if pshape is not None:
        ess = ess.reshape(pshape)
        rhat = rhat.reshape(pshape)
    if return_stats:
        return ESSRhat(ess, rhat), stats
    return ESSRhat(ess, rhat)
