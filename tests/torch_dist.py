"""Gloo worlds on the CPU for the port's distributed tests
(``tests/test_torch_sharded.py``, the mesh cases of
``tests/test_torch_streaming.py`` and ``tests/test_torch_rstar.py``).

A world is ``nprocs`` processes started with ``spawn`` (the pytest process
runs JAX's threads, so ``fork`` is unsafe), joined through a ``FileStore``
under the test's temporary directory (never a fixed TCP port: test files run
in parallel). Each child sets one thread, imports only torch and the port
(it asserts that JAX was not imported), runs a batch of calls and saves its
results with ``torch.save``; :func:`run_world` returns every rank's results
and checks that each rank's equal rank 0's.

A call is ``(name, target, args, kwargs)``: ``target`` names a function of
this module or a path in the port (``"parallel.ess_rhat_sharded"``,
``"ess_rhat_streaming"``);
an argument equal to ``MESH`` becomes the rank's mesh. A call whose name
starts with ``"raises:"`` must raise: its result is the exception's type
name and message.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESH = "<mesh>"
PKG = "mcmcdiagnostictools_jl_tpu_torch"


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        return tuple(_to_numpy(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    return obj


def _resolve(target: str):
    if target in globals():
        return globals()[target]
    mod, _, name = target.rpartition(".")
    return getattr(importlib.import_module(".".join(filter(None, (PKG, mod)))),
                   name)


def _mesh_or(value, cfg):
    return cfg if isinstance(value, str) and value == MESH else value


def _child(rank, nprocs, store_path, out_dir, layout):
    torch.set_num_threads(1)
    # a rank that fails leaves the others in a collective: they give up
    # after the timeout instead of hanging the test run
    dist.init_process_group("gloo", store=dist.FileStore(store_path, nprocs),
                            rank=rank, world_size=nprocs,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from mcmcdiagnostictools_jl_tpu_torch.parallel import make_mesh

        cfg = make_mesh(*layout, device_type="cpu")
        with open(os.path.join(out_dir, "calls.pkl"), "rb") as f:
            calls = pickle.load(f)
        out = {}
        for name, target, args, kwargs in calls:
            args = [_mesh_or(a, cfg) for a in args]
            kwargs = {k: _mesh_or(v, cfg) for k, v in kwargs.items()}
            fn = _resolve(target)
            if name.startswith("raises:"):
                try:
                    fn(*args, **kwargs)
                except Exception as e:  # the case's expected failure
                    out[name] = (type(e).__name__, str(e))
                else:
                    out[name] = None
            else:
                out[name] = _to_numpy(fn(*args, **kwargs))
        assert "jax" not in sys.modules, "a distributed test rank imported JAX"
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(tmp_dir, nprocs: int, layout, calls) -> list:
    """Run ``calls`` on every rank of a gloo world of ``nprocs`` processes
    over a ``layout = (chain_shards, param_shards)`` mesh; returns the
    per-rank result dicts (name -> numpy arrays, tuples of them, or the
    raised exception), after checking that every rank's equal rank 0's."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    if os.path.exists(store):  # a store left by an earlier world stalls this one
        os.remove(store)
    # the calls go through a file: pickled into the spawn arguments, they
    # delay the start of the later ranks by seconds
    with open(os.path.join(tmp_dir, "calls.pkl"), "wb") as f:
        pickle.dump(list(calls), f)
    mp.start_processes(_child, args=(nprocs, store, tmp_dir, tuple(layout)),
                       nprocs=nprocs, start_method="spawn")
    results = [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(nprocs)]
    for r, res in enumerate(results[1:], 1):
        assert res.keys() == results[0].keys()
        for name in res:
            _assert_same(res[name], results[0][name], f"{name}, rank {r}")
    return results


def _assert_same(a, b, what):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for u, v in zip(a, b):
            _assert_same(u, v, what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}, {k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b or (a != a and b != b), what


# ---- calls that are more than one port function -----------------------------


def sharded_gbt_fit(x, y, num_classes, **clf_kw):
    """``ShardedGBTClassifier(**clf_kw).fit`` over every rank: the fitted
    state's arrays and the logits it predicts for ``x``."""
    from mcmcdiagnostictools_jl_tpu_torch.models import ShardedGBTClassifier

    clf = ShardedGBTClassifier(**clf_kw)
    x = torch.as_tensor(x)
    state = clf.fit(x, y, num_classes)
    return {"split_feature": state.split_feature,
            "split_bin": state.split_bin, "leaf_value": state.leaf_value,
            "bin_edges": state.bin_edges,
            "logits": clf.predict_logits(state, x)}


def sharded_rstar_mean(x, rng, **clf_kw):
    """The mean of ``rstar`` with a ``ShardedGBTClassifier``."""
    from mcmcdiagnostictools_jl_tpu_torch import rstar
    from mcmcdiagnostictools_jl_tpu_torch.models import ShardedGBTClassifier

    return float(rstar(ShardedGBTClassifier(**clf_kw), torch.as_tensor(x),
                       rng=rng).mean())


def chain_group_algebra(x, nsuper, cfg):
    """The cross-chain algebra on this rank's even share of the chains of
    ``x`` ``(n, C, P)`` with the mesh's chain group, and on all of them
    with one card's: ``{"mesh": results, "one_card": results}``, each the
    flags, ``stats_from_chain_moments``' W, var_plus and R-hat, the basic
    ESS and R-hat (direct estimator) and nested R-hat over ``nsuper``
    superchains of contiguous chains (from the moments, from moments in
    reversed order with the ``rows`` that restore it, and from the
    sample)."""
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics.ess_rhat import (
        basic_ess_rhat,
    )
    from mcmcdiagnostictools_jl_tpu_torch.ops import moments
    from mcmcdiagnostictools_jl_tpu_torch.parallel.comm import mesh_chains

    full = torch.as_tensor(x)
    k, i = cfg.chain_shards, cfg.chain_index
    c = full.shape[1] // k
    out = {}
    for name, group, xs, ns in (
            ("mesh", mesh_chains(cfg), full[:, i * c:(i + 1) * c], nsuper // k),
            ("one_card", moments.ONE_CARD, full, nsuper)):
        mean, _, var = moments.chain_moments(xs)
        same = group.all_same(xs)
        stats = moments.stats_from_chain_moments(mean, var, xs.shape[0],
                                                 same, group)
        back = torch.arange(xs.shape[1] - 1, -1, -1)
        ess, rhat = basic_ess_rhat(xs, 2, 20, "direct", False, group)
        out[name] = {
            "all_same": same,
            "same": group.same(xs.amin((0, 1)), xs.amax((0, 1))),
            "w": stats.w, "var_plus": stats.var_plus, "rhat": stats.rhat,
            "basic_ess": ess, "basic_rhat": rhat,
            "nested": moments.nested_rhat(mean, var, ns, same, group),
            "nested_rows": moments.nested_rhat(mean.flip(0), var.flip(0), ns,
                                               same, group, rows=back),
            "nested_split": moments.nested_rhat_split(xs, ns, 2, group),
        }
    return out


def on_own_block(target, x, ids, cfg, **kwargs):
    """The port's rank-local ``target`` (``"parallel.rhat_nested_local"``)
    called with this rank's own block of the global ``x`` (its chains and
    parameters of the mesh, as a CPU tensor of ``x``'s dtype) and the global
    ``ids``."""
    from mcmcdiagnostictools_jl_tpu_torch.parallel import shard_canonical

    return _resolve(target)(shard_canonical(torch.as_tensor(x), cfg), ids,
                            cfg, **kwargs)


def comm_of(target, x, ids, cfg, **kwargs):
    """The bytes this rank's collectives sent and received in one
    ``on_own_block`` call, by kind (``utils.profiling.comm_counts``)."""
    from mcmcdiagnostictools_jl_tpu_torch.utils import profiling

    profiling.reset_comm_counts()
    on_own_block(target, x, ids, cfg, **kwargs)
    return profiling.comm_counts()


def regions_of(target, x, ids, cfg, **kwargs):
    """Each ``mdt.`` region one ``on_own_block`` call opened, in order:
    ``(name, the names of its enclosing mdt. regions, innermost first)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on_own_block(target, x, ids, cfg, **kwargs)
    out = []
    events = [e for e in prof.events() if e.name.startswith("mdt.")]
    for e in sorted(events, key=lambda e: e.time_range.start):
        above, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("mdt."):
                above.append(p.name)
            p = p.cpu_parent
        out.append((e.name, tuple(above)))
    return out
