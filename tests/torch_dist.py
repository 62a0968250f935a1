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
