"""The general traffic generator: a closed loop of passes over the resident
sample, as a pipeline that diagnoses a sampler's output makes them.

A mix (``mixes/<traffic>.json``) lists the ``calls`` of one pass: each a
public function of the port by name (``fn``; a dotted name is a path in
the port, ``"parallel.rhat_nested_sharded"``), its positional arguments by
kind (``args``: ``"sample"``, the device-resident sample; ``"superchain_ids"``,
one id a chain, ``config["superchains"]`` contiguous runs; ``"mesh"``, the
port's ``MeshConfig``), its keyword arguments as data (``kwargs``) and the
names of its outputs (``outputs``), one value a parameter each. A mix that
names ``"mesh"`` runs as a world of ranks (``world.py``): there
``"sample"`` is this rank's block of chains and ``"superchain_ids"`` the
global ids. A call with ``param_slice`` goes through the
parameters in slices of that many, one call a slice, as a caller does whose
sample leaves the card too little room for one call over all of it; its
outputs are joined along the parameters. A pass ends when every output is
on the host, which is what the user reads.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def superchain_ids(config: dict) -> np.ndarray:
    chains, nsuper = config["chains"], config["superchains"]
    return np.arange(chains) // (chains // nsuper)


ARG_KINDS = {
    "sample": lambda sample, config, mesh: sample,
    "superchain_ids": lambda sample, config, mesh: superchain_ids(config),
    "mesh": lambda sample, config, mesh: mesh,
}


def names_mesh(mix: dict) -> bool:
    """Whether the mix runs as a world of ranks: a call takes the mesh."""
    return any("mesh" in call.get("args", ()) for call in mix["calls"])


def port_function(port, name: str):
    """The port's function ``name``, a dotted name a path of attributes."""
    return functools.reduce(getattr, name.split("."), port)


def param_slices(call: dict, nparams: int) -> list[tuple[int, int]]:
    """``(start, stop)`` of the parameters each call of ``call`` takes."""
    step = call.get("param_slice") or nparams
    return [(s, min(s + step, nparams)) for s in range(0, nparams, step)]


def calls_a_pass(mix: dict, config: dict) -> int:
    """Calls of the port one pass makes."""
    return sum(len(param_slices(c, config["params"])) for c in mix["calls"])


def build_pass(mix: dict, config: dict, sample: torch.Tensor, port,
               mesh=None):
    """A callable that makes one pass and returns ``{output: numpy}``. The
    port's functions are looked up here, once, by name. ``mesh``: this
    rank's ``MeshConfig`` in a world of ranks."""
    calls = []
    for call in mix["calls"]:
        fn = port_function(port, call["fn"])
        for s0, s1 in param_slices(call, config["params"]):
            part = sample if (s0, s1) == (0, config["params"]) else sample[:, :, s0:s1]
            args = [ARG_KINDS[kind](part, config, mesh)
                    for kind in call.get("args", ["sample"])]
            calls.append((call["fn"], fn, args, call.get("kwargs", {}),
                          call["outputs"]))

    def one_pass() -> dict:
        parts = {}
        for name, fn, args, kwargs, outputs in calls:
            with torch.profiler.record_function(f"portbench.call.{name}"):
                res = fn(*args, **kwargs)
            tensors = (res,) if isinstance(res, torch.Tensor) else tuple(res)
            with torch.profiler.record_function("portbench.to_host"):
                for key, t in zip(outputs, tensors):
                    parts.setdefault(key, []).append(t.cpu().numpy())
        return {k: v[0] if len(v) == 1 else np.concatenate(v, axis=-1)
                for k, v in parts.items()}

    return one_pass
