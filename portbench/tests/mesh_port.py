"""A stand-in for the port's rank-local nested R-hat, for the tests of a world
of ranks (``portbench/world.py``).

The port's ``parallel.rhat_nested_sharded`` takes the global sample on every
rank; a rank of a world holds only its own block of chains. The stand-in
all-gathers the blocks over the mesh's chain group and calls it. Beside the
sound call, each of the faults a world can have, planted where the answer is
produced: one rank's answer altered, one rank's block left out, one rank
that raises; and one rank that loads a module of the JAX side once the
window has closed. The harness reads ``parallel`` and ``kernels`` of a port; they
are the port's own.
"""

from __future__ import annotations

import sys
import types
import weakref

import numpy as np
import torch
import torch.distributed as dist

from mcmcdiagnostictools_jl_tpu_torch import kernels, parallel  # noqa: F401


def _global(block: torch.Tensor, mesh) -> torch.Tensor:
    parts = [torch.empty_like(block) for _ in range(mesh.chain_shards)]
    dist.all_gather(parts, block.contiguous(), group=mesh.chain_group)
    return torch.cat(parts, dim=1)


def rhat_nested_local(block, superchain_ids, mesh, **kw):
    return parallel.rhat_nested_sharded(_global(block, mesh), superchain_ids,
                                        mesh, **kw)


def rhat_nested_local_altered(block, superchain_ids, mesh, **kw):
    """Rank 1's answer for parameter 1 moved by 1e-2."""
    out = rhat_nested_local(block, superchain_ids, mesh, **kw)
    if dist.get_rank() == 1:
        out = out.clone()
        out[1] += 1e-2
    return out


def rhat_nested_local_missing_block(block, superchain_ids, mesh, **kw):
    """The last rank's block left out: every rank computes over the others'
    chains and their superchains."""
    full = _global(block, mesh)
    keep = full.shape[1] - block.shape[1]
    ids = np.asarray(superchain_ids)[:keep]
    return parallel.rhat_nested_sharded(full[:, :keep], ids, mesh, **kw)


def rhat_nested_local_raises(block, superchain_ids, mesh, **kw):
    """Rank 1 raises at its first call."""
    if dist.get_rank() == 1:
        raise RuntimeError("a rank of the world fails")
    return rhat_nested_local(block, superchain_ids, mesh, **kw)


def _load_jax() -> None:
    sys.modules.setdefault("jax", types.ModuleType("jax"))


def rhat_nested_local_loads_jax(block, superchain_ids, mesh, **kw):
    """Rank 1 puts a module named ``jax`` in ``sys.modules`` when its
    arguments are freed: after the window, as the harness frees the
    program's state."""
    if dist.get_rank() == 1:
        weakref.finalize(block, _load_jax)
    return rhat_nested_local(block, superchain_ids, mesh, **kw)
