"""Sharded diagnostics over a ``(chains, params)`` process mesh on
``torch.distributed`` (counterpart of the JAX package's ``parallel/``).
Importing it starts no process group: ``make_mesh`` uses the one the
caller started."""

from .mesh import CHAIN_AXIS, PARAM_AXIS, MeshConfig, make_mesh, shard_canonical
from .sharded import ess_rhat_sharded, rhat_nested_sharded

__all__ = [
    "MeshConfig",
    "make_mesh",
    "shard_canonical",
    "ess_rhat_sharded",
    "rhat_nested_sharded",
    "CHAIN_AXIS",
    "PARAM_AXIS",
]
