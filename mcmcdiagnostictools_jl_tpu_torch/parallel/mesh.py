"""The ``(chains, params)`` process mesh of the sharded diagnostics
(counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package runs one controller over a device ``Mesh`` and ``shard_map``s
its pipelines. Here the execution model is SPMD on ``torch.distributed``: one
process per device, a ``DeviceMesh`` with dims named ``"chains"`` and
``"params"`` over the process group the caller started (``torchrun``, or
``torch.distributed.init_process_group``), and every collective an explicit
call on one of the mesh's two groups. The ``chains`` dim shards the chain
dimension (chains stay where the sampler left them), the ``params`` dim the
parameter dimension. The draw axis is never sharded: each chain's whole
series stays on one device, which the autocovariance needs.

Rank ``r`` of a ``(k, m)`` mesh holds chain block ``r // m`` and parameter
block ``r % m``, the JAX mesh's ``devices.reshape(k, m)`` layout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..convert import to_tensor
from ..utils.layout import canonical_dims

CHAIN_AXIS = "chains"
PARAM_AXIS = "params"

# the process-group backend each device type needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshConfig:
    """A ``(chains, params)`` ``DeviceMesh`` and this rank's device."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def chain_group(self):
        return self.mesh.get_group(CHAIN_AXIS)

    @property
    def param_group(self):
        return self.mesh.get_group(PARAM_AXIS)

    @property
    def chain_shards(self) -> int:
        return self.mesh.size(0)

    @property
    def param_shards(self) -> int:
        return self.mesh.size(1)

    @property
    def chain_index(self) -> int:
        """This rank's chain block."""
        return self.mesh.get_local_rank(CHAIN_AXIS)

    @property
    def param_index(self) -> int:
        """This rank's parameter block."""
        return self.mesh.get_local_rank(PARAM_AXIS)


def _local_device(device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA card; "
                           "pass device_type='cpu' for a gloo mesh on the host")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(chain_shards: int | None = None, param_shards: int = 1,
              device_type: str = "cuda") -> MeshConfig:
    """A ``(chains, params)`` mesh over every rank of the started process
    group; every rank calls it.

    ``chain_shards`` defaults to the world size over ``param_shards``.
    ``device_type="cuda"`` (default) puts rank ``r``'s block on the card
    ``LOCAL_RANK`` (or ``r`` modulo the card count) and needs an NCCL group;
    ``"cpu"`` keeps it on the host and needs gloo. Raises when no process
    group has been started: the mesh never starts one, nor falls back to the
    CPU.
    """
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a started process group: run under torchrun or "
            "call torch.distributed.init_process_group first "
            f"({_BACKENDS[device_type]!r} for device_type={device_type!r})")
    backend = str(dist.get_backend())
    if _BACKENDS[device_type] not in backend:
        raise ValueError(f"device_type={device_type!r} needs a "
                         f"{_BACKENDS[device_type]!r} process group, got "
                         f"{backend!r}")
    n = dist.get_world_size()
    if chain_shards is None:
        chain_shards = n // param_shards
    if chain_shards < 1 or param_shards < 1 or chain_shards * param_shards != n:
        raise ValueError(
            f"chain_shards * param_shards must equal the world size "
            f"({chain_shards} * {param_shards} != {n})")
    device = _local_device(device_type)
    mesh = init_device_mesh(device_type, (chain_shards, param_shards),
                            mesh_dim_names=(CHAIN_AXIS, PARAM_AXIS))
    return MeshConfig(mesh, device)


def canonical_host(samples, min_ndim: int = 1):
    """Global ``(draws, chains[, params...])`` input as ``(draws, chains, P)``
    where it lies (a tensor stays on its device, anything else becomes a
    numpy array), plus the parameter shape."""
    x = samples if isinstance(samples, torch.Tensor) else np.asarray(samples)
    return canonical_dims(x, min_ndim)


def shard_canonical(x3, cfg: MeshConfig, chain_order=None) -> torch.Tensor:
    """This rank's ``(draws, chains / k, P / m)`` block of a canonical global
    sample, on the mesh's device: only the block crosses to it. Numpy
    float64 becomes float32 on the card (``convert.to_tensor``), a tensor
    keeps its dtype. ``chain_order``: the chains in this order first (the
    nested R-hat's superchains made contiguous). Chains and parameters must
    divide evenly."""
    _, c, p = x3.shape
    k, m = cfg.chain_shards, cfg.param_shards
    if c % k or p % m:
        raise ValueError(
            f"the sample's chains ({c}) and parameters ({p}) must divide "
            f"evenly across the mesh's {k} chain and {m} parameter shards")
    c_loc, p_loc = c // k, p // m
    i, j = cfg.chain_index, cfg.param_index
    chains = (slice(i * c_loc, (i + 1) * c_loc) if chain_order is None
              else np.asarray(chain_order)[i * c_loc:(i + 1) * c_loc])
    if isinstance(x3, torch.Tensor):
        if chain_order is not None:
            chains = torch.as_tensor(chains, device=x3.device)
        block = x3[:, chains, j * p_loc:(j + 1) * p_loc].to(cfg.device)
    else:
        block = to_tensor(np.ascontiguousarray(
            x3[:, chains, j * p_loc:(j + 1) * p_loc]), cfg.device)
    if not block.is_floating_point():  # as utils.layout.canonicalize
        block = block.to(torch.get_default_dtype())
    return block.contiguous()
