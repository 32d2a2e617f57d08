"""Device mesh and sharding rules on torch.distributed (port of
p3achygo_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ('data', 'model') mesh of
devices in one process. Here each rank is one process on one device (one
card under NCCL, one CPU process under gloo), and the mesh is a
`DeviceMesh` of ranks with the same two dimensions: batches are sharded
over 'data', large kernels optionally over 'model' (tensor parallelism),
everything else replicated.

Placements are DTensors built from each rank's own copy of the full
tensor (as JAX's device_put places a host array): every rank must hold
the same values; `distributed.replicate` broadcasts rank 0's first where
they may differ. No placement here communicates.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from p3achygo_tpu_torch.bridge import flax_dims

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> DeviceMesh:
    """(data, model) mesh of ranks 0 .. n_devices - 1 (default: every rank
    of the process group) as an [n // model_parallel, model_parallel] grid;
    its device type follows the process group's backend (NCCL: cuda)."""
    n = n_devices or dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_partition_spec(leaf: torch.Tensor, model_parallel: int,
                         name: str) -> Tuple[Placement, Placement]:
    """TP rule of JAX mesh.py:34-47 over the (data, model) mesh: shard a
    parameter's output channels over 'model' when there are a multiple of
    the model axis and at least 8 per rank, replicate everything else
    (1-D leaves: biases, BatchNorm and LayerNorm vectors and statistics).
    The rule reads the flax layout (`bridge.to_flax_layout`), whose last
    dimension is the output channels: dim 0 of the port's [out, in, ...]
    conv and Dense weights, dim 2 of an attention query/key/value kernel
    [C, H, D]."""
    if model_parallel <= 1 or leaf.dim() < 2:
        return (Replicate(), Replicate())
    out_dim = flax_dims(leaf.dim(), name)[-1]
    out = leaf.shape[out_dim]
    if out % model_parallel == 0 and out >= 8 * model_parallel:
        return (Replicate(), Shard(out_dim))
    return (Replicate(), Replicate())


def _place(t: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """DTensor of this rank's part of `t`, the full tensor every rank holds
    (a copy: the DTensor shares no storage with `t`)."""
    local = t.detach()
    coord = mesh.get_coordinate()
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(dim), dim=p.dim)[coord[dim]]
    return DTensor.from_local(local.clone(), mesh, placements, run_check=False)


def map_named(tree: Any, fn, name: str = "") -> Any:
    """fn(tensor, name) over nested dicts whose tensors (or numpy arrays)
    are keyed by parameter name (a state dict, or an optimizer state's
    per-parameter dicts) and NamedTuples of tensors; other leaves (step
    counts) stay."""
    if isinstance(tree, Mapping):
        return {k: map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, tuple):  # tuples and NamedTuples: states, targets
        vals = [map_named(v, fn, name) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, name)
    return tree


def shard_params(params: Any, mesh: DeviceMesh, model_parallel: int = 1) -> Any:
    """Place parameter tensors (keyed by name, nested dicts allowed) on the
    mesh by the TP rule."""
    return map_named(params, lambda t, k: _place(
        t, mesh, param_partition_spec(t, model_parallel, k)))


def shard_batch(tree: Any, mesh: DeviceMesh) -> Any:
    """Shard the leading (batch) dim of every tensor over 'data'."""
    return map_named(tree, lambda t, _: _place(t, mesh, (Shard(0), Replicate())))


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor replicated over the mesh."""
    return map_named(tree, lambda t, _: _place(t, mesh, (Replicate(), Replicate())))
