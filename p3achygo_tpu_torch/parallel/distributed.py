"""Multi-process scale-out on torch.distributed (port of
p3achygo_tpu/parallel/distributed.py).

The JAX package joins every host into one jax.distributed cluster and
runs one SPMD program over the global mesh. Here every rank is one
process on one device, joined by `torch.distributed` (NCCL between cards,
gloo between CPU processes):

- every rank runs the same program and calls `init_multihost` (a TCP
  rendezvous at the coordinator's address);
- self-play boards are sharded over the mesh's 'data' dimension: each
  rank owns a contiguous slab of boards (`host_local_to_global` wraps its
  slab as its shard of a global DTensor without gathering);
- golden weights are replicated (`replicate`: a broadcast from rank 0);
- the train step is the one-process step with its batch statistics,
  loss means and gradients all-reduced over the 'data' group
  (`make_sharded_train_step`).

Harvest stays rank-local: each rank reads back only its own rows
(`local_shards`), finalizes its games and feeds its own replay.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.parallel import mesh as mesh_lib
from p3achygo_tpu_torch.parallel.mesh import DATA_AXIS, map_named
from p3achygo_tpu_torch.train.step import TrainState, batch_stats_of, make_train_step


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   local_device_count: Optional[int] = None,
                   device: str = "cuda") -> None:
    """Join this process to the cluster as rank `process_id` of
    `num_processes`, with a TCP rendezvous at `coordinator_address`
    ("host:port"; rank 0 listens there). On the card (the default) the
    backend is NCCL and the rank takes card `process_id % device_count`;
    `device="cpu"` takes gloo.

    `local_device_count` has no counterpart here: JAX fans one process out
    over several (virtual) devices, while a torch rank is one process on
    one device. On the card a value above 1 is refused; on the CPU it is
    accepted and changes nothing (each gloo rank is one process)."""
    on_card = device != "cpu"
    if on_card and local_device_count is not None and local_device_count > 1:
        raise ValueError("one rank per card: start one process per card instead "
                         f"of local_device_count={local_device_count}")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: no CUDA card; pass device='cpu' for gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_mesh(model_parallel: int = 1) -> DeviceMesh:
    """(data, model) mesh over every rank of every process."""
    return mesh_lib.make_mesh(dist.get_world_size(), model_parallel=model_parallel)


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Broadcast rank 0's tensors to every rank and replicate them over the
    mesh: the golden-weight distribution step."""
    def bcast(t, _):
        t = t.detach().to(_device(mesh)).clone()
        dist.broadcast(t, src=0)
        return t
    return mesh_lib.replicate(map_named(tree, bcast), mesh)


def shard_params_global(params: Any, mesh: DeviceMesh, model_parallel: int) -> Any:
    """TP rule over the global mesh (replicated where not partitioned)."""
    return mesh_lib.shard_params(params, mesh, model_parallel)


def host_local_to_global(tree: Any, mesh: DeviceMesh) -> Any:
    """Each rank's slab (global_batch / data-dim rows, numpy arrays or
    tensors) as its shard of global batch-sharded DTensors: no rank
    materialises the whole batch. Ranks of one 'model' group pass the same
    slab."""
    dev = _device(mesh)

    def put(x, _):
        local = torch.as_tensor(x, device=dev)
        return DTensor.from_local(local, mesh, (Shard(0), Replicate()), run_check=False)
    return map_named(tree, put)


def local_shards(tree: Any) -> Any:
    """This rank's rows of batch-sharded DTensors, as numpy arrays (the
    rank-local harvest: finished games feed the local replay)."""
    return map_named(
        tree, lambda t, _: (t.to_local() if isinstance(t, DTensor) else t).cpu().numpy())


def make_sharded_train_step(model, tx, coeffs: LossCoeffs, mesh, model_parallel: int):
    """-> step(state, planes, scalars, targets) -> (state, losses) over the
    mesh. `state` holds DTensors placed by the TP rule (`shard_params` of
    params, batch_stats and opt_state); the batch is sharded over 'data'.
    Each sharded tensor is gathered at use (as XLA gathers a channel-sharded
    kernel), the step is the one-process step over the 'data' group, and
    the new state is placed again by the rule."""
    step = make_train_step(model, tx, coeffs, data_group=mesh.get_group(DATA_AXIS))
    full = lambda t, _: t.full_tensor() if isinstance(t, DTensor) else t
    local = lambda t, _: t.to_local() if isinstance(t, DTensor) else t

    def sharded_step(state: TrainState, planes, scalars, targets):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(full(state.params[k], k))
            for k, b in batch_stats_of(model).items():
                b.copy_(full(state.batch_stats[k], k))
        gathered = TrainState(params=dict(model.named_parameters()),
                              batch_stats=batch_stats_of(model),
                              opt_state=map_named(state.opt_state, full), step=state.step)
        new, losses = step(gathered, local(planes, ""), local(scalars, ""),
                           map_named(targets, local))
        place = lambda tree: mesh_lib.shard_params(tree, mesh, model_parallel)
        return TrainState(params=place(new.params), batch_stats=place(new.batch_stats),
                          opt_state=place(new.opt_state), step=new.step), losses

    return sharded_step
