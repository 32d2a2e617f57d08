"""Mesh and sharding utilities for multi-device scale-out on
torch.distributed (port of p3achygo_tpu/parallel)."""
from p3achygo_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    param_partition_spec,
    replicate,
    shard_batch,
    shard_params,
)
