"""Parallelism layer: device mesh, shardings, the data-parallel learner
step, multi-process initialisation.  Port of ``ape_x_dqn_tpu/parallel``."""

from ape_x_dqn_tpu_torch.parallel.dp import build_sharded_train_step, place_batch
from ape_x_dqn_tpu_torch.parallel.mesh import (
    batch_sharding,
    infer_param_sharding,
    make_mesh,
    place_state,
    replicated,
    shard_train_state,
    tree_batch_sharding,
)
from ape_x_dqn_tpu_torch.parallel.multihost import (
    host_value,
    initialize_multihost,
    local_shard,
)

__all__ = [
    "batch_sharding",
    "build_sharded_train_step",
    "host_value",
    "infer_param_sharding",
    "initialize_multihost",
    "local_shard",
    "make_mesh",
    "place_batch",
    "place_state",
    "replicated",
    "shard_train_state",
    "tree_batch_sharding",
]
