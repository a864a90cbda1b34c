"""The data-parallel learner step over a mesh.

Port of ``ape_x_dqn_tpu/parallel/dp.py``.  JAX jits the fused step with
mesh shardings and lets XLA's partitioner insert the gradient all-reduce;
the port's one controller per process runs the same step on every data
slot of its mesh (``parallel/mesh.py``):

* the host batch's leading axis splits contiguously over the data slots
  (``place_batch``);
* the step is ``build_train_step(..., grad_reduce_axis="data")``: each
  slot's local-mean gradient, their mean over the slots (and across
  processes when a process group is up), and every replica stepped on
  that one mean;
* the priorities come back in global row order: slot by slot, this
  process's rows (``multihost.local_shard``).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
from ape_x_dqn_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTrainState,
    place_state,
    shard_train_state,
)
from ape_x_dqn_tpu_torch.parallel.multihost import local_rows
from ape_x_dqn_tpu_torch.types import PrioritizedBatch, TrainState


def build_sharded_train_step(
    network,
    optimizer,
    mesh: Mesh,
    state_example: TrainState,
    batch_example: PrioritizedBatch = None,
    loss_kind: str = "huber",
    target_sync_freq: int = 2500,
    sync_in_step: bool = True,
) -> Tuple[Callable, ShardedTrainState]:
    """Build the mesh step and lay the state out on the mesh.

    Returns ``(step_fn, sharded_state)``; ``step_fn(sharded_state,
    batches) -> (sharded_state, metrics)`` updates the state in place.
    ``batches`` is ``place_batch``'s (or ``place_local_batch``'s) list, one
    batch per local data slot.  ``batch_example`` is accepted for the JAX
    signature's sake: the port needs no example to lay a batch out."""
    del batch_example
    step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                               target_sync_freq=target_sync_freq,
                               sync_in_step=sync_in_step, grad_reduce_axis="data")
    return step_fn, place_state(state_example, shard_train_state(state_example, mesh))


def _split_rows(batch: PrioritizedBatch, mesh: Mesh) -> List[PrioritizedBatch]:
    n = mesh.local_data
    rows = len(batch.indices)
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} data slots")
    per = rows // n

    def put(a, d, dev):
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        return t[d * per:(d + 1) * per].to(dev, copy=True)

    out = []
    for d, dev in enumerate(mesh.data_devices):
        out.append(PrioritizedBatch(
            transition=batch.transition.map(lambda a: put(a, d, dev)),
            indices=put(batch.indices, d, dev),
            is_weights=put(batch.is_weights, d, dev)))
    return out


def place_batch(batch: PrioritizedBatch, mesh: Mesh) -> List[PrioritizedBatch]:
    """Split a host batch over the mesh's data slots (leading dim,
    contiguous), one batch on each slot's device.  The caller holds the
    FULL global batch; in a process group this process takes its rows."""
    sl = local_rows(len(batch.indices))

    def take(a):
        return a[sl]

    local = PrioritizedBatch(transition=batch.transition.map(take),
                             indices=take(batch.indices), is_weights=take(batch.is_weights))
    return _split_rows(local, mesh)


def place_local_batch(local_batch: PrioritizedBatch, mesh: Mesh) -> List[PrioritizedBatch]:
    """Split this process's own rows (sampled from its local replay) over
    its data slots: global row order is process order, the inverse of
    ``multihost.local_shard``."""
    return _split_rows(local_batch, mesh)
