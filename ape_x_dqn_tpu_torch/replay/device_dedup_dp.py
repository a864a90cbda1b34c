"""Sharded frame-dedup device replay: one dedup ring shard per data slot.

Port of ``ape_x_dqn_tpu/replay/device_dedup_dp.py``.  The structure is
``replay/device_dp.py``'s (one shard per slot, the K-step body per slot,
the gradient reduced over the slots each step) with one routing
difference: a transition gathers its frames by reference, so it must live
on the shard that holds them.  Chunks therefore route WHOLE to one shard
— the host stager pins each SOURCE to a shard (``runtime/fused_dedup.
DedupStager``) — and every ingest block is ``[n, block]``, shard d taking
row d.  Each shard keeps its own frame sequence space modulo its own
``shard_seq_modulus`` (that of its local frame ring of Cf / n frames).
Sampling is the sharded law of ``device.sample_slots`` (shards contribute
equally), through ``dedup_sample_many``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ape_x_dqn_tpu_torch.replay.device_dedup import (
    dedup_device_add_frames,
    dedup_device_add_transitions,
    dedup_sample_many,
    init_dedup_device_replay,
)
from ape_x_dqn_tpu_torch.replay.device_dp import (
    ShardedReplay,
    build_sharded_fused_learn_step,
)


def init_sharded_dedup_replay(
    capacity: int,
    obs_shape,
    mesh,
    frame_capacity: Optional[int] = None,
    frame_ratio: float = 1.25,
    obs_dtype=torch.uint8,
) -> ShardedReplay:
    """The dedup ring split over the mesh's data slots: shard d holds
    capacity / n transitions and frame_capacity / n frames on slot d's
    device.  ``frame_capacity`` defaults to round(capacity · frame_ratio)
    rounded down to a multiple of n (JAX :62)."""
    devs = mesh.data_devices
    n = len(devs)
    if frame_capacity is None:
        frame_capacity = max(n, int(round(capacity * frame_ratio)))
        frame_capacity -= frame_capacity % n
    if capacity % n or frame_capacity % n:
        raise ValueError(f"capacity {capacity} and frame_capacity {frame_capacity} must "
                         f"divide by the data-axis extent {n} (per-device ring shards)")
    return ShardedReplay([init_dedup_device_replay(capacity // n, obs_shape,
                                                   frame_capacity // n, device=dev,
                                                   obs_dtype=obs_dtype)
                          for dev in devs])


def shard_seq_modulus(frame_capacity: int, n: int) -> int:
    """The per-shard seq modulus the host stager reduces refs by: each
    shard's local frame ring holds frame_capacity / n frames, so
    Q = ⌊2³⁰ / (Cf/n)⌋ · (Cf/n)."""
    cf = frame_capacity // n
    return ((1 << 30) // cf) * cf


def _rows(a, d: int, dev: torch.device) -> torch.Tensor:
    t = a[d]
    return (t if isinstance(t, torch.Tensor) else torch.as_tensor(t)).to(dev)


def sharded_dedup_add_frames(state: ShardedReplay, frames) -> ShardedReplay:
    """Per-shard frame blocks: ``frames`` is [n, B_f, *obs] (or n blocks,
    each on its shard's device), shard d appending frames[d] (JAX :110)."""
    for d, shard in enumerate(state.shards):
        dedup_device_add_frames(shard, _rows(frames, d, shard.frames.device))
    return state


def sharded_dedup_add_transitions(state: ShardedReplay, obs_ref, next_ref, action, reward,
                                  discount, priorities,
                                  priority_exponent: float = 0.6) -> ShardedReplay:
    """Per-shard transition blocks (and each shard's liveness sweep): every
    argument is [n, block] (or n blocks), shard d taking row d (JAX :129);
    refs already reduced mod the shard's Q."""
    for d, shard in enumerate(state.shards):
        dev = shard.mass.device
        dedup_device_add_transitions(
            shard, *(_rows(a, d, dev) for a in (obs_ref, next_ref, action, reward,
                                                discount, priorities)),
            priority_exponent)
    return state


def build_sharded_dedup_fused_learn_step(
    train_step_fn,
    mesh,
    batch_size: int,
    steps_per_call: int = 1,
    priority_exponent: float = 0.6,
    target_sync_freq: Optional[int] = 2500,
    sample_ahead: bool = False,
) -> Callable:
    """The sharded dedup twin of ``device_dp.build_sharded_fused_learn_step``
    (JAX :155): the same contract (global batch, B / n rows per shard, the
    gradient reduced over the slots each step), the dedup gather."""
    return build_sharded_fused_learn_step(
        train_step_fn, mesh, batch_size, steps_per_call=steps_per_call,
        priority_exponent=priority_exponent, target_sync_freq=target_sync_freq,
        sample_ahead=sample_ahead, sample_many_fn=dedup_sample_many)
