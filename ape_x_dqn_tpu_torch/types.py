"""Transition schema and train state as dataclasses of tensors.

Port of ``ape_x_dqn_tpu/types.py``: ``NStepTransition`` (:35),
``DedupChunk`` and ``materialize_dedup`` (:55-116), ``PrioritizedBatch``
(:120) and ``TrainState`` (:129).  Leaves are torch tensors on device or
numpy arrays on the host (the actor fleet emits numpy; the learner moves
rows to the device once, on ingest).  Observations stay uint8 end to end
and are cast to the compute dtype inside the network.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, NamedTuple, Optional

import numpy as np

if TYPE_CHECKING:   # annotations only: a replay shard process loads no torch
    import torch


@dataclasses.dataclass
class NStepTransition:
    """An n-step transition (batched along the leading axis).

    ``reward`` is the accumulated n-step return R_{t→t+n}; ``discount`` is
    γ^n with terminal masking, so the learner target is
    ``reward + discount * bootstrap`` with no special cases.
    """

    obs: Any          # uint8 [..., *obs_shape] — S_t
    action: Any       # int   [...]             — A_t
    reward: Any       # float32 [...]           — R_{t→t+n}
    discount: Any     # float32 [...]           — prod_k γ·(1−done_k)
    next_obs: Any     # uint8 [..., *obs_shape] — S_{t+n}

    def map(self, fn: Callable[[Any], Any]) -> "NStepTransition":
        """Apply ``fn`` to every field (slice, stack, move to device)."""
        return NStepTransition(*(fn(getattr(self, f.name))
                                 for f in dataclasses.fields(self)))


class DedupChunk(NamedTuple):
    """An actor flush with each frame stored once (the frame-dedup wire
    format, field for field the JAX package's).

    ``frames`` holds the flush's unique observations; each transition
    references its S_t / S_{t+n} by index.  Refs are relative to THIS
    chunk's first frame: ``r >= 0`` → ``frames[r]``; ``r < 0`` → frame
    ``prev_frames + r`` of this source's PREVIOUS chunk (the n-row overlap
    of consecutive sliding windows).  Consumers resolve refs against a
    per-source frame counter; a gap in ``chunk_seq`` (a dropped chunk, a
    respawned worker) invalidates carry refs, and consumers drop just the
    carried rows.

    Layout contract (producers): frames are ordered step-row-major, then
    truncation extras; ``obs_ref < next_ref`` row-wise (liveness checks use
    ``obs_ref`` as each row's oldest frame).
    """

    frames: np.ndarray     # uint8 [U, *obs_shape] — each unique frame once
    obs_ref: np.ndarray    # int32 [M] — S_t ref (negative: carry)
    next_ref: np.ndarray   # int32 [M] — S_{t+n} ref (>= 0 always)
    action: np.ndarray     # int32 [M]
    reward: np.ndarray     # float32 [M] — n-step return
    discount: np.ndarray   # float32 [M] — bootstrap factor
    source: int            # producer identity (fresh per fleet instance)
    chunk_seq: int         # per-source monotone flush counter
    prev_frames: int       # U of this source's previous chunk (carry check)

    def copy(self) -> "DedupChunk":
        """The same chunk over its own writable arrays."""
        return self._replace(**{f: np.array(getattr(self, f)) for f in (
            "frames", "obs_ref", "next_ref", "action", "reward", "discount")})


def materialize_dedup(chunk: DedupChunk, prev: DedupChunk | None = None) -> NStepTransition:
    """Decode a ``DedupChunk`` (plus its predecessor, for carry refs) into a
    dense numpy ``NStepTransition``: the oracle for emission equivalence."""
    neg = chunk.obs_ref < 0
    if neg.any():
        if prev is None:
            raise ValueError("chunk has carry refs but no previous chunk")
        if prev.frames.shape[0] != chunk.prev_frames:
            raise ValueError("previous chunk size mismatch for carry refs")
        carry_idx = np.clip(chunk.prev_frames + chunk.obs_ref, 0, chunk.prev_frames - 1)
        obs = np.where(
            neg[(...,) + (None,) * (chunk.frames.ndim - 1)],
            prev.frames[carry_idx],
            chunk.frames[np.clip(chunk.obs_ref, 0, None)],
        )
    else:
        obs = chunk.frames[chunk.obs_ref]
    return NStepTransition(obs=obs, action=chunk.action, reward=chunk.reward,
                           discount=chunk.discount, next_obs=chunk.frames[chunk.next_ref])


@dataclasses.dataclass
class PrioritizedBatch:
    """A replay sample as fed to the learner: transitions + sampling metadata."""

    transition: NStepTransition
    indices: torch.Tensor     # int32 [B] — replay slots, echoed back for restamp
    is_weights: torch.Tensor  # float32 [B] — importance-sampling weights


@dataclasses.dataclass
class TrainState:
    """Full learner state.

    ``params`` and ``target_params`` are name → tensor dicts in the layout of
    the network's ``state_dict`` (applied with ``torch.func.functional_call``);
    ``opt_state`` is the hand-written optimizer's state dict.  The train step
    updates the tensors in place.  ``step`` is a host int (the JAX package
    keeps a device scalar; here the host owns the count, so the fused loop
    never reads the device to decide a target sync).  ``seed`` roots the
    learner's sampling stream, as the JAX state's PRNG key does.
    ``rng_state`` is that stream's generator state as a checkpoint restored
    it (a uint8 CPU tensor; None: fresh from ``seed``): the fused learners
    adopt it when they are built, so a resumed learner draws the uniforms
    the uninterrupted one would have drawn.
    """

    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int
    seed: int
    rng_state: Optional[torch.Tensor] = None
