"""Frame-dedup device replay: the ring in device memory storing each frame once.

Port of ``ape_x_dqn_tpu/replay/device_dedup.py``.  The double-store ring
(``device.py``) carries ``obs`` AND ``next_obs``; this one holds a FRAME
ring of ``frame_capacity`` observations plus int32 frame references per
transition, ~frame_ratio/2 of the double-store's bytes.  At the paper's
2 000 000 slots and ``frame_ratio`` 1.25 that is 2 500 000 × 7 056 B =
17.64 GB of frames plus 48 MB of columns, against 28.22 GB of frames for
the double-store, so one 80 GB card holds the whole ring.

Addressing is the JAX package's, so ring states compare array for array
across the packages:
  * frame sequence numbers live modulo ``Q = (2^30 // Cf) · Cf``, a
    multiple of the ring size, so ``slot = seq mod Cf`` survives the seq
    wrap and every intermediate fits int32.  The host stager keeps true
    int64 counters and ships refs already reduced mod Q.
  * liveness is the wrap-aware age ``(fcount − ref) mod Q ≤ Cf``.  Every
    transition ingest sweeps the whole mass vector with that test, so a
    transition whose frames were overwritten is unsampleable from the same
    ingest that overwrote them.

As in ``device.py``, these functions update the state in place and return
it; ``cursor``, ``count`` and ``fcount`` are host ints (the host decides
every ring position).  Sampling, IS weights, restamps and the K-step loop
are ``device.py``'s (``FusedBody``): ``dedup_sample_many`` goes through
``device.sample_slots`` (the CUDA sampler on a CUDA tensor, its plain
version on a CPU tensor) and only the frame gather differs.  All modular
arithmetic uses ``torch.remainder`` (floor-mod, as jnp ``%``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ape_x_dqn_tpu_torch.replay.device import _mass, sample_slots
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch

COUNT_CAP = 1 << 30   # ``count`` saturates here, as the JAX ring's int32 does


@dataclasses.dataclass
class DedupDeviceReplayState:
    frames: torch.Tensor     # uint8 [Cf, *obs_shape] — each unique frame once
    obs_ref: torch.Tensor    # int32 [C] — S_t frame seq (mod Q)
    next_ref: torch.Tensor   # int32 [C] — S_{t+n} frame seq (mod Q)
    action: torch.Tensor     # int32 [C]
    reward: torch.Tensor     # float32 [C]
    discount: torch.Tensor   # float32 [C]
    mass: torch.Tensor       # float32 [C] — p^α, 0 marks empty/dead
    cursor: int = 0          # transition ring position
    count: int = 0           # transitions ever added (saturating)
    fcount: int = 0          # frame seq counter (mod Q)

    @property
    def capacity(self) -> int:
        return self.mass.shape[0]

    @property
    def frame_capacity(self) -> int:
        return self.frames.shape[0]

    @property
    def seq_modulus(self) -> int:
        # Largest multiple of the ring size below 2^30 (JAX :72-78).
        return ((1 << 30) // self.frame_capacity) * self.frame_capacity

    def nbytes(self) -> dict:
        """Device bytes of the frame ring and of the per-slot columns."""
        cols = (self.obs_ref, self.next_ref, self.action, self.reward,
                self.discount, self.mass)
        return {"frames": self.frames.nbytes, "columns": sum(c.nbytes for c in cols)}


def init_dedup_device_replay(
    capacity: int,
    obs_shape,
    frame_capacity: Optional[int] = None,
    frame_ratio: float = 1.25,
    device: str | torch.device = "cuda",
    obs_dtype=torch.uint8,
) -> DedupDeviceReplayState:
    """``frame_capacity`` defaults to ``round(capacity · frame_ratio)``; it
    must cover the emission's frame/transition arrival ratio or the oldest
    transitions die early (gracefully: their mass goes to 0)."""
    if frame_capacity is None:
        frame_capacity = max(1, int(round(capacity * frame_ratio)))

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DedupDeviceReplayState(
        frames=z((frame_capacity, *obs_shape), obs_dtype),
        obs_ref=z((capacity,), torch.int32),
        next_ref=z((capacity,), torch.int32),
        action=z((capacity,), torch.int32),
        reward=z((capacity,), torch.float32),
        discount=z((capacity,), torch.float32),
        mass=z((capacity,), torch.float32),
    )


def dedup_device_add_frames(state: DedupDeviceReplayState,
                            frames: torch.Tensor) -> DedupDeviceReplayState:
    """Append a frame block and advance ``fcount`` mod Q.  The liveness
    sweep rides the transition ingest (the runtime always ships a block's
    frames before the transitions that reference them)."""
    U = frames.shape[0]
    Cf = state.frame_capacity
    if U > Cf:
        # A block wider than the ring would write one slot twice in one
        # scatter, whose order is unspecified on CUDA.
        raise ValueError(f"frame block {U} exceeds frame ring {Cf}")
    Q = state.seq_modulus
    seq = torch.arange(U, device=state.frames.device) + state.fcount
    state.frames[torch.remainder(torch.remainder(seq, Q), Cf)] = frames
    state.fcount = (state.fcount + U) % Q
    return state


def dedup_device_add_transitions(
    state: DedupDeviceReplayState,
    obs_ref: torch.Tensor,     # int32 [M] absolute seqs mod Q (host-resolved)
    next_ref: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    discount: torch.Tensor,
    priorities: torch.Tensor,
    priority_exponent: float = 0.6,
) -> DedupDeviceReplayState:
    """Ring-insert a transition block, then sweep the whole mass vector:
    rows whose obs frame aged out of the frame ring get mass 0."""
    M = priorities.shape[0]
    C = state.capacity
    if M > C:
        raise ValueError(f"chunk of {M} transitions exceeds replay capacity {C}")
    idx = torch.remainder(torch.arange(M, device=state.mass.device) + state.cursor, C)
    state.obs_ref[idx] = obs_ref.to(torch.int32)
    state.next_ref[idx] = next_ref.to(torch.int32)
    state.action[idx] = action.to(torch.int32)
    state.reward[idx] = reward.to(torch.float32)
    state.discount[idx] = discount.to(torch.float32)
    state.mass[idx] = _mass(priorities, priority_exponent)
    state.cursor = (state.cursor + M) % C
    state.count = min(state.count + M, COUNT_CAP)
    # obs_ref is each row's OLDEST frame (DedupChunk layout contract), so
    # one age test invalidates exactly the frame-dead rows.
    dead = torch.remainder(state.fcount - state.obs_ref, state.seq_modulus) \
        > state.frame_capacity
    state.mass.masked_fill_(dead, 0.0)
    return state


def dedup_sample_many(
    state: DedupDeviceReplayState,
    num_batches: int,
    batch_size: int,
    beta=0.4,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    size: Optional[torch.Tensor] = None,
) -> PrioritizedBatch:
    """K stratified batches over the dedup layout: ``device.sample_slots``'s
    law and IS weights (``beta`` and ``size`` as there); the frames are
    gathered through the refs."""
    K, B = num_batches, batch_size
    idx, weights = sample_slots(state.mass, state.count, K, B, beta, u, generator, size)
    idx2 = idx.reshape(K, B)
    Cf = state.frame_capacity
    obs = state.frames[torch.remainder(state.obs_ref[idx2].long(), Cf)]
    next_obs = state.frames[torch.remainder(state.next_ref[idx2].long(), Cf)]
    return PrioritizedBatch(
        transition=NStepTransition(
            obs=obs,
            action=state.action[idx2],
            reward=state.reward[idx2],
            discount=state.discount[idx2],
            next_obs=next_obs,
        ),
        indices=idx2.to(torch.int32),
        is_weights=weights,
    )


def build_dedup_fused_learn_step(
    train_step_fn,
    batch_size: int,
    steps_per_call: int = 1,
    priority_exponent: float = 0.6,
    target_sync_freq: int | None = 2500,
    sample_ahead: bool = False,
) -> Callable:
    """The dedup twin of ``device.build_fused_learn_step``: the same K-step
    [sample → train → restamp] body (``device.FusedBody`` with
    ``dedup_sample_many``) and the same hoisted target sync, as one
    ``GraphedCall`` (eager on the CPU, CUDA-graph replays on a card).

    Returns ``fn(train_state, replay_state, beta, u=None, generator=None)``
    → ``(train_state, replay_state, metrics)``.  Ingest stays outside the
    call (``FusedDedupLearner.supports_ingest_fold`` is False)."""
    from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall

    return GraphedCall(train_step_fn, steps_per_call=steps_per_call,
                       batch_size=batch_size, priority_exponent=priority_exponent,
                       target_sync_freq=target_sync_freq, sample_ahead=sample_ahead,
                       sample_many_fn=dedup_sample_many)
