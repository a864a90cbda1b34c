"""Device-resident prioritized replay — sample, train and restamp on the card.

Port of ``ape_x_dqn_tpu/replay/device.py``.  The whole ring lives in device
memory; after an actor chunk crosses to the device once on ingest, the
stratified prioritized sample (the CUDA sampler in ``ops/sampling.py``), IS
weights, the train step and the priority write-back all run there with no
further transfer and no host synchronisation.

Semantics follow the JAX module: mass = max(p, 1e-12)^α with 0 marking an
empty slot; stratified targets clamped to total·(1−1e-7); the zero-mass
guard ``idx = min(idx, size−1)``; β-annealed IS weights normalised by the
batch max; restamps with sequential last-wins semantics.  Where the JAX
functions return a new state, these update ``state`` in place and return
it.  ``cursor`` and ``count`` are host ints: the host decides every ring
position, so it never reads them back from the device.

The sampler functions take an optional ``u`` [K, B] of uniforms; when it is
absent they draw it from ``generator``.  Tests inject JAX's draws this way
(``device.py:149`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from ape_x_dqn_tpu_torch.learner.train_step import StepMetrics, sync_target_
from ape_x_dqn_tpu_torch.ops.sampling import sample_indices
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch


@dataclasses.dataclass
class DeviceReplayState:
    obs: torch.Tensor        # uint8 [C, *obs_shape]
    next_obs: torch.Tensor   # uint8 [C, *obs_shape]
    action: torch.Tensor     # int32 [C]
    reward: torch.Tensor     # float32 [C]
    discount: torch.Tensor   # float32 [C]
    mass: torch.Tensor       # float32 [C] — p^α, 0 marks an empty slot
    cursor: int = 0
    count: int = 0           # total ever added (size = min(count, C))

    @property
    def capacity(self) -> int:
        return self.mass.shape[0]


def init_device_replay(capacity: int, obs_shape, device: str | torch.device = "cuda",
                       obs_dtype=torch.uint8) -> DeviceReplayState:
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DeviceReplayState(
        obs=z((capacity, *obs_shape), obs_dtype),
        next_obs=z((capacity, *obs_shape), obs_dtype),
        action=z((capacity,), torch.int32),
        reward=z((capacity,), torch.float32),
        discount=z((capacity,), torch.float32),
        mass=z((capacity,), torch.float32),
    )


def _mass(priorities: torch.Tensor, priority_exponent: float) -> torch.Tensor:
    return torch.pow(torch.clamp(priorities.to(torch.float32), min=1e-12),
                     priority_exponent)


def device_replay_add(
    state: DeviceReplayState,
    transitions: NStepTransition,
    priorities: torch.Tensor,
    priority_exponent: float = 0.6,
) -> DeviceReplayState:
    """Ring-insert a chunk of M rows already on the device.  FIFO overwrite
    is eviction, and the slot's mass is replaced."""
    M = priorities.shape[0]
    C = state.capacity
    if M > C:
        # A chunk wider than the ring would write one slot twice in one
        # scatter, whose order is unspecified on CUDA.
        raise ValueError(f"chunk of {M} transitions exceeds replay capacity {C}")
    idx = (state.cursor + torch.arange(M, device=state.mass.device)) % C
    state.obs[idx] = transitions.obs
    state.next_obs[idx] = transitions.next_obs
    state.action[idx] = transitions.action.to(torch.int32)
    state.reward[idx] = transitions.reward.to(torch.float32)
    state.discount[idx] = transitions.discount.to(torch.float32)
    state.mass[idx] = _mass(priorities, priority_exponent)
    state.cursor = (state.cursor + M) % C
    state.count += M
    return state


def sample_slots(
    mass: torch.Tensor,
    count: int,
    num_batches: int,
    batch_size: int,
    beta: float,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """The sampling law every device layout shares: K stratified batches of
    slots from ``mass`` in one sampler launch, and their β-annealed IS
    weights normalised by each batch's max.  Returns (slots int64 [K*B],
    weights float32 [K, B])."""
    K, B = num_batches, batch_size
    dev = mass.device
    total = torch.sum(mass)
    bounds = total / B
    if u is None:
        u = torch.rand((K, B), generator=generator, device=dev)
    u = u.to(device=dev, dtype=torch.float32)
    targets = (torch.arange(B, dtype=torch.float32, device=dev)[None, :] + u) * bounds
    targets = torch.minimum(targets, total * (1.0 - 1e-7))
    idx = sample_indices(mass, targets.reshape(-1).contiguous())   # [K*B]
    size = max(min(count, mass.shape[0]), 1)
    idx = torch.clamp(idx, max=size - 1).long()  # zero-mass guard
    probs = mass[idx] / torch.clamp(total, min=1e-12)
    weights = torch.pow(torch.clamp(size * probs, min=1e-12), -beta).reshape(K, B)
    return idx, weights / weights.max(dim=1, keepdim=True).values


def device_replay_sample_many(
    state: DeviceReplayState,
    num_batches: int,
    batch_size: int,
    beta: float = 0.4,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PrioritizedBatch:
    """K stratified batches from the current priorities in one sampler
    launch plus one row gather; leaves get leading [K, B]."""
    idx, weights = sample_slots(state.mass, state.count, num_batches, batch_size,
                                beta, u, generator)
    idx2 = idx.reshape(num_batches, batch_size)
    return PrioritizedBatch(
        transition=NStepTransition(
            obs=state.obs[idx2],
            action=state.action[idx2],
            reward=state.reward[idx2],
            discount=state.discount[idx2],
            next_obs=state.next_obs[idx2],
        ),
        indices=idx2.to(torch.int32),
        is_weights=weights,
    )


def _row(batch: PrioritizedBatch, k: int) -> PrioritizedBatch:
    return PrioritizedBatch(
        transition=batch.transition.map(lambda a: a[k]),
        indices=batch.indices[k],
        is_weights=batch.is_weights[k],
    )


def device_replay_sample(
    state: DeviceReplayState,
    batch_size: int,
    beta: float = 0.4,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PrioritizedBatch:
    """One stratified batch: the K=1 case of ``device_replay_sample_many``;
    ``u``, when given, is [1, B]."""
    return _row(device_replay_sample_many(state, 1, batch_size, beta, u, generator), 0)


def device_replay_restamp_last(
    state: DeviceReplayState,
    indices: torch.Tensor,     # int [K, B] in step order
    priorities: torch.Tensor,  # float32 [K, B]
    priority_exponent: float = 0.6,
) -> DeviceReplayState:
    """Batched restamp with sequential (last-wins) semantics: a slot drawn
    by several of the K batches ends with the latest step's priority.  A
    scatter with duplicate indices has no defined order on CUDA, so resolve
    duplicates first: stable-sort by slot (ties keep step order), keep each
    run's last element, and send the rest to a dummy slot that is dropped."""
    idx = indices.reshape(-1).long()
    mass = _mass(priorities.reshape(-1), priority_exponent)
    si, order = torch.sort(idx, stable=True)
    sm = mass[order]
    is_last = torch.ones_like(si, dtype=torch.bool)
    is_last[:-1] = si[1:] != si[:-1]
    C = state.capacity
    target = torch.where(is_last, si, torch.full_like(si, C))
    ext = torch.cat([state.mass, state.mass.new_zeros(1)])
    ext[target] = sm
    state.mass.copy_(ext[:C])
    return state


def device_replay_update_priorities(
    state: DeviceReplayState,
    indices: torch.Tensor,
    priorities: torch.Tensor,
    priority_exponent: float = 0.6,
) -> DeviceReplayState:
    """Restamp one batch's slots (a duplicate slot within the batch takes
    one of its values, unspecified which — as in the JAX scatter)."""
    state.mass[indices.long()] = _mass(priorities, priority_exponent)
    return state


def _stack_metrics(per_step: List[StepMetrics]) -> StepMetrics:
    return StepMetrics(*(
        torch.stack([getattr(m, f.name) for m in per_step])
        for f in dataclasses.fields(StepMetrics)
    ))


def fused_scan_body(
    train_step_fn,
    train_state,
    replay_state: DeviceReplayState,
    beta: float,
    *,
    steps_per_call: int,
    batch_size: int,
    priority_exponent: float,
    target_sync_freq: int | None,
    sample_ahead: bool,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sample_many_fn: Optional[Callable] = None,
):
    """K × [sample → train → restamp] + the hoisted target sync.

    Strict mode samples each step from live priorities (``u[k]`` is step k's
    row of uniforms); ``sample_ahead`` samples all K batches in one launch
    from call-entry priorities and restamps once, last-wins, after the loop.
    Target sync (``target_sync_freq`` not None): copy online → target iff
    the K steps crossed a multiple of the frequency (``copy_`` casts to the
    target's dtype).  Returns ``(train_state, replay_state, metrics)`` with
    metrics stacked [K, ...].  The loop never reads the device.

    ``sample_many_fn(state, K, B, beta, u=...)`` is the layout's sampler
    (default: this module's ``device_replay_sample_many``); the frame-dedup
    ring (``device_dedup.py``) passes its own, so both layouts share this
    one loop and one IS-weight law.  Restamps touch only ``.mass``, which
    every layout carries.
    """
    K, B = steps_per_call, batch_size
    step_before = train_state.step
    if sample_many_fn is None:
        sample_many_fn = device_replay_sample_many
    if u is None:
        u = torch.rand((K, B), generator=generator, device=replay_state.mass.device)
    per_step = []
    if sample_ahead:
        batches = sample_many_fn(replay_state, K, B, beta, u=u)
        for k in range(K):
            train_state, m = train_step_fn(train_state, _row(batches, k))
            per_step.append(m)
        metrics = _stack_metrics(per_step)
        device_replay_restamp_last(
            replay_state, batches.indices, metrics.priorities, priority_exponent
        )
    else:
        for k in range(K):
            batch = _row(sample_many_fn(replay_state, 1, B, beta, u=u[k:k + 1]), 0)
            train_state, m = train_step_fn(train_state, batch)
            device_replay_update_priorities(
                replay_state, batch.indices, m.priorities, priority_exponent
            )
            per_step.append(m)
        metrics = _stack_metrics(per_step)
    if target_sync_freq is not None and (
        train_state.step // target_sync_freq > step_before // target_sync_freq
    ):
        sync_target_(train_state)
    return train_state, replay_state, metrics


def build_fused_learn_step(
    train_step_fn,
    batch_size: int,
    steps_per_call: int = 1,
    priority_exponent: float = 0.6,
    target_sync_freq: int | None = 2500,
    include_ingest: bool = True,
    sample_ahead: bool = False,
) -> Callable:
    """[ingest chunk] → K × [sample → train → restamp] as one call.

    Returns ``fn(train_state, replay_state, chunk, chunk_priorities, beta,
    u=None, generator=None) -> (train_state, replay_state, metrics)``, or
    without the chunk arguments when ``include_ingest=False``.  Build
    ``train_step_fn`` with ``sync_in_step=False`` when ``target_sync_freq``
    is set here: the sync is hoisted to the end of the call.
    """
    knobs = dict(steps_per_call=steps_per_call, batch_size=batch_size,
                 priority_exponent=priority_exponent,
                 target_sync_freq=target_sync_freq, sample_ahead=sample_ahead)

    def fused_no_ingest(train_state, replay_state, beta, u=None, generator=None):
        return fused_scan_body(train_step_fn, train_state, replay_state, beta,
                               u=u, generator=generator, **knobs)

    if not include_ingest:
        return fused_no_ingest

    def fused(train_state, replay_state, chunk, chunk_priorities, beta,
              u=None, generator=None):
        device_replay_add(replay_state, chunk, chunk_priorities, priority_exponent)
        return fused_no_ingest(train_state, replay_state, beta, u, generator)

    return fused
