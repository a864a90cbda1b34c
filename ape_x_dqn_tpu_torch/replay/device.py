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
from typing import Callable, Optional

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
    beta,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    size: Optional[torch.Tensor] = None,
    n_shards: int = 1,
    size_global=None,
    normalize: bool = True,
):
    """The sampling law every device layout shares: K stratified batches of
    slots from ``mass`` in one sampler launch, and their β-annealed IS
    weights normalised by each batch's max.  Returns (slots int64 [K*B],
    weights float32 [K, B]).

    ``beta`` is a float or a float32 device scalar.  ``size``, an int64
    device scalar, stands in for the host's max(min(count, C), 1) when
    given: a captured call reads both from buffers written before each
    replay instead of baking them in.

    The sharded law (JAX ``device.py:120-150``, ``axis_name`` mode): this
    ring is one of ``n_shards`` shards that each draw B rows, so row i is
    drawn with q_i = (m_i / M_s) / n and its weight is
    (``size_global`` · q_i)^−β, ``size_global`` being the shards' summed
    sizes (an int or a device scalar).  The max that normalises the batch
    is then the max over every shard's batch: ``normalize=False`` returns
    the raw weights for the caller to divide by it
    (``replay/device_dp.normalize_weights_``)."""
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
    if size is None:
        size = max(min(count, mass.shape[0]), 1)
    idx = torch.clamp(idx.long(), max=size - 1)  # zero-mass guard
    probs = mass[idx] / torch.clamp(total, min=1e-12)
    if size_global is None:
        size_global = size
    q = size_global * probs
    if n_shards != 1:
        q = q / n_shards
    weights = torch.pow(torch.clamp(q, min=1e-12), -beta).reshape(K, B)
    if not normalize:
        return idx, weights
    return idx, weights / weights.max(dim=1, keepdim=True).values


def device_replay_sample_many(
    state: DeviceReplayState,
    num_batches: int,
    batch_size: int,
    beta=0.4,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    size: Optional[torch.Tensor] = None,
    **law,
) -> PrioritizedBatch:
    """K stratified batches from the current priorities in one sampler
    launch plus one row gather; leaves get leading [K, B].  ``beta``,
    ``size`` and the sharded law's ``law`` keywords as in
    ``sample_slots``."""
    idx, weights = sample_slots(state.mass, state.count, num_batches, batch_size,
                                beta, u, generator, size, **law)
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


def _row(batch: PrioritizedBatch, k) -> PrioritizedBatch:
    """Row ``k`` of a [K, B] batch; ``k`` is an int or an int64 device
    tensor [1] (a gather, so a captured step reads the row its replay is
    at)."""
    if isinstance(k, torch.Tensor):
        def take(a):
            return a.index_select(0, k)[0]
    else:
        def take(a):
            return a[k]
    return PrioritizedBatch(
        transition=batch.transition.map(take),
        indices=take(batch.indices),
        is_weights=take(batch.is_weights),
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


# Columns of ``FusedBody.metrics`` before the B priorities.
_SCALAR_METRICS = ("loss", "mean_abs_td", "max_abs_td", "mean_q")


class FusedBody:
    """One fused K-step call over a device ring, cut into the pieces that a
    CUDA graph can capture: ``prologue`` (sample-ahead: sample and gather
    all K batches), ``step`` (one [sample →] train → restamp step) and
    ``epilogue`` (sample-ahead: the last-wins restamp).  The pieces read no
    host value that changes between calls.  What does change lives in
    static device buffers that ``load`` writes before each call: the
    uniforms ``u`` [K, B], β, the sampling size max(min(count, C), 1) and
    the step index ``k``, which each ``step`` advances on the device.  Each
    step writes its metrics into row k of ``metrics`` [K, 4 + B] (loss,
    mean |δ|, max |δ|, mean Q, then the B priorities) and, in strict mode,
    its sampled slots into row k of ``indices`` [K, B] (sample-ahead keeps
    them in ``batches.indices``).

    ``run_eager`` runs the pieces in order; ``runtime/graphed_call.py``
    replays them as CUDA graphs.  Both leave ``train_state.step`` and the
    target sync to ``finish_call``, on the host.

    ``sample_many_fn(state, K, B, beta, u=..., size=...)`` is the layout's
    sampler (default: ``device_replay_sample_many``); the frame-dedup ring
    passes its own, so both layouts share this one body and one IS-weight
    law.  Restamps touch only ``.mass``, which every layout carries.
    """

    def __init__(self, update_fn, train_state, replay_state, *, steps_per_call: int,
                 batch_size: int, priority_exponent: float, sample_ahead: bool,
                 sample_many_fn: Optional[Callable] = None):
        K, B = steps_per_call, batch_size
        dev = replay_state.mass.device
        self.update_fn = update_fn
        self.train_state = train_state
        self.replay = replay_state
        self.steps_per_call = K
        self.batch_size = B
        self.priority_exponent = priority_exponent
        self.sample_ahead = sample_ahead
        self.sample_many_fn = sample_many_fn or device_replay_sample_many
        self.device = dev
        self.u = torch.zeros((K, B), dtype=torch.float32, device=dev)
        self.beta = torch.zeros((), dtype=torch.float32, device=dev)
        self.size = torch.ones((), dtype=torch.int64, device=dev)
        self.k = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.metrics = torch.zeros((K, len(_SCALAR_METRICS) + B), dtype=torch.float32,
                                   device=dev)
        self.indices = torch.zeros((K, B), dtype=torch.int32, device=dev)
        self.batches: Optional[PrioritizedBatch] = None   # sample-ahead's [K, B]

    def load(self, beta: float, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> None:
        """Write one call's inputs into the static buffers.  ``u`` absent:
        one [K, B] draw from ``generator``."""
        self.beta.fill_(beta)
        self.size.fill_(max(min(self.replay.count, self.replay.capacity), 1))
        self.k.zero_()
        if u is None:
            torch.rand(self.u.shape, generator=generator, device=self.device, out=self.u)
        else:
            self.u.copy_(u)

    def prologue(self) -> None:
        if self.sample_ahead:
            self.batches = self.sample_many_fn(
                self.replay, self.steps_per_call, self.batch_size, self.beta,
                u=self.u, size=self.size)

    def step(self) -> None:
        k = self.k
        if self.sample_ahead:
            batch = _row(self.batches, k)
        else:
            batch = _row(self.sample_many_fn(self.replay, 1, self.batch_size, self.beta,
                                             u=self.u.index_select(0, k), size=self.size), 0)
        m = self.update_fn(self.train_state, batch)
        if not self.sample_ahead:
            device_replay_update_priorities(self.replay, batch.indices, m.priorities,
                                            self.priority_exponent)
            self.indices.index_copy_(0, k, batch.indices[None])
        row = torch.cat([torch.stack([getattr(m, f) for f in _SCALAR_METRICS]),
                         m.priorities])
        self.metrics.index_copy_(0, k, row[None])
        k.add_(1)

    def epilogue(self) -> None:
        if self.sample_ahead:
            device_replay_restamp_last(self.replay, self.batches.indices,
                                       self.metrics[:, len(_SCALAR_METRICS):],
                                       self.priority_exponent)

    def sampled_indices(self) -> torch.Tensor:
        """The last call's sampled slots, int32 [K, B] in step order."""
        return (self.batches.indices if self.sample_ahead else self.indices).clone()

    def read_metrics(self) -> StepMetrics:
        """The call's metrics [K, ...], copied out of the static buffer (a
        later call overwrites it while these may still be unread)."""
        m = self.metrics.clone()
        n = len(_SCALAR_METRICS)
        return StepMetrics(priorities=m[:, n:],
                           **{f: m[:, i] for i, f in enumerate(_SCALAR_METRICS)})


def run_eager(body: FusedBody, beta: float, u: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              on_replay: Optional[Callable[[int], None]] = None,
              step: int = 0) -> StepMetrics:
    """The body's pieces in order, step by step: the call on the CPU, and
    the reference a graphed call is held against on the card.
    ``on_replay``, where given, is called before each piece and after the
    last with the step reached (``step`` plus the steps run), as the graph
    runner calls it between replays."""
    hook = on_replay or (lambda _step: None)
    body.load(beta, u, generator)
    hook(step)
    body.prologue()
    for k in range(body.steps_per_call):
        hook(step + k)
        body.step()
    hook(step + body.steps_per_call)
    body.epilogue()
    hook(step + body.steps_per_call)
    return body.read_metrics()


def finish_call(train_state, steps: int, target_sync_freq: Optional[int]) -> None:
    """The host's part of a call, after its device work is queued: advance
    ``step`` by the call's K and copy online → target iff the K steps
    crossed a multiple of ``target_sync_freq`` (None: never; ``copy_``
    casts to the target's dtype)."""
    before = train_state.step
    train_state.step += steps
    if target_sync_freq is not None and (
        train_state.step // target_sync_freq > before // target_sync_freq
    ):
        sync_target_(train_state)


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
    """K × [sample → train → restamp] + the hoisted target sync, eagerly.

    Strict mode samples each step from live priorities (``u[k]`` is step k's
    row of uniforms); ``sample_ahead`` samples all K batches in one launch
    from call-entry priorities and restamps once, last-wins, after the loop.
    Returns ``(train_state, replay_state, metrics)`` with metrics [K, ...].
    The loop never reads the device.  ``train_step_fn`` is a
    ``build_train_step`` step; its ``update`` is what runs K times.

    This is ``FusedBody`` run once by ``run_eager``: the CPU's call, and the
    eager reference on a card.  The learners go through
    ``runtime/graphed_call.GraphedCall``, which replays the same body as
    CUDA graphs on a card.
    """
    body = FusedBody(train_step_fn.update, train_state, replay_state,
                     steps_per_call=steps_per_call, batch_size=batch_size,
                     priority_exponent=priority_exponent, sample_ahead=sample_ahead,
                     sample_many_fn=sample_many_fn)
    metrics = run_eager(body, beta, u, generator)
    finish_call(train_state, steps_per_call, target_sync_freq)
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
    without the chunk arguments when ``include_ingest=False``.  The call is
    a ``GraphedCall``: eager on the CPU, CUDA-graph replays on a card.
    Build ``train_step_fn`` with ``sync_in_step=False`` when
    ``target_sync_freq`` is set here: the sync is hoisted to the end of the
    call.
    """
    from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall

    fused_no_ingest = GraphedCall(
        train_step_fn, steps_per_call=steps_per_call, batch_size=batch_size,
        priority_exponent=priority_exponent, target_sync_freq=target_sync_freq,
        sample_ahead=sample_ahead)
    if not include_ingest:
        return fused_no_ingest

    def fused(train_state, replay_state, chunk, chunk_priorities, beta,
              u=None, generator=None):
        device_replay_add(replay_state, chunk, chunk_priorities, priority_exponent)
        return fused_no_ingest(train_state, replay_state, beta, u, generator)

    return fused
