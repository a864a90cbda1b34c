"""Sharded device replay: one ring shard per data slot, fused K-step calls
with the gradient reduced over the slots inside every step.

Port of ``ape_x_dqn_tpu/replay/device_dp.py``.  JAX runs the K-step scan
under ``shard_map``, one program per device; the port's one controller runs
each slot's part of every step itself (``ShardBody``, a ``FusedBody`` per
slot) and reduces over the slots between them:

* the ring splits over the mesh's data slots: slot d owns ``capacity / n``
  slots on its device and ingests row block d of every chunk (contiguous,
  so each shard keeps a time-ordered FIFO and overwrite stays eviction);
* each step, every shard draws B / n stratified rows from its own ring with
  the sharded law of ``device.sample_slots`` — q_i = (m_i / M_s) / n,
  weights (N_global · q_i)^−β normalised by the max over every shard's
  batch (``normalize_weights_``);
* every slot takes the gradient of its rows' local-mean loss on its own
  replica; the gradients are averaged over the slots (``reduce_grads_``)
  and every replica steps its optimizer on that same mean, so the replicas
  stay bit-identical; each shard restamps only its own rows, the last-wins
  restamp per shard;
* the call's metrics are the slots' means (max |δ|: their max) and its
  priorities [K, B] the slots' rows in slot order.

Nothing asks whether two slots share a device: each slot's pieces run (or
replay, ``runtime/graphed_call.ShardedGraphedCall``) on its own device and
the reduce always runs.  Cursors and counts are per shard (``[n]`` in a
snapshot), host ints as in ``device.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import StepMetrics, reduce_slot_metrics, slot_mean
from ape_x_dqn_tpu_torch.replay.device import (
    FusedBody,
    _row,
    device_replay_add,
    device_replay_restamp_last,
    device_replay_sample_many,
    device_replay_update_priorities,
    init_device_replay,
)
from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch


@dataclasses.dataclass
class ShardedReplay:
    """A ring split over the data slots: ``shards[d]`` lives on slot d's
    device.  Either layout's state (double-store or dedup) per shard."""

    shards: list

    @property
    def n(self) -> int:
        return len(self.shards)

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.shards)

    @property
    def cursor(self) -> np.ndarray:
        return np.asarray([s.cursor for s in self.shards], np.int32)

    @property
    def count(self) -> np.ndarray:
        return np.asarray([s.count for s in self.shards], np.int32)

    def column(self, name: str) -> np.ndarray:
        """One column of every shard, concatenated in slot order (the JAX
        global array's layout), as host numpy."""
        return np.concatenate([getattr(s, name).to("cpu", copy=True).numpy()
                               for s in self.shards])

    def load_column_(self, name: str, value) -> None:
        """Copy a global column (slot-order concatenation) into the shards
        in place."""
        value = np.asarray(value)
        off = 0
        with torch.no_grad():
            for s in self.shards:
                t = getattr(s, name)
                t.copy_(torch.from_numpy(value[off:off + t.shape[0]]))
                off += t.shape[0]


def _divides(capacity: int, n: int, what: str = "replay capacity") -> None:
    if capacity % n:
        raise ValueError(f"{what} {capacity} must divide by the data-axis extent {n} "
                         "(per-device ring shards)")


def init_sharded_device_replay(capacity: int, obs_shape, mesh,
                               obs_dtype=torch.uint8) -> ShardedReplay:
    """The ring split over the mesh's data slots, each shard allocated on
    its slot's device."""
    devs = mesh.data_devices
    _divides(capacity, len(devs))
    return ShardedReplay([init_device_replay(capacity // len(devs), obs_shape, dev,
                                             obs_dtype) for dev in devs])


def _block(a, d: int, per: int, dev: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t[d * per:(d + 1) * per].to(dev)


def sharded_replay_add(state: ShardedReplay, chunk: NStepTransition, priorities,
                       priority_exponent: float = 0.6) -> ShardedReplay:
    """Ingest: row block d of M / n goes to shard d's ring (JAX :115).  The
    chunk length must divide by the shard count."""
    M = len(priorities)
    _divides(M, state.n, "chunk length")
    per = M // state.n
    for d, shard in enumerate(state.shards):
        dev = shard.mass.device
        device_replay_add(shard, chunk.map(lambda a: _block(a, d, per, dev)),
                          _block(priorities, d, per, dev), priority_exponent)
    return state


def _global_max(peaks: List[torch.Tensor]) -> torch.Tensor:
    dev = peaks[0].device
    return torch.stack([p.to(dev) for p in peaks]).amax(0)


class ShardBody(FusedBody):
    """Slot s's part of a sharded fused call: its replica, its ring shard,
    its static buffers.  The pieces a CUDA graph captures per slot are
    ``prologue`` (sample-ahead: this shard's K batches, raw weights),
    ``sample`` (strict: this step's batch, raw weights), ``grads`` (the
    local gradient, flattened into ``g``, and this slot's metrics row) and
    ``apply`` (the optimizer on the reduced gradient in ``reduced_flat``;
    strict: this shard's restamp; k += 1), and ``epilogue`` (sample-ahead:
    the last-wins restamp of this shard).  Between them the caller runs
    the cross-slot steps: ``normalize_weights_`` and ``reduce_grads_``."""

    def __init__(self, train_step_fn, train_state, replay_state, *, n_shards: int,
                 steps_per_call: int, batch_size: int, priority_exponent: float,
                 sample_ahead: bool, sample_many_fn: Optional[Callable] = None):
        super().__init__(None, train_state, replay_state, steps_per_call=steps_per_call,
                         batch_size=batch_size, priority_exponent=priority_exponent,
                         sample_ahead=sample_ahead, sample_many_fn=sample_many_fn)
        self.local_grads = train_step_fn.local_grads
        self.apply_grads = train_step_fn.apply_
        self.n_shards = n_shards
        self.size_global = torch.ones((), dtype=torch.int64, device=self.device)
        params = train_state.params
        dtypes = {v.dtype for v in params.values()}
        if len(dtypes) != 1:
            raise ValueError(f"the sharded step reduces one flat gradient; params hold {dtypes}")
        self.reduced_flat = torch.zeros(sum(v.numel() for v in params.values()),
                                        dtype=dtypes.pop(), device=self.device)
        views = self.reduced_flat.split([v.numel() for v in params.values()])
        self.reduced = {k: t.view(v.shape) for (k, v), t in zip(params.items(), views)}
        self.g: Optional[torch.Tensor] = None          # this step's local gradient, flat
        self.cur: Optional[PrioritizedBatch] = None    # strict: this step's batch

    def _law(self) -> dict:
        return dict(n_shards=self.n_shards, size_global=self.size_global, normalize=False)

    def prologue(self) -> None:
        if self.sample_ahead:
            self.batches = self.sample_many_fn(
                self.replay, self.steps_per_call, self.batch_size, self.beta,
                u=self.u, size=self.size, **self._law())

    def sample(self) -> None:
        self.cur = _row(self.sample_many_fn(
            self.replay, 1, self.batch_size, self.beta, u=self.u.index_select(0, self.k),
            size=self.size, **self._law()), 0)

    def batch(self) -> PrioritizedBatch:
        return _row(self.batches, self.k) if self.sample_ahead else self.cur

    def weights(self) -> torch.Tensor:
        """The raw weights the cross-slot max normalises, in place."""
        return self.batches.is_weights if self.sample_ahead else self.cur.is_weights

    def grads(self) -> None:
        batch = self.batch()
        g, m = self.local_grads(self.train_state, batch)
        self.g = torch.cat([v.reshape(-1) for v in g.values()])
        if not self.sample_ahead:
            self.indices.index_copy_(0, self.k, batch.indices[None])
        row = torch.cat([torch.stack([m.loss, m.mean_abs_td, m.max_abs_td, m.mean_q]),
                         m.priorities])
        self.metrics.index_copy_(0, self.k, row[None])

    def apply(self) -> None:
        self.apply_grads(self.train_state, self.reduced)
        if not self.sample_ahead:
            device_replay_update_priorities(self.replay, self.cur.indices,
                                            self.metrics.index_select(0, self.k)[0, 4:],
                                            self.priority_exponent)
        self.k.add_(1)

    def epilogue(self) -> None:
        if self.sample_ahead:
            device_replay_restamp_last(self.replay, self.batches.indices,
                                       self.metrics[:, 4:], self.priority_exponent)


class ShardedFusedBody:
    """One sharded fused K-step call: a ``ShardBody`` per data slot and the
    cross-slot steps between their pieces."""

    PIECES = ("prologue", "sample", "grads", "apply", "epilogue")

    def __init__(self, train_step_fn, train_states: list, replay: ShardedReplay, *,
                 steps_per_call: int, batch_size: int, priority_exponent: float,
                 sample_ahead: bool, sample_many_fn: Optional[Callable] = None):
        n = replay.n
        if len(train_states) != n:
            raise ValueError(f"{len(train_states)} replicas for {n} ring shards")
        if batch_size % n:
            raise ValueError(f"batch_size {batch_size} must divide by the data-axis extent {n}")
        self.n = n
        self.steps_per_call = steps_per_call
        self.sample_ahead = sample_ahead
        self.train_states = train_states
        self.replay = replay
        self.slots = [ShardBody(train_step_fn, st, sh, n_shards=n,
                                steps_per_call=steps_per_call, batch_size=batch_size // n,
                                priority_exponent=priority_exponent,
                                sample_ahead=sample_ahead, sample_many_fn=sample_many_fn)
                      for st, sh in zip(train_states, replay.shards)]

    def load(self, beta: float, u: Optional[torch.Tensor] = None,
             generators: Optional[list] = None) -> None:
        """One call's inputs: ``u`` [n, K, B / n] (shard s takes u[s]), or
        one [K, B / n] draw from each shard's generator."""
        size_global = sum(max(min(b.replay.count, b.replay.capacity), 1) for b in self.slots)
        for s, b in enumerate(self.slots):
            b.load(beta, None if u is None else u[s],
                   None if generators is None else generators[s])
            b.size_global.fill_(size_global)

    def normalize_weights_(self) -> None:
        """Divide every shard's raw weights by the max over all shards'
        batches (per batch row k in sample-ahead)."""
        ws = [b.weights() for b in self.slots]
        peaks = [w.amax(-1) for w in ws]
        gmax = _global_max(peaks)
        for w in ws:
            w.div_(gmax.to(w.device).unsqueeze(-1))

    def reduce_grads_(self) -> None:
        """The data axis's all-reduce: the slots' flat gradients summed in
        slot order on slot 0's device, divided by n, and copied into every
        slot's ``reduced_flat``."""
        acc = slot_mean([{"g": b.g} for b in self.slots])["g"]
        for b in self.slots:
            b.reduced_flat.copy_(acc)

    def read_metrics(self) -> StepMetrics:
        """The call's metrics [K, ...] over the slots: means (max |δ|: max)
        and the slots' priorities side by side, [K, B]."""
        return reduce_slot_metrics([b.read_metrics() for b in self.slots])

    def sampled_indices(self) -> torch.Tensor:
        """The last call's sampled shard-local slots, int32 [K, B]: shard s
        in columns [s·B/n, (s+1)·B/n), on slot 0's device."""
        dev = self.slots[0].device
        return torch.cat([b.sampled_indices().to(dev) for b in self.slots], 1)


def run_sharded(body: ShardedFusedBody, run_piece: Callable[[str], None],
                on_replay: Optional[Callable[[int], None]] = None, step: int = 0) -> None:
    """One call's pieces in order: ``run_piece(name)`` runs piece ``name``
    of every slot (eagerly, or as graph replays), and the cross-slot steps
    run between them.  ``on_replay`` at the boundaries ``run_eager`` ticks."""
    hook = on_replay or (lambda _step: None)
    hook(step)
    if body.sample_ahead:
        run_piece("prologue")
        body.normalize_weights_()
    for k in range(body.steps_per_call):
        hook(step + k)
        if not body.sample_ahead:
            run_piece("sample")
            body.normalize_weights_()
        run_piece("grads")
        body.reduce_grads_()
        run_piece("apply")
    hook(step + body.steps_per_call)
    if body.sample_ahead:
        run_piece("epilogue")
    hook(step + body.steps_per_call)


def run_sharded_eager(body: ShardedFusedBody, beta: float, u=None, generators=None,
                      on_replay=None, step: int = 0) -> StepMetrics:
    """The sharded call eagerly: the CPU's call, and the reference a
    graphed call is held against on a card."""
    body.load(beta, u, generators)

    def run_piece(name):
        for b in body.slots:
            getattr(b, name)()

    run_sharded(body, run_piece, on_replay, step)
    return body.read_metrics()


def build_sharded_fused_learn_step(
    train_step_fn,
    mesh,
    batch_size: int,
    steps_per_call: int = 1,
    priority_exponent: float = 0.6,
    target_sync_freq: Optional[int] = 2500,
    sample_ahead: bool = False,
    sample_many_fn: Optional[Callable] = None,
) -> Callable:
    """The sharded twin of ``device.build_fused_learn_step`` (ingest
    excluded; the runtime ingests through ``sharded_replay_add``).

    ``train_step_fn`` is a ``build_train_step(..., sync_in_step=False)``
    step, whose ``local_grads`` and ``apply_`` halves each slot runs with
    the reduce between them; ``train_states`` are the state replicated
    over the mesh (``place_state(...).rows``), so the mesh's model axis
    must be 1.  ``batch_size`` is the GLOBAL batch, each shard drawing
    B / n rows.  Returns ``fn(train_states, replay, beta,
    u=None, generators=None) -> (train_states, replay, metrics)`` with
    metrics [K, ...] and priorities [K, B]: a ``ShardedGraphedCall``
    (eager on the CPU, per-slot CUDA-graph replays on a card)."""
    from ape_x_dqn_tpu_torch.runtime.graphed_call import ShardedGraphedCall

    n = len(mesh.data_devices)
    if mesh.shape["model"] != 1:
        raise ValueError(f"the sharded fused call splits the data axis only; "
                         f"model_parallel={mesh.shape['model']} must be 1")
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} must divide by the data-axis extent {n}")
    return ShardedGraphedCall(train_step_fn, steps_per_call=steps_per_call,
                              batch_size=batch_size, priority_exponent=priority_exponent,
                              target_sync_freq=target_sync_freq, sample_ahead=sample_ahead,
                              sample_many_fn=sample_many_fn or device_replay_sample_many)


def shard_generators(seed: int, devices) -> list:
    """One sampling generator per shard, on its device: the analogue of
    JAX's ``fold_in(rng, axis_index)`` — shard s's stream is seeded from
    the learner's salted seed and s."""
    gens = []
    for s, dev in enumerate(devices):
        g = torch.Generator(device=dev)
        g.manual_seed(((int(seed) ^ 0x5EED) * 1_000_003 + s) & (2**63 - 1))
        gens.append(g)
    return gens


class GeneratorGroup:
    """The shards' generators as one sampling stream for the checkpoint's
    state leg: ``get_state`` concatenates their states, ``set_state``
    splits one back (a state of another shard count raises RuntimeError,
    as a state of another device type does)."""

    def __init__(self, generators: list):
        self.generators = generators
        self.device = generators[0].device

    def get_state(self) -> torch.Tensor:
        return torch.cat([g.get_state() for g in self.generators])

    def set_state(self, state: torch.Tensor) -> None:
        parts = torch.as_tensor(state).chunk(len(self.generators))
        if len(parts) != len(self.generators) or \
                any(p.numel() != g.get_state().numel() for p, g in zip(parts, self.generators)):
            raise RuntimeError(f"a sampling state of {torch.as_tensor(state).numel()} bytes "
                             f"is not {len(self.generators)} shards' states")
        for g, p in zip(self.generators, parts):
            g.set_state(p.clone())
