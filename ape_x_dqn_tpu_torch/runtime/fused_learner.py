"""Host driver for the device-resident fused learner.

Port of ``ape_x_dqn_tpu/runtime/fused_learner.FusedDeviceLearner``, with
its mesh branch (:107-150 of the JAX module).  The replay ring and the
train state live on the device; each ``train()`` call runs K ×
[prioritized sample → double-Q train → priority restamp] through
``runtime/graphed_call.GraphedCall``: CUDA-graph replays on a card
(captured when the learner is built, before any actor thread starts), the
same body eagerly on the CPU.  Neither synchronises with the device.

Thread discipline: ``add_chunk`` (actor threads) only appends numpy to a
host staging list under a lock; ``prepare_staged`` (any thread, e.g. the
overlapped pipeline's stager thread) carves staged rows into fixed
``ingest_block`` blocks; device work — ``add_block`` and ``train`` —
happens on the one thread that calls ``train()``.  ``add_block`` copies a
block through pinned staging on a copy stream (``runtime/infeed.
HostToDevice``): the learner's stream waits for the copy, the host does not.

Sampling stream: the learner owns a ``torch.Generator`` on the device,
seeded from the train state's seed with the JAX learner's salt (0x5EED),
or set to the state's ``rng_state`` when a checkpoint restored one;
``train(beta, u=...)`` takes the K×B uniforms instead, which is how tests
feed it JAX's draws.

With a ``mesh`` (``parallel/mesh.py``) the ring shards over its data slots
(``replay/device_dp.py``): one train-state replica and one ring shard per
slot, each block's rows split contiguously over the shards, the call a
``ShardedGraphedCall`` whose steps reduce the gradient over the slots; each
shard samples from its own generator (``shard_generators``; one state in
a checkpoint, ``GeneratorGroup``), and ``u`` is [n, K, B / n].  ``state``
and ``params_for_publish`` are slot 0's replica (every replica is the
same).  Ingest folding is single-device only, as in JAX.

Snapshots (JAX :319-393): ``state_dict`` copies the ring to host numpy in
the JAX package's keys and dtypes, with the staged and prepared rows as
``staged_*``; ``load_state_dict`` copies a snapshot into the existing
device tensors in place, so the graph runner keeps its captures.  There is
no delta protocol, as in JAX: ``utils/checkpoint_inc`` writes full bases.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
from ape_x_dqn_tpu_torch.parallel.mesh import place_state, shard_train_state
from ape_x_dqn_tpu_torch.replay.device import device_replay_add, init_device_replay
from ape_x_dqn_tpu_torch.replay.device_dp import (
    GeneratorGroup,
    build_sharded_fused_learn_step,
    init_sharded_device_replay,
    shard_generators,
)
from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall
from ape_x_dqn_tpu_torch.runtime.infeed import HostToDevice
from ape_x_dqn_tpu_torch.types import NStepTransition, TrainState
from ape_x_dqn_tpu_torch.utils.checkpoint import adopt_rng_state


class FusedDeviceLearner:
    """Owns the device replay + train state; drives fused K-step calls."""

    def __init__(
        self,
        network,
        optimizer,
        state: TrainState,
        obs_shape,
        capacity: int,
        batch_size: int = 32,
        steps_per_call: int = 128,
        ingest_block: int = 256,
        priority_exponent: float = 0.6,
        target_sync_freq: int = 2500,
        loss_kind: str = "huber",
        sample_ahead: bool = False,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        self._capacity = int(capacity)
        self.steps_per_call = int(steps_per_call)
        self._ingest_block = int(ingest_block)
        self._priority_exponent = float(priority_exponent)
        self._mesh = mesh
        knobs = dict(batch_size=batch_size, steps_per_call=self.steps_per_call,
                     priority_exponent=priority_exponent,
                     target_sync_freq=target_sync_freq, sample_ahead=sample_ahead)
        if mesh is None:
            self.device = torch.device(device)
            self._add_granularity = 1
            self._states = [state]
            self._replay = init_device_replay(capacity, obs_shape, self.device)
            step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                                       sync_in_step=False)
            self._call = GraphedCall(step_fn, **knobs)
            self._call.bind(state, self._replay)   # a card: warm up and capture now
            self._h2d = [HostToDevice(self.device)]
            self._generator = sampling_generator(state, self.device)
        else:
            devs = mesh.data_devices
            n = len(devs)
            if self._ingest_block % n:
                raise ValueError(f"ingest_block {ingest_block} must divide by the "
                                 f"data-axis extent {n}")
            self.device = devs[0]
            # Every ingest must split evenly across the shards.
            self._add_granularity = n
            # The state replicated over the mesh, one replica per data slot.
            self._states = place_state(state, shard_train_state(state, mesh)).rows
            self._replay = init_sharded_device_replay(capacity, obs_shape, mesh)
            step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                                       sync_in_step=False)
            self._call = build_sharded_fused_learn_step(step_fn, mesh, **knobs)
            self._call.bind(self._states, self._replay)
            self._h2d = [HostToDevice(dev) for dev in devs]
            self._generator = shard_generator_group(state, devs)
        self._state = self._states[0]
        self._lock = threading.Lock()
        self._staged: list = []
        self._staged_rows = 0
        self._prepared: list = []
        self._prepared_rows = 0
        self._size = 0          # host count of transitions ingested

    # ---------------------------------------------------------------- sinks

    def add_chunk(self, priorities: np.ndarray, transitions: NStepTransition):
        """Actor-thread sink: stage a numpy chunk (no device work here)."""
        with self._lock:
            self._staged.append((np.asarray(priorities, np.float32), transitions))
            self._staged_rows += len(priorities)

    @property
    def size(self) -> int:
        """Transitions visible to sampling (capacity-clamped)."""
        return min(self._size, self._capacity)

    @property
    def staged_rows(self) -> int:
        with self._lock:
            return self._staged_rows + self._prepared_rows

    @property
    def state(self) -> TrainState:
        return self._state

    @property
    def replay(self):
        return self._replay

    @property
    def step(self) -> int:
        return self._state.step

    def params_for_publish(self):
        return self._state.params

    @property
    def graphed_call(self) -> GraphedCall:
        return self._call

    @property
    def generator(self) -> torch.Generator:
        """The sampling stream (saved with the state leg)."""
        return self._generator

    @property
    def supports_ingest_fold(self) -> bool:
        """A full ``ingest_block`` can ride with the fused call
        (``train_with_ingest``): single-device only, as in JAX."""
        return self._mesh is None

    # ------------------------------------------------------------- learner

    def prepare_staged(self, drain: bool = False) -> int:
        """Carve staged rows into fixed ``ingest_block`` blocks on the
        prepared queue (host CPU only, any thread).  ``drain=True`` also
        carves the partial tail into power-of-2 sub-blocks, so nothing is
        padded.  Returns rows prepared."""
        with self._lock:
            staged, self._staged = self._staged, []
            self._staged_rows = 0
        if not staged:
            return 0
        cat = _concat_chunks([t for _, t in staged])
        prio = np.concatenate([p for p, _ in staged])
        m = self._ingest_block
        blocks: list = []
        off = 0
        for _ in range(len(prio) // m):
            sl = slice(off, off + m)
            blocks.append((prio[sl], cat.map(lambda a: a[sl])))
            off += m
        rem = len(prio) - off
        if rem and drain:
            # The tail in g·2^k sub-blocks, g the shard count: every add
            # splits evenly over the shards.
            g = self._add_granularity
            while rem >= g:
                sub = g << ((rem // g).bit_length() - 1)  # largest g·2^k <= rem
                sl = slice(off, off + sub)
                blocks.append((prio[sl], cat.map(lambda a: a[sl])))
                off += sub
                rem -= sub
        with self._lock:
            self._prepared.extend(blocks)
            self._prepared_rows += off
            if rem:
                # The partial tail (or a remainder under the shard count)
                # goes back to the front of staging.
                tail = slice(len(prio) - rem, None)
                self._staged.insert(0, (prio[tail], cat.map(lambda a: a[tail])))
                self._staged_rows += rem
        return off

    def pop_prepared(self) -> list:
        """Take every prepared block, in ring order."""
        with self._lock:
            blocks, self._prepared = self._prepared, []
            self._prepared_rows = 0
        return blocks

    def add_block(self, priorities: np.ndarray, transitions) -> int:
        """Move one prepared block to the device ring (learner thread); over
        a mesh, row block d of the block to shard d."""
        rows = len(priorities)
        per = rows // len(self._h2d)
        shards = self._replay.shards if self._mesh is not None else [self._replay]
        for d, (h2d, shard) in enumerate(zip(self._h2d, shards)):
            sl = slice(d * per, (d + 1) * per)
            *fields, prio = h2d([*(np.asarray(getattr(transitions, f))[sl] for f in _FIELDS),
                                 np.asarray(priorities, np.float32)[sl]])
            device_replay_add(shard, NStepTransition(*fields), prio,
                              self._priority_exponent)
        self._size += rows
        return rows

    def ingest_staged(self, drain: bool = False) -> int:
        """Assemble and add staged rows inline (learner thread).  Returns
        rows ingested."""
        self.prepare_staged(drain=drain)
        return sum(self.add_block(p, t) for p, t in self.pop_prepared())

    def train(self, beta: float, u: Optional[torch.Tensor] = None,
              on_replay: Optional[Callable[[int], None]] = None):
        """One fused call: K steps of sample/train/restamp.  Returns the
        call's metrics [K, ...], still on the device (read them lazily).
        ``on_replay(step)`` runs between the call's graph replays
        (``GraphedCall``)."""
        if self._mesh is not None:
            _, _, metrics = self._call(self._states, self._replay, beta, u=u,
                                       generators=self._generator.generators,
                                       on_replay=on_replay)
            return metrics
        self._state, self._replay, metrics = self._call(
            self._state, self._replay, beta, u=u, generator=self._generator,
            on_replay=on_replay)
        return metrics

    def train_with_ingest(self, beta: float, priorities: np.ndarray,
                          transitions, u: Optional[torch.Tensor] = None,
                          on_replay: Optional[Callable[[int], None]] = None):
        """Ingest one full ``ingest_block``, then the K-step call, queued
        back to back with no host sync between them (the JAX learner's
        single-dispatch fold); the same result as ``add_block`` followed by
        ``train``."""
        if len(priorities) != self._ingest_block:
            raise ValueError(
                f"train_with_ingest requires a full ingest_block "
                f"({self._ingest_block} rows), got {len(priorities)}"
            )
        if self._mesh is not None:
            raise RuntimeError("ingest folding is single-device only")
        self.add_block(priorities, transitions)
        return self.train(beta, u, on_replay)


    # ------------------------------------------------------------ snapshots

    def state_dict(self) -> dict:
        """The ring as host numpy (the replay leg of ``utils/checkpoint``),
        plus staged rows not yet in the ring as ``staged_*`` arrays:
        prepared blocks first, in ring order.  The copies wait for the
        learner's queued work (a full synchronous snapshot)."""
        r = self._replay
        if self._mesh is not None:
            out = {f: r.column(f) for f in _RING_FIELDS}
        else:
            # A copy on the CPU too: the snapshot may be written on another
            # thread while the ring goes on changing.
            out = {f: getattr(r, f).to("cpu", copy=True).numpy() for f in _RING_FIELDS}
        out["cursor"] = np.asarray(r.cursor, np.int32)
        out["count"] = np.asarray(r.count, np.int32)
        with self._lock:
            staged = list(self._prepared) + list(self._staged)
        if staged:
            cat = _concat_chunks([t for _, t in staged])
            out["staged_prio"] = np.concatenate([p for p, _ in staged])
            for f in _FIELDS:
                out[f"staged_{f}"] = np.asarray(getattr(cat, f))
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore the ring from a snapshot of the same capacity and
        observation shape (a resize is a config error), copying into the
        existing device tensors.  Staged rows re-enter staging."""
        shards = self._replay.shards if self._mesh is not None else [self._replay]
        want = (sum(s.capacity for s in shards), *shards[0].obs.shape[1:])
        got = tuple(np.shape(state["obs"]))
        if want != got:
            raise ValueError(f"replay snapshot shape {got} != configured ring {want}")
        want_layout = np.shape(np.asarray(self._replay.cursor))
        if np.shape(state["cursor"]) != want_layout:
            raise ValueError(f"replay snapshot shard layout {np.shape(state['cursor'])} "
                             f"!= configured {want_layout} — the data_parallel extent "
                             "must match the snapshot's")
        r = self._replay
        if self._mesh is not None:
            for f in _RING_FIELDS:
                r.load_column_(f, state[f])
            for shard, c, k in zip(r.shards, np.asarray(state["cursor"]),
                                   np.asarray(state["count"])):
                shard.cursor, shard.count = int(c), int(k)
        else:
            with torch.no_grad():
                for f in _RING_FIELDS:
                    getattr(r, f).copy_(torch.from_numpy(np.asarray(state[f])))
            r.cursor = int(state["cursor"])
            r.count = int(np.sum(state["count"]))
        self._size = int(np.sum(state["count"]))
        if "staged_prio" in state and len(state["staged_prio"]):
            self.add_chunk(state["staged_prio"], NStepTransition(
                *(np.asarray(state[f"staged_{f}"]) for f in _FIELDS)))


def shard_generator_group(state: TrainState, devices) -> GeneratorGroup:
    """The shards' sampling generators (``shard_generators``), set to the
    state's ``rng_state`` when a checkpoint restored one."""
    group = GeneratorGroup(shard_generators(state.seed, devices))
    if state.rng_state is not None:
        adopt_rng_state(group, state.rng_state)
    return group


def sampling_generator(state: TrainState, device: torch.device) -> torch.Generator:
    """The fused learners' sampling stream: seeded from ``state.seed`` with
    the JAX learner's salt, then set to ``state.rng_state`` when a
    checkpoint restored one."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state.seed) ^ 0x5EED) & (2**63 - 1))
    if state.rng_state is not None:
        adopt_rng_state(gen, state.rng_state)
    return gen


_FIELDS = ("obs", "action", "reward", "discount", "next_obs")
_RING_FIELDS = ("obs", "next_obs", "action", "reward", "discount", "mass")


def _concat_chunks(chunks) -> NStepTransition:
    if len(chunks) == 1:
        return chunks[0].map(np.asarray)
    return NStepTransition(*(
        np.concatenate([np.asarray(getattr(c, f)) for c in chunks])
        for f in _FIELDS
    ))
