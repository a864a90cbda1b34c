"""Host side of the frame-dedup device replay.

Port of ``ape_x_dqn_tpu/runtime/fused_dedup.py``: the dedup twin of ``runtime/fused_learner.FusedDeviceLearner`` with the same
interface (``add_chunk`` / ``prepare_staged`` / ``pop_prepared`` /
``add_block`` / ``ingest_staged`` / ``train`` / ``size`` /
``staged_rows`` / ``params_for_publish``), so the async pipeline drives
either without knowing which.

Staging is two streams instead of one.  Actors ship ``DedupChunk``s
(frames + refs); ``DedupStager`` resolves the refs to ABSOLUTE int64 frame
sequence numbers (``replay/dedup.CarryResolver``; they are reduced mod the
ring's Q only when a block ships) and carves fixed-size FRAME blocks ahead
of the TRANSITION blocks that reference them: a transition block becomes
eligible only when every frame it references has been carved
(``max_ref < shipped_f``).  Thread discipline matches the double-store
learner: actor threads only stage; device work happens on the one thread
that calls ``train()``, which runs the fused call as CUDA-graph replays on
a card (``runtime/graphed_call.GraphedCall``, captured when the learner is
built), and ``add_block`` copies through pinned staging on a copy stream
(``runtime/infeed.HostToDevice``), so ingest never synchronises the host.

With a ``mesh`` the ring shards over the mesh's data slots
(``replay/device_dedup_dp.py``, JAX :331-370): the stager pins each source
to a shard round-robin and resolves its carries per shard, every block is
[n, block] with row d for shard d, and the call is the sharded body of
``replay/device_dp.py`` with one replica per slot.

Snapshots (JAX :191-257, :538-761) keep the JAX package's keys (``n_shards``,
``s{i}_*`` per shard, ``shard_of_*``, ``rr``; int64 seqs not yet reduced mod
Q, as in JAX; the ring's columns in the global layout, shards concatenated,
and ``[n]`` counters over a mesh), so a snapshot or chain of either
package resumes in the other.  ``state_dict`` / ``load_state_dict`` are full (the
load copies into the existing device tensors, so the graph runner keeps
its captures).  ``delta_state_dict`` is the incremental chain's delta: the
transition and frame spans written since the last mark, gathered on the
learner's stream into fresh tensors (a later call's in-place writes cannot
reach them) and returned with a ``ready`` event; ``utils/checkpoint_inc``'s
writer thread waits on it and copies them to the host, so the learner
thread never waits for the device.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
from ape_x_dqn_tpu_torch.parallel.mesh import place_state, shard_train_state
from ape_x_dqn_tpu_torch.replay.dedup import CarryResolver
from ape_x_dqn_tpu_torch.replay.device_dedup import (
    COUNT_CAP,
    dedup_sample_many,
    init_dedup_device_replay,
)
from ape_x_dqn_tpu_torch.replay.device_dedup_dp import (
    build_sharded_dedup_fused_learn_step,
    init_sharded_dedup_replay,
    sharded_dedup_add_frames,
    sharded_dedup_add_transitions,
)
from ape_x_dqn_tpu_torch.replay.device_dp import ShardedReplay
from ape_x_dqn_tpu_torch.runtime.fused_learner import sampling_generator, shard_generator_group
from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall
from ape_x_dqn_tpu_torch.runtime.infeed import HostToDevice
from ape_x_dqn_tpu_torch.types import DedupChunk, TrainState
from ape_x_dqn_tpu_torch.utils.profiling import current_timer

_TXN_FIELDS = ("obs_seq", "next_seq", "action", "reward", "discount", "prio")


class _ShardStage:
    """One shard's staged streams: frames and ref-resolved transitions."""

    def __init__(self):
        self.fbuf: list = []     # frame arrays, stage order
        self.f_rows = 0          # staged frame rows not yet carved
        self.fseq = 0            # next absolute frame seq to assign
        self.shipped_f = 0       # frames carved into blocks
        self.tbuf: list = []     # transition chunks: arrays + max_ref
        self.t_rows = 0

    def take_frames(self, block: int) -> np.ndarray:
        rows, need = [], block
        while need:
            head = self.fbuf[0]
            if head.shape[0] <= need:
                rows.append(head)
                need -= head.shape[0]
                self.fbuf.pop(0)
            else:
                rows.append(head[:need])
                self.fbuf[0] = head[need:]
                need = 0
        self.f_rows -= block
        self.shipped_f += block
        return np.concatenate(rows) if len(rows) > 1 else rows[0]

    def eligible_rows(self) -> int:
        rows = 0
        for c in self.tbuf:
            if c["max_ref"] >= self.shipped_f:
                break
            rows += len(c["prio"])
        return rows

    def take_txns(self, block: int) -> dict:
        need = block
        acc = {f: [] for f in _TXN_FIELDS}
        while need:
            head = self.tbuf[0]
            k = len(head["prio"])
            if k <= need:
                for f in _TXN_FIELDS:
                    acc[f].append(head[f])
                need -= k
                self.tbuf.pop(0)
            else:
                for f in _TXN_FIELDS:
                    acc[f].append(head[f][:need])
                    head[f] = head[f][need:]
                need = 0
        self.t_rows -= block
        return {f: np.concatenate(v) if len(v) > 1 else v[0] for f, v in acc.items()}


def _stack(parts: list) -> np.ndarray:
    """The shards' blocks as one [n, ...] array; a lone block gains its
    leading axis as a view."""
    return parts[0][None] if len(parts) == 1 else np.stack(parts)


class DedupStager:
    """Ref resolution + per-shard block scheduling (host side, numpy).

    Each new SOURCE is pinned to a shard round-robin (a transition must live
    on the shard that holds its frames, and carry refs resolve against the
    same source's previous chunk), and each shard is its own frame sequence
    space with its own ``CarryResolver``: per-source (chunk_seq, base, U)
    continuity records; a gap drops only the carried rows
    (``dropped_carry``).  Blocks are [n, block]: one block per shard, so a
    block is available when every shard has one (JAX :46-100)."""

    def __init__(self, n_shards: int = 1):
        self.n = int(n_shards)
        self.shards = [_ShardStage() for _ in range(self.n)]
        self.resolvers = [CarryResolver() for _ in range(self.n)]
        self.shard_of: dict = {}   # source -> pinned shard
        self.rr = 0
        self.rows_in = 0           # transitions ever accepted

    @property
    def dropped_carry(self) -> int:
        return sum(r.dropped_carry for r in self.resolvers)

    @property
    def sources(self) -> dict:
        """source -> (chunk_seq, base, U) over every shard."""
        out = {}
        for i, r in enumerate(self.resolvers):
            for src, rec in r.sources.items():
                if self.shard_of.get(src) == i:
                    out[src] = rec
        return out

    @property
    def staged_rows(self) -> int:
        return sum(s.t_rows for s in self.shards)

    @property
    def fseq(self) -> int:
        """Frames ever staged, over every shard."""
        return sum(s.fseq for s in self.shards)

    @property
    def shipped_f(self) -> int:
        """Frames carved into blocks, over every shard."""
        return sum(s.shipped_f for s in self.shards)

    def add_chunk(self, priorities: np.ndarray, chunk: DedupChunk) -> int:
        """Stage one chunk on its source's shard; returns the transition
        rows accepted."""
        shard_i = self.shard_of.get(chunk.source)
        fresh = shard_i is None
        if fresh:
            shard_i = self.rr % self.n
            self.rr += 1
            self.shard_of[chunk.source] = shard_i
        st = self.shards[shard_i]
        base = st.fseq
        obs_seq, next_seq, keep = self.resolvers[shard_i].resolve(chunk, base)
        if fresh and len(self.shard_of) > 2 * 4096 * self.n:
            # Drop pins of sources the resolvers have evicted (after resolve,
            # so the source just pinned keeps its pin; JAX :91-104).
            live = set()
            for r in self.resolvers:
                live |= set(r.sources)
            self.shard_of = {k: v for k, v in self.shard_of.items() if k in live}
        st.fbuf.append(np.asarray(chunk.frames))
        st.f_rows += chunk.frames.shape[0]
        st.fseq = base + chunk.frames.shape[0]
        m = int(keep.sum())
        if m:
            st.tbuf.append({
                "obs_seq": obs_seq[keep],
                "next_seq": next_seq[keep],
                "action": np.asarray(chunk.action, np.int32)[keep],
                "reward": np.asarray(chunk.reward, np.float32)[keep],
                "discount": np.asarray(chunk.discount, np.float32)[keep],
                "prio": np.asarray(priorities, np.float32)[keep],
                # Eligibility gate: every ref < shipped frame count.
                "max_ref": int(next_seq[keep].max()),
            })
            st.t_rows += m
            self.rows_in += m
        return m

    def frame_blocks_available(self, block: int) -> int:
        return min(s.f_rows // block for s in self.shards)

    def take_frame_block(self, block: int) -> np.ndarray:
        """[n, block, *obs]: one block per shard (call only when
        ``frame_blocks_available >= 1``).  One shard's block is a view of
        its staged frames, not a copy."""
        return _stack([s.take_frames(block) for s in self.shards])

    def txn_blocks_available(self, block: int) -> int:
        return min(s.eligible_rows() // block for s in self.shards)

    def take_txn_block(self, block: int) -> dict:
        """{field: [n, block] array}: the oldest eligible rows of each shard."""
        parts = [s.take_txns(block) for s in self.shards]
        return {f: _stack([p[f] for p in parts]) for f in _TXN_FIELDS}

    def state_dict(self) -> dict:
        """Staged frames and transitions, counters and carry records, in the
        JAX stager's keys (``s{i}_*`` per shard)."""
        out = {"n_shards": self.n}
        for i, s in enumerate(self.shards):
            out[f"s{i}_frames"] = (np.concatenate(s.fbuf) if s.fbuf
                                   else np.zeros((0,), np.uint8))
            out[f"s{i}_fseq"] = s.fseq
            out[f"s{i}_shipped_f"] = s.shipped_f
            for f in _TXN_FIELDS:
                out[f"s{i}_{f}"] = (np.concatenate([c[f] for c in s.tbuf]) if s.tbuf
                                    else np.zeros((0,)))
            out[f"s{i}_maxref"] = np.array([c["max_ref"] for c in s.tbuf], np.int64)
            out[f"s{i}_rows"] = np.array([len(c["prio"]) for c in s.tbuf], np.int64)
            out[f"s{i}_dropped"] = self.resolvers[i].dropped_carry
            out[f"s{i}_src_ids"], out[f"s{i}_src_state"] = self.resolvers[i].state_arrays()
        out["shard_of_ids"] = np.array(list(self.shard_of.keys()), np.int64)
        out["shard_of_vals"] = np.array(list(self.shard_of.values()), np.int64)
        out["rr"] = self.rr
        return out

    def load_state_dict(self, state: dict) -> None:
        if int(state["n_shards"]) != self.n:
            raise ValueError(f"stager snapshot has {int(state['n_shards'])} shards, "
                             f"configured {self.n}")
        for i, s in enumerate(self.shards):
            fr = np.asarray(state[f"s{i}_frames"])
            s.fbuf = [fr] if fr.shape[0] else []
            s.f_rows = int(fr.shape[0])
            s.fseq = int(state[f"s{i}_fseq"])
            s.shipped_f = int(state[f"s{i}_shipped_f"])
            s.tbuf, s.t_rows = [], 0
            off = 0
            for k, max_ref in zip(np.asarray(state[f"s{i}_rows"]),
                                  np.asarray(state[f"s{i}_maxref"])):
                k = int(k)
                c = {f: np.asarray(state[f"s{i}_{f}"])[off:off + k] for f in _TXN_FIELDS}
                c["max_ref"] = int(max_ref)
                s.tbuf.append(c)
                s.t_rows += k
                off += k
            self.resolvers[i].dropped_carry = int(state[f"s{i}_dropped"])
            self.resolvers[i].load_state_arrays(state[f"s{i}_src_ids"],
                                                state[f"s{i}_src_state"])
        self.shard_of = {int(a): int(v) for a, v in
                         zip(state["shard_of_ids"], state["shard_of_vals"])}
        self.rr = int(state["rr"])


class FusedDedupLearner:
    """Owns the dedup device ring + train state; drives fused K-step calls
    with ``FusedDeviceLearner``'s interface.  ``mesh`` shards the ring over
    its data slots (``replay/device_dedup_dp.py``), sources pinned per
    shard; one replica per slot, as ``FusedDeviceLearner``'s mesh branch."""

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
        frame_ratio: float = 1.25,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        self._capacity = int(capacity)
        self.steps_per_call = int(steps_per_call)
        self.target_sync_freq = target_sync_freq
        self._ingest_block = int(ingest_block)
        self._priority_exponent = float(priority_exponent)
        self._mesh = mesh
        knobs = dict(batch_size=batch_size, steps_per_call=self.steps_per_call,
                     priority_exponent=priority_exponent,
                     target_sync_freq=target_sync_freq, sample_ahead=sample_ahead)
        if mesh is None:
            self._n_shards = 1
            self.device = torch.device(device)
            self._states = [state]
            self._replay = init_dedup_device_replay(capacity, obs_shape,
                                                    frame_ratio=frame_ratio,
                                                    device=self.device)
            self._shards = [self._replay]
            step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                                       sync_in_step=False)
            self._call = GraphedCall(step_fn, sample_many_fn=dedup_sample_many, **knobs)
            self._call.bind(state, self._replay)   # a card: warm up and capture now
            self._h2d = [HostToDevice(self.device)]
            self._generator = sampling_generator(state, self.device)
        else:
            devs = mesh.data_devices
            self._n_shards = len(devs)
            self.device = devs[0]
            # The state replicated over the mesh, one replica per data slot.
            self._states = place_state(state, shard_train_state(state, mesh)).rows
            self._replay = init_sharded_dedup_replay(capacity, obs_shape, mesh,
                                                     frame_ratio=frame_ratio)
            self._shards = self._replay.shards
            step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                                       sync_in_step=False)
            self._call = build_sharded_dedup_fused_learn_step(step_fn, mesh, **knobs)
            self._call.bind(self._states, self._replay)
            self._h2d = [HostToDevice(dev) for dev in devs]
            self._generator = shard_generator_group(state, devs)
        self._state = self._states[0]
        # Every shard's local ring has the same seq modulus.
        self._seq_mod = self._shards[0].seq_modulus
        self._stager = DedupStager(self._n_shards)
        # learner.ingest_block is the TOTAL rows per ingest (the
        # FusedDeviceLearner contract); the stager carves per-shard blocks.
        if self._ingest_block % self._n_shards:
            raise ValueError(f"ingest_block {self._ingest_block} must divide by the "
                             f"data-axis extent {self._n_shards}")
        self._ingest_block //= self._n_shards
        self._lock = threading.Lock()
        # Blocks already carved (frame blocks before the transition blocks
        # that reference them), waiting for their device add.
        self._prepared: list = []
        self._prepared_rows = 0
        self._size = 0          # host count of transitions ingested
        # The incremental chain's mark: (rows ingested per shard, frames
        # shipped per shard) at the last snapshot.  Both are host counters,
        # so a delta's spans need no device read.
        self._ckpt = None

    # ---------------------------------------------------------------- sinks

    def add_chunk(self, priorities: np.ndarray, transitions: DedupChunk):
        """Actor-thread sink: stage one ``DedupChunk`` (no device work)."""
        if not isinstance(transitions, DedupChunk):
            raise TypeError("FusedDedupLearner consumes DedupChunks — build fleets "
                            "with emit_dedup=True (config replay.dedup wires both ends)")
        with self._lock:
            self._stager.add_chunk(np.asarray(priorities, np.float32), transitions)

    @property
    def size(self) -> int:
        """Transitions visible to sampling (capacity-clamped)."""
        return min(self._size, self._capacity)

    @property
    def staged_rows(self) -> int:
        with self._lock:
            return self._stager.staged_rows + self._prepared_rows

    @property
    def stager(self) -> DedupStager:
        return self._stager

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

    # ------------------------------------------------------------- learner

    def prepare_staged(self, drain: bool = False) -> int:
        """Carve shippable blocks onto the prepared queue (host only, any
        thread): frame blocks first, then the eligible transition blocks, so
        dispatch order keeps frames ahead of the transitions that reference
        them.  ``drain=True`` also carves the tails in power-of-2 blocks;
        transitions whose frames are still staged stay staged.  Returns the
        transition rows carved."""
        m = self._ingest_block
        rows = 0
        with self._lock:
            st = self._stager
            while st.frame_blocks_available(m) >= 1:
                self._prepared.append(("f", st.take_frame_block(m)))
            if drain:
                self._carve_tail_locked(st.frame_blocks_available, st.take_frame_block, "f")
            while st.txn_blocks_available(m) >= 1:
                self._prepared.append(("t", st.take_txn_block(m)))
                rows += m * self._n_shards
            if drain:
                rows += self._carve_tail_locked(st.txn_blocks_available,
                                                st.take_txn_block, "t")
            self._prepared_rows += rows
        return rows

    def _carve_tail_locked(self, available, take, kind: str) -> int:
        """Carve a stream's tail in maximal power-of-2 blocks."""
        total = 0
        b = self._ingest_block >> 1
        while b >= 1:
            while available(b) >= 1:
                self._prepared.append((kind, take(b)))
                if kind == "t":
                    total += b * self._n_shards
            b >>= 1
        return total

    def pop_prepared(self) -> list:
        """Take every prepared block, in dispatch order; each goes to
        ``add_block`` on the ``train()`` caller's thread."""
        with self._lock:
            blocks, self._prepared = self._prepared, []
            self._prepared_rows = 0
        return blocks

    def add_block(self, kind: str, block) -> int:
        """Add one prepared block ([n, block] rows, row d to shard d) to the
        device ring (learner thread).  Returns the transition rows added (0
        for a frame block)."""
        ring = ShardedReplay(self._shards)
        if kind == "f":
            sharded_dedup_add_frames(ring, [h2d([block[d]])[0]
                                            for d, h2d in enumerate(self._h2d)])
            return 0
        Q = self._seq_mod
        cols = [h2d([np.remainder(block["obs_seq"][d], Q).astype(np.int32),
                     np.remainder(block["next_seq"][d], Q).astype(np.int32),
                     block["action"][d], block["reward"][d], block["discount"][d],
                     block["prio"][d]])
                for d, h2d in enumerate(self._h2d)]
        sharded_dedup_add_transitions(ring, *zip(*cols),
                                      priority_exponent=self._priority_exponent)
        n = block["prio"].shape[1] * self._n_shards
        self._size += n
        return n

    def ingest_staged(self, drain: bool = False) -> int:
        """Carve and add staged blocks inline (learner thread), as the span
        ``ingest`` with the rows and blocks it moved; the adds are one piece
        of the learner stream's clock.  Returns the transition rows
        ingested."""
        with current_timer().stage("ingest") as span:
            self.prepare_staged(drain=drain)
            blocks = self.pop_prepared()
            if blocks:
                with self._call.stream_piece():
                    span.rows = sum(self.add_block(k, b) for k, b in blocks)
                span.blocks = len(blocks)
        return span.rows

    @property
    def supports_ingest_fold(self) -> bool:
        """The dedup ingest is two streams (frames land before the
        transitions that reference them): no single-call fold."""
        return False

    def train(self, beta: float, u: Optional[torch.Tensor] = None,
              on_replay: Optional[Callable[[int], None]] = None):
        """One fused call: K steps of sample/train/restamp.  Returns the
        call's metrics [K, ...], still on the device.  ``on_replay(step)``
        runs between the call's graph replays (``GraphedCall``); over a mesh
        ``u`` is [n, K, B / n]."""
        if self._mesh is not None:
            _, _, metrics = self._call(self._states, self._replay, beta, u=u,
                                       generators=self._generator.generators,
                                       on_replay=on_replay)
            return metrics
        self._state, self._replay, metrics = self._call(
            self._state, self._replay, beta, u=u, generator=self._generator,
            on_replay=on_replay)
        return metrics

    # ------------------------------------------------------------ snapshots

    def _flush_prepared_locked(self) -> None:
        """Add every carved block to the ring (learner thread, lock held):
        a prepared block lives in neither the stager nor the ring, so a
        snapshot around one would lose it."""
        blocks, self._prepared = self._prepared, []
        self._prepared_rows = 0
        for kind, block in blocks:
            self.add_block(kind, block)

    def _chain_now_locked(self):
        """(rows ingested per shard, frames shipped per shard): host-side
        monotone counters (every shard ingests the same block rows)."""
        return (self._size // self._n_shards,
                tuple(s.shipped_f for s in self._stager.shards))

    def _ring_arrays(self) -> dict:
        """The ring's columns in the JAX global layout (shards concatenated
        in slot order) and its counters: scalars for one ring, [n] per
        shard over a mesh."""
        out = {"dedup": np.asarray(True)}
        for f in _RING_FIELDS:   # a copy on the CPU too (see FusedDeviceLearner)
            out[f] = np.concatenate([getattr(r, f).to("cpu", copy=True).numpy()
                                     for r in self._shards])
        for k in ("cursor", "count", "fcount"):
            v = np.asarray([getattr(r, k) for r in self._shards], np.int32)
            out[k] = v if self._mesh is not None else v[0]
        return out

    def state_dict(self) -> dict:
        """The ring as host numpy (a full synchronous snapshot) and the
        stager's state as ``stage_*``."""
        with self._lock:
            self._flush_prepared_locked()
            stage = self._stager.state_dict()
        out = self._ring_arrays()
        out.update({f"stage_{k}": v for k, v in stage.items()})
        return out

    def delta_state_dict(self, force_base: bool = False) -> dict:
        """A full base (first call, forced, or a span of a whole ring shard)
        or the spans written since the last call (learner thread).  A
        delta's span gathers and the mass copy are issued on the learner's
        stream into fresh tensors on slot 0's device; on a card the dict's
        ``ready`` event marks them done, and the checkpoint writer copies
        them to the host."""
        n = self._n_shards
        C_local = self._capacity // n
        Cf_local = self._shards[0].frame_capacity
        with self._lock:
            self._flush_prepared_locked()
            ing_now, shipped_now = self._chain_now_locked()
            prev = self._ckpt
            stage = self._stager.state_dict()
            self._ckpt = (ing_now, shipped_now)
        mark = np.asarray([ing_now, *shipped_now], np.int64)
        new_rows = ing_now - (prev[0] if prev else 0)
        f_new = [shipped_now[d] - (prev[1][d] if prev else 0) for d in range(n)]
        if force_base or prev is None or new_rows >= C_local or max(f_new) >= Cf_local:
            out = self._ring_arrays()
            out.update({f"stage_{k}": v for k, v in stage.items()})
            out["chain_mark"] = mark
            return out
        ing_prev, shipped_prev = prev
        dev = self.device
        local = (ing_prev + np.arange(new_rows)) % C_local
        tidx = np.concatenate([d * C_local + local for d in range(n)]).astype(np.int32)
        fidx = np.concatenate([d * Cf_local + (shipped_prev[d] + np.arange(f_new[d])) % Cf_local
                               for d in range(n)]).astype(np.int32)

        def gather(name, spans):
            return torch.cat([getattr(r, name).index_select(
                0, torch.as_tensor(sp, device=r.mass.device)).to(dev)
                for r, sp in zip(self._shards, spans)])

        tspans = [local] * n
        fspans = [(shipped_prev[d] + np.arange(f_new[d])) % Cf_local for d in range(n)]
        out = DeviceSnapshot({
            "delta": np.asarray(True),
            "dedup": np.asarray(True),
            "n_shards": n,
            "chain_prev": np.asarray([ing_prev, *shipped_prev], np.int64),
            "chain_mark": mark,
            "txn_gidx": tidx,
            "txn_obs_ref": gather("obs_ref", tspans),
            "txn_next_ref": gather("next_ref", tspans),
            "txn_action": gather("action", tspans),
            "txn_reward": gather("reward", tspans),
            "txn_discount": gather("discount", tspans),
            "frame_gidx": fidx,
            "frame_rows": gather("frames", fspans),
            "mass": torch.cat([r.mass.to(dev, copy=True) for r in self._shards]),
            # The ring's counters from the host's: mod C, saturating, mod Q.
            "cursor": np.asarray([ing_now % C_local] * n, np.int32),
            "count": np.asarray([min(ing_now, COUNT_CAP)] * n, np.int32),
            "fcount": np.asarray([f % self._seq_mod for f in shipped_now], np.int32),
            "capacity": self._capacity,
            "frame_capacity": Cf_local * n,
        })
        out.update({f"stage_{k}": v for k, v in stage.items()})
        if dev.type == "cuda":
            out.ready = torch.cuda.Event()
            out.ready.record(torch.cuda.current_stream(dev))
        return out

    def apply_delta_state_dict(self, delta: dict) -> None:
        """Apply one delta onto the ring (restore side); a delta that does
        not continue the ring's counters raises."""
        if "delta" not in delta:
            raise ValueError("not a delta snapshot (missing 'delta' key)")
        n = self._n_shards
        if int(delta["n_shards"]) != n:
            raise ValueError(f"delta has {int(delta['n_shards'])} shards, configured {n}")
        C_local = self._capacity // n
        Cf_local = self._shards[0].frame_capacity
        if int(delta["capacity"]) != self._capacity or \
                int(delta["frame_capacity"]) != Cf_local * n:
            raise ValueError("delta ring layout != configured layout")
        prev = tuple(int(x) for x in np.asarray(delta["chain_prev"]).reshape(-1))
        with self._lock:
            ing_now, shipped_now = self._chain_now_locked()
        if prev != (ing_now, *shipped_now):
            raise ValueError(f"delta chain discontinuity: delta continues {prev}, "
                             f"replay is at {(ing_now, *shipped_now)}")
        ti = np.asarray(delta["txn_gidx"], np.int64)
        fi = np.asarray(delta["frame_gidx"], np.int64)
        frames = np.asarray(delta["frame_rows"])
        txn = {f: np.asarray(delta[f"txn_{f}"]) for f in
               ("obs_ref", "next_ref", "action", "reward", "discount")}
        mass = np.asarray(delta["mass"]).reshape(-1)
        cursor, count, fcount = (np.asarray(delta[k]).reshape(-1)
                                 for k in ("cursor", "count", "fcount"))
        with torch.no_grad():
            for d, r in enumerate(self._shards):
                dev = r.mass.device

                def put(a, dtype=None):
                    return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                                         dtype=dtype)

                tsel = (ti >= d * C_local) & (ti < (d + 1) * C_local)
                fsel = (fi >= d * Cf_local) & (fi < (d + 1) * Cf_local)
                tl = put(ti[tsel] - d * C_local, torch.int64)
                r.frames[put(fi[fsel] - d * Cf_local, torch.int64)] = put(frames[fsel])
                for f, v in txn.items():
                    getattr(r, f)[tl] = put(v[tsel], getattr(r, f).dtype)
                r.mass.copy_(put(mass[d * C_local:(d + 1) * C_local]))
                r.cursor, r.count, r.fcount = int(cursor[d]), int(count[d]), int(fcount[d])
        with self._lock:
            self._stager.load_state_dict({k[len("stage_"):]: np.asarray(v)
                                          for k, v in delta.items() if k.startswith("stage_")})
            self._size = int(np.sum(count))
            self._ckpt = self._chain_now_locked()

    def load_state_dict(self, state: dict) -> None:
        """Restore ring and stager from a full snapshot of the same layout,
        copying into the existing device tensors."""
        if "dedup" not in state:
            raise ValueError("snapshot is not a dedup-ring snapshot — replay layouts "
                             "(replay.dedup) must match across save and restore")
        want = (self._shards[0].frame_capacity * self._n_shards,
                *self._shards[0].frames.shape[1:])
        got = tuple(np.shape(state["frames"]))
        if want != got:
            raise ValueError(f"replay snapshot frame ring {got} != configured {want}")
        want_layout = (self._n_shards,) if self._mesh is not None else ()
        if np.shape(state["cursor"]) != want_layout:
            raise ValueError("snapshot shard layout != configured data_parallel extent")
        with torch.no_grad():
            for f in _RING_FIELDS:
                value, off = np.asarray(state[f]), 0
                for r in self._shards:
                    t = getattr(r, f)
                    t.copy_(torch.from_numpy(value[off:off + t.shape[0]]))
                    off += t.shape[0]
        for k in ("cursor", "count", "fcount"):
            for r, v in zip(self._shards, np.asarray(state[k]).reshape(-1)):
                setattr(r, k, int(v))
        with self._lock:
            self._size = int(np.sum(state["count"]))
            self._stager.load_state_dict({k[len("stage_"):]: v for k, v in state.items()
                                          if k.startswith("stage_")})
            # A full load ends the chain's mark: the next incremental save is
            # a base unless deltas follow (their apply re-marks).
            self._ckpt = None


class DeviceSnapshot(dict):
    """A snapshot dict whose tensors a CUDA event (``ready``) marks done on
    the learner's stream; None on the CPU."""

    ready = None


_RING_FIELDS = ("frames", "obs_ref", "next_ref", "action", "reward", "discount", "mass")
