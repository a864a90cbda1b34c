"""Host side of the frame-dedup device replay.

Port of ``ape_x_dqn_tpu/runtime/fused_dedup.py``, single shard: the dedup
twin of ``runtime/fused_learner.FusedDeviceLearner`` with the same
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

Snapshots (JAX :191-257, :538-761) keep the JAX package's keys at one
shard (``n_shards`` 1, ``s0_*``, ``shard_of_*``, ``rr``; int64 seqs not yet
reduced mod Q, as in JAX), so a snapshot or chain of either package
resumes in the other.  ``state_dict`` / ``load_state_dict`` are full (the
load copies into the existing device tensors, so the graph runner keeps
its captures).  ``delta_state_dict`` is the incremental chain's delta: the
transition and frame spans written since the last mark, gathered on the
learner's stream into fresh tensors (a later call's in-place writes cannot
reach them) and returned with a ``ready`` event; ``utils/checkpoint_inc``'s
writer thread waits on it and copies them to the host, so the learner
thread never waits for the device.

Not part of the port yet, and refused by name: the sharded ring (``mesh``,
``replay/device_dedup_dp.py``, ROADMAP item 8).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
from ape_x_dqn_tpu_torch.replay.buffer import NotPortedError
from ape_x_dqn_tpu_torch.replay.dedup import CarryResolver
from ape_x_dqn_tpu_torch.replay.device_dedup import (
    COUNT_CAP,
    dedup_device_add_frames,
    dedup_device_add_transitions,
    dedup_sample_many,
    init_dedup_device_replay,
)
from ape_x_dqn_tpu_torch.runtime.fused_learner import sampling_generator
from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall
from ape_x_dqn_tpu_torch.runtime.infeed import HostToDevice
from ape_x_dqn_tpu_torch.types import DedupChunk, TrainState

_TXN_FIELDS = ("obs_seq", "next_seq", "action", "reward", "discount", "prio")


class DedupStager:
    """Ref resolution + block scheduling for one ring (host side, numpy).

    Carry semantics are the ``CarryResolver``'s: per-source (chunk_seq,
    base, U) continuity records; a gap drops only the carried rows
    (``dropped_carry``)."""

    def __init__(self):
        self.resolver = CarryResolver()
        self.fbuf: list = []     # frame arrays, stage order
        self.f_rows = 0          # staged frame rows not yet carved
        self.fseq = 0            # next absolute frame seq to assign
        self.shipped_f = 0       # frames carved into blocks
        self.tbuf: list = []     # transition chunks: arrays + max_ref
        self.t_rows = 0
        self.rows_in = 0         # transitions ever accepted
        # Source pins, as the JAX stager keeps them (every source on shard
        # 0 here): snapshots carry them under JAX's keys.
        self.shard_of: dict = {}
        self.rr = 0

    @property
    def dropped_carry(self) -> int:
        return self.resolver.dropped_carry

    @property
    def sources(self) -> dict:
        """source -> (chunk_seq, base, U)."""
        return self.resolver.sources

    @property
    def staged_rows(self) -> int:
        return self.t_rows

    def add_chunk(self, priorities: np.ndarray, chunk: DedupChunk) -> int:
        """Stage one chunk; returns the transition rows accepted."""
        fresh = chunk.source not in self.shard_of
        if fresh:
            self.shard_of[chunk.source] = 0
            self.rr += 1
        base = self.fseq
        obs_seq, next_seq, keep = self.resolver.resolve(chunk, base)
        if fresh and len(self.shard_of) > 2 * 4096:
            # Drop pins of sources the resolver has evicted (after resolve,
            # so the source just pinned keeps its pin; JAX :93-104).
            live = self.resolver.sources
            self.shard_of = {k: v for k, v in self.shard_of.items() if k in live}
        self.fbuf.append(np.asarray(chunk.frames))
        self.f_rows += chunk.frames.shape[0]
        self.fseq = base + chunk.frames.shape[0]
        m = int(keep.sum())
        if m:
            self.tbuf.append({
                "obs_seq": obs_seq[keep],
                "next_seq": next_seq[keep],
                "action": np.asarray(chunk.action, np.int32)[keep],
                "reward": np.asarray(chunk.reward, np.float32)[keep],
                "discount": np.asarray(chunk.discount, np.float32)[keep],
                "prio": np.asarray(priorities, np.float32)[keep],
                # Eligibility gate: every ref < shipped frame count.
                "max_ref": int(next_seq[keep].max()),
            })
            self.t_rows += m
            self.rows_in += m
        return m

    def frame_blocks_available(self, block: int) -> int:
        return self.f_rows // block

    def take_frame_block(self, block: int) -> np.ndarray:
        """[block, *obs] (call only when ``frame_blocks_available >= 1``)."""
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

    def _eligible_rows(self) -> int:
        rows = 0
        for c in self.tbuf:
            if c["max_ref"] >= self.shipped_f:
                break
            rows += len(c["prio"])
        return rows

    def txn_blocks_available(self, block: int) -> int:
        return self._eligible_rows() // block

    def take_txn_block(self, block: int) -> dict:
        """{field: [block] array} of the oldest eligible rows."""
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

    def state_dict(self) -> dict:
        """Staged frames and transitions, counters and carry records, in the
        JAX stager's keys at one shard."""
        out = {"n_shards": 1}
        out["s0_frames"] = (np.concatenate(self.fbuf) if self.fbuf
                            else np.zeros((0,), np.uint8))
        out["s0_fseq"] = self.fseq
        out["s0_shipped_f"] = self.shipped_f
        for f in _TXN_FIELDS:
            out[f"s0_{f}"] = (np.concatenate([c[f] for c in self.tbuf]) if self.tbuf
                              else np.zeros((0,)))
        out["s0_maxref"] = np.array([c["max_ref"] for c in self.tbuf], np.int64)
        out["s0_rows"] = np.array([len(c["prio"]) for c in self.tbuf], np.int64)
        out["s0_dropped"] = self.resolver.dropped_carry
        out["s0_src_ids"], out["s0_src_state"] = self.resolver.state_arrays()
        out["shard_of_ids"] = np.array(list(self.shard_of.keys()), np.int64)
        out["shard_of_vals"] = np.array(list(self.shard_of.values()), np.int64)
        out["rr"] = self.rr
        return out

    def load_state_dict(self, state: dict) -> None:
        if int(state["n_shards"]) != 1:
            raise ValueError(f"stager snapshot has {int(state['n_shards'])} shards, "
                             "the port's ring has 1 (the sharded ring is ROADMAP item 8)")
        fr = np.asarray(state["s0_frames"])
        self.fbuf = [fr] if fr.shape[0] else []
        self.f_rows = int(fr.shape[0])
        self.fseq = int(state["s0_fseq"])
        self.shipped_f = int(state["s0_shipped_f"])
        self.tbuf, self.t_rows = [], 0
        off = 0
        for k, max_ref in zip(np.asarray(state["s0_rows"]), np.asarray(state["s0_maxref"])):
            k = int(k)
            c = {f: np.asarray(state[f"s0_{f}"])[off:off + k] for f in _TXN_FIELDS}
            c["max_ref"] = int(max_ref)
            self.tbuf.append(c)
            self.t_rows += k
            off += k
        self.resolver.dropped_carry = int(state["s0_dropped"])
        self.resolver.load_state_arrays(state["s0_src_ids"], state["s0_src_state"])
        self.shard_of = {int(a): int(v) for a, v in
                         zip(state["shard_of_ids"], state["shard_of_vals"])}
        self.rr = int(state["rr"])


class FusedDedupLearner:
    """Owns the dedup device ring + train state; drives fused K-step calls
    with ``FusedDeviceLearner``'s interface."""

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
        if mesh is not None:
            raise NotPortedError("the sharded dedup ring (replay/device_dedup_dp.py) "
                                 "is not part of the port yet (ROADMAP item 8)")
        self._capacity = int(capacity)
        self.steps_per_call = int(steps_per_call)
        self.target_sync_freq = target_sync_freq
        self._ingest_block = int(ingest_block)
        self._priority_exponent = float(priority_exponent)
        self.device = torch.device(device)
        self._state = state
        self._replay = init_dedup_device_replay(capacity, obs_shape,
                                                frame_ratio=frame_ratio, device=self.device)
        self._seq_mod = self._replay.seq_modulus
        step_fn = build_train_step(network, optimizer, loss_kind=loss_kind,
                                   sync_in_step=False)
        self._call = GraphedCall(step_fn, batch_size=batch_size,
                                 steps_per_call=self.steps_per_call,
                                 priority_exponent=priority_exponent,
                                 target_sync_freq=target_sync_freq,
                                 sample_ahead=sample_ahead,
                                 sample_many_fn=dedup_sample_many)
        self._call.bind(state, self._replay)   # a card: warm up and capture now
        self._h2d = HostToDevice(self.device)
        self._generator = sampling_generator(state, self.device)
        self._stager = DedupStager()
        self._lock = threading.Lock()
        # Blocks already carved (frame blocks before the transition blocks
        # that reference them), waiting for their device add.
        self._prepared: list = []
        self._prepared_rows = 0
        self._size = 0          # host count of transitions ingested
        # The incremental chain's mark: (rows ingested, frames shipped) at
        # the last snapshot.  Both are host counters, so a delta's spans
        # need no device read.
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
                rows += m
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
                    total += b
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
        """Add one prepared block to the device ring (learner thread).
        Returns the transition rows added (0 for a frame block)."""
        if kind == "f":
            (frames,) = self._h2d([block])
            dedup_device_add_frames(self._replay, frames)
            return 0
        Q = self._seq_mod
        cols = self._h2d([
            np.remainder(block["obs_seq"], Q).astype(np.int32),
            np.remainder(block["next_seq"], Q).astype(np.int32),
            block["action"], block["reward"], block["discount"], block["prio"],
        ])
        dedup_device_add_transitions(self._replay, *cols, self._priority_exponent)
        n = len(block["prio"])
        self._size += n
        return n

    def ingest_staged(self, drain: bool = False) -> int:
        """Carve and add staged blocks inline (learner thread).  Returns the
        transition rows ingested."""
        self.prepare_staged(drain=drain)
        return sum(self.add_block(k, b) for k, b in self.pop_prepared())

    @property
    def supports_ingest_fold(self) -> bool:
        """The dedup ingest is two streams (frames land before the
        transitions that reference them): no single-call fold."""
        return False

    def train(self, beta: float, u: Optional[torch.Tensor] = None,
              on_replay: Optional[Callable[[int], None]] = None):
        """One fused call: K steps of sample/train/restamp.  Returns the
        call's metrics [K, ...], still on the device.  ``on_replay(step)``
        runs between the call's graph replays (``GraphedCall``)."""
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

    def _ring_arrays(self) -> dict:
        r = self._replay
        out = {"dedup": np.asarray(True)}
        for f in _RING_FIELDS:   # a copy on the CPU too (see FusedDeviceLearner)
            out[f] = getattr(r, f).to("cpu", copy=True).numpy()
        out["cursor"] = np.asarray(r.cursor, np.int32)
        out["count"] = np.asarray(r.count, np.int32)
        out["fcount"] = np.asarray(r.fcount, np.int32)
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
        """A full base (first call, forced, or a span of a whole ring) or
        the spans written since the last call (learner thread).  A delta's
        span gathers and the mass copy are issued on the learner's stream
        into fresh tensors; on a card the dict's ``ready`` event marks them
        done, and the checkpoint writer copies them to the host."""
        C, Cf = self._capacity, self._replay.frame_capacity
        with self._lock:
            self._flush_prepared_locked()
            ing_now, shipped_now = self._size, self._stager.shipped_f
            prev = self._ckpt
            stage = self._stager.state_dict()
            self._ckpt = (ing_now, shipped_now)
        new_rows = ing_now - (prev[0] if prev else 0)
        f_new = shipped_now - (prev[1] if prev else 0)
        if force_base or prev is None or new_rows >= C or f_new >= Cf:
            out = self._ring_arrays()
            out.update({f"stage_{k}": v for k, v in stage.items()})
            out["chain_mark"] = np.asarray([ing_now, shipped_now], np.int64)
            return out
        r, dev = self._replay, self.device
        tidx = torch.remainder(prev[0] + torch.arange(new_rows, device=dev), C)
        fidx = torch.remainder(prev[1] + torch.arange(f_new, device=dev), Cf)
        out = DeviceSnapshot({
            "delta": np.asarray(True),
            "dedup": np.asarray(True),
            "n_shards": 1,
            "chain_prev": np.asarray([prev[0], prev[1]], np.int64),
            "chain_mark": np.asarray([ing_now, shipped_now], np.int64),
            "txn_gidx": ((prev[0] + np.arange(new_rows)) % C).astype(np.int32),
            "txn_obs_ref": r.obs_ref.index_select(0, tidx),
            "txn_next_ref": r.next_ref.index_select(0, tidx),
            "txn_action": r.action.index_select(0, tidx),
            "txn_reward": r.reward.index_select(0, tidx),
            "txn_discount": r.discount.index_select(0, tidx),
            "frame_gidx": ((prev[1] + np.arange(f_new)) % Cf).astype(np.int32),
            "frame_rows": r.frames.index_select(0, fidx),
            "mass": r.mass.clone(),
            # The ring's counters from the host's: mod C, saturating, mod Q.
            "cursor": np.asarray([ing_now % C], np.int32),
            "count": np.asarray([min(ing_now, COUNT_CAP)], np.int32),
            "fcount": np.asarray([shipped_now % self._seq_mod], np.int32),
            "capacity": C,
            "frame_capacity": Cf,
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
        if int(delta["n_shards"]) != 1:
            raise ValueError(f"delta has {int(delta['n_shards'])} shards, the port's "
                             "ring has 1 (the sharded ring is ROADMAP item 8)")
        r = self._replay
        if int(delta["capacity"]) != self._capacity or \
                int(delta["frame_capacity"]) != r.frame_capacity:
            raise ValueError("delta ring layout != configured layout")
        prev = tuple(int(x) for x in np.asarray(delta["chain_prev"]).reshape(-1))
        with self._lock:
            now = (self._size, self._stager.shipped_f)
        if prev != now:
            raise ValueError(f"delta chain discontinuity: delta continues {prev}, "
                             f"replay is at {now}")

        def dev(key, dtype=None):
            a = torch.from_numpy(np.ascontiguousarray(delta[key]))
            return a.to(device=self.device, dtype=dtype)

        ti = dev("txn_gidx", torch.int64)
        fi = dev("frame_gidx", torch.int64)
        with torch.no_grad():
            r.frames[fi] = dev("frame_rows")
            for f in ("obs_ref", "next_ref", "action", "reward", "discount"):
                getattr(r, f)[ti] = dev(f"txn_{f}", getattr(r, f).dtype)
            r.mass.copy_(dev("mass").reshape(r.mass.shape))
        r.cursor = int(np.asarray(delta["cursor"]).reshape(-1)[0])
        r.count = int(np.asarray(delta["count"]).reshape(-1)[0])
        r.fcount = int(np.asarray(delta["fcount"]).reshape(-1)[0])
        with self._lock:
            self._stager.load_state_dict({k[len("stage_"):]: np.asarray(v)
                                          for k, v in delta.items() if k.startswith("stage_")})
            self._size = int(np.sum(np.asarray(delta["count"])))
            self._ckpt = (self._size, self._stager.shipped_f)

    def load_state_dict(self, state: dict) -> None:
        """Restore ring and stager from a full snapshot of the same layout,
        copying into the existing device tensors."""
        if "dedup" not in state:
            raise ValueError("snapshot is not a dedup-ring snapshot — replay layouts "
                             "(replay.dedup) must match across save and restore")
        r = self._replay
        want, got = tuple(r.frames.shape), tuple(np.shape(state["frames"]))
        if want != got:
            raise ValueError(f"replay snapshot frame ring {got} != configured {want}")
        if np.shape(state["cursor"]) != ():
            raise ValueError("snapshot shard layout != the port's single ring (the "
                             "sharded ring is ROADMAP item 8)")
        with torch.no_grad():
            for f in _RING_FIELDS:
                getattr(r, f).copy_(torch.from_numpy(np.asarray(state[f])))
        r.cursor, r.count, r.fcount = (int(state[k]) for k in ("cursor", "count", "fcount"))
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
