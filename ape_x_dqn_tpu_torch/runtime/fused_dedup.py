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

Not part of the port yet, and refused by name: the sharded ring (``mesh``,
``replay/device_dedup_dp.py``, ROADMAP A10) and the snapshots of ring and
stager (``state_dict`` and the delta protocol, ROADMAP A9).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
from ape_x_dqn_tpu_torch.replay.buffer import NotPortedError
from ape_x_dqn_tpu_torch.replay.dedup import CarryResolver
from ape_x_dqn_tpu_torch.replay.device_dedup import (
    dedup_device_add_frames,
    dedup_device_add_transitions,
    dedup_sample_many,
    init_dedup_device_replay,
)
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
        base = self.fseq
        obs_seq, next_seq, keep = self.resolver.resolve(chunk, base)
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
                                 "is not part of the port yet (ROADMAP A10)")
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
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed((int(state.seed) ^ 0x5EED) & (2**63 - 1))
        self._stager = DedupStager()
        self._lock = threading.Lock()
        # Blocks already carved (frame blocks before the transition blocks
        # that reference them), waiting for their device add.
        self._prepared: list = []
        self._prepared_rows = 0
        self._size = 0          # host count of transitions ingested

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

    def train(self, beta: float, u: Optional[torch.Tensor] = None):
        """One fused call: K steps of sample/train/restamp.  Returns the
        call's metrics [K, ...], still on the device."""
        self._state, self._replay, metrics = self._call(
            self._state, self._replay, beta, u=u, generator=self._generator
        )
        return metrics

    # -------------------------------------------------- snapshots (A9)

    def _no_snapshots(self, *_args, **_kwargs):
        raise NotPortedError("snapshots of the dedup ring and its stager are not "
                             "part of the port yet (checkpoints, ROADMAP A9)")

    state_dict = load_state_dict = _no_snapshots
    delta_state_dict = apply_delta_state_dict = _no_snapshots
