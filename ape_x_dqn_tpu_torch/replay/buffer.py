"""Host prioritized replay — array-backed ring buffer + sum-tree.

Port of ``ape_x_dqn_tpu/replay/buffer.py``: ``RawFrameStore``,
``CompressedFrameStore`` and ``PrioritizedReplay``.  It stays numpy, not
torch: masses are float64 p^α, targets come from a numpy generator, and the
tree is either twin of ``sum_tree.py`` (numpy) / ``native.py`` (C++), so the
same adds and the same seed draw the same slots as the JAX package's replay.
A batch moves to the device only after it is sampled (``runtime/infeed.py``).

Storage is preallocated numpy: frames stay uint8 end to end, scalars in
flat arrays.  Identity is the slot index — what the learner echoes back
with new priorities.  One mutex guards mutation and sampling, taken once
per batch (an actor chunk or a learner batch), not per transition.

Snapshots (``state_dict`` / ``load_state_dict``) and the incremental
checkpoint protocol (``delta_state_dict`` / ``apply_delta_state_dict``,
JAX :531-628: the span written since the last mark, the restamped slots
since then, ``chain_prev`` / ``chain_mark``) keep the JAX replay's keys and
dtypes (masses float64), so either package loads the other's.

With ``hot_frame_budget_bytes > 0`` both frame stores are a
``TieredFrameStore`` (``replay/tiered.py``): each holds half the hot budget
and spills least-recently-sampled spans to its own file (``obs.cold``,
``next_obs.cold``) under ``spill_dir``; the sampling law is untouched.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not carry yet."""


class RawFrameStore:
    """Preallocated ndarray frame storage — the default.

    The encode/put_encoded split exists so ``PrioritizedReplay.add`` can do
    any per-frame work (a no-op here; deflate for the compressed store)
    OUTSIDE the replay lock.
    """

    compressed = False

    def __init__(self, capacity: int, frame_shape):
        self._arr = np.zeros((capacity, *frame_shape), dtype=np.uint8)
        self.shape = tuple(frame_shape)

    def encode(self, frames: np.ndarray):
        return frames

    def put_encoded(self, idx: np.ndarray, encoded) -> None:
        self._arr[idx] = encoded

    def put(self, idx: np.ndarray, frames: np.ndarray) -> None:
        self.put_encoded(idx, self.encode(frames))

    def get(self, idx: np.ndarray) -> np.ndarray:
        # Advanced indexing already allocates a fresh array — no copy.
        return self._arr[idx]

    def nbytes(self) -> int:
        return self._arr.nbytes


class TieredFrameStore:
    """Frame store over a ``TieredFrameRing`` (``replay/tiered.py``): the
    double-store's answer to ``replay.hot_frame_budget_bytes``.  Slot
    indices map 1:1 onto ring slots; least-recently-sampled spans spill to
    the CRC-framed cold file and fault back on ``get``.  Snapshots
    materialize through ``get``: the cold-ref checkpoint leg lives on the
    dedup replays, where the paper-scale rings are."""

    compressed = False

    def __init__(self, capacity: int, frame_shape, *, hot_budget_bytes: int,
                 spill_path: str, span_frames: int = 0,
                 watermark_high: float = 1.0, watermark_low: float = 0.9):
        from ape_x_dqn_tpu_torch.replay.tiered import TieredFrameRing

        self.ring = TieredFrameRing(
            capacity, frame_shape, dtype=np.uint8,
            hot_budget_bytes=hot_budget_bytes, spill_path=spill_path,
            span_frames=span_frames, watermark_high=watermark_high,
            watermark_low=watermark_low,
        )
        self.shape = self.ring.frame_shape

    def encode(self, frames: np.ndarray):
        return frames

    def put_encoded(self, idx: np.ndarray, encoded) -> None:
        self.ring.put(np.asarray(idx, np.int64), encoded)

    def put(self, idx: np.ndarray, frames: np.ndarray) -> None:
        self.put_encoded(idx, self.encode(frames))

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.ring.get(np.asarray(idx, np.int64))

    def nbytes(self) -> int:
        return self.ring.hot_bytes


class CompressedFrameStore:
    """Per-slot zlib-compressed frame storage: a memory/CPU trade for big
    host buffers.  One deflate per stored frame (off the replay lock, via
    ``encode``) and one inflate per sampled row.  Level 1 keeps most of the
    ratio at a fraction of level 6's CPU."""

    compressed = True
    level = 1

    def __init__(self, capacity: int, frame_shape):
        self._slots: list = [None] * capacity
        self.shape = tuple(frame_shape)

    def encode(self, frames: np.ndarray) -> list:
        frames = np.asarray(frames, np.uint8)
        return [zlib.compress(frames[i].tobytes(), self.level)
                for i in range(frames.shape[0])]

    def put_encoded(self, idx: np.ndarray, encoded: list) -> None:
        for i, k in enumerate(idx):
            self._slots[int(k)] = encoded[i]

    def put(self, idx: np.ndarray, frames: np.ndarray) -> None:
        self.put_encoded(idx, self.encode(frames))

    def get(self, idx: np.ndarray) -> np.ndarray:
        out = np.empty((len(idx), *self.shape), np.uint8)
        for i, k in enumerate(idx):
            out[i] = np.frombuffer(
                zlib.decompress(self._slots[int(k)]), np.uint8
            ).reshape(self.shape)
        return out

    def export_blobs_idx(self, idx: np.ndarray) -> tuple:
        """Deflated slots at arbitrary indices (dirty-span checkpoints)."""
        blobs = [self._slots[int(k)] for k in idx]
        lens = np.array([len(b) for b in blobs], np.int64)
        return np.frombuffer(b"".join(blobs), np.uint8).copy(), lens

    def import_blobs_idx(self, idx: np.ndarray, blob: np.ndarray,
                         lens: np.ndarray) -> None:
        raw = blob.tobytes()
        off = 0
        for k, n in zip(idx, lens):
            self._slots[int(k)] = raw[off:off + int(n)]
            off += int(n)

    def export_blobs(self, size: int) -> tuple:
        """(blob uint8 [sum lens], lens int64 [size]) — the deflated slots
        verbatim, so a snapshot never materializes the dense buffer."""
        blobs = self._slots[:size]
        lens = np.array([len(b) for b in blobs], np.int64)
        return np.frombuffer(b"".join(blobs), np.uint8).copy(), lens

    def import_blobs(self, blob: np.ndarray, lens: np.ndarray) -> None:
        raw = blob.tobytes()
        off = 0
        for i, n in enumerate(lens):
            self._slots[i] = raw[off:off + int(n)]
            off += int(n)

    def nbytes(self) -> int:
        return sum(len(s) for s in self._slots if s is not None)


class PrioritizedReplay:
    """Prioritized n-step transition store.

    Args:
      capacity: max transitions held (FIFO ring: the oldest slots are
        overwritten when full).
      obs_shape: per-frame uint8 observation shape, e.g. (84, 84, 1).
      priority_exponent: α in p^α.
      sum_tree_cls: injectable tree implementation; the default is the
        native C++ tree, which raises if it cannot be built.
      frame_compression: zlib-compress stored frames (``CompressedFrameStore``).
      hot_frame_budget_bytes: > 0 caps the resident frame bytes
        (``TieredFrameStore``, half the budget for each of obs and
        next_obs); needs ``spill_dir``; exclusive with frame_compression.
      spill_span_frames, spill_watermark_high, spill_watermark_low: the
        tier's span size (0: ~64 KiB) and eviction hysteresis.
    """

    def __init__(
        self,
        capacity: int,
        obs_shape,
        priority_exponent: float = 0.6,
        sum_tree_cls=None,
        frame_compression: bool = False,
        hot_frame_budget_bytes: int = 0,
        spill_dir: Optional[str] = None,
        spill_span_frames: int = 0,
        spill_watermark_high: float = 1.0,
        spill_watermark_low: float = 0.9,
    ):
        if sum_tree_cls is None:
            from ape_x_dqn_tpu_torch.replay.native import default_sum_tree_cls

            sum_tree_cls = default_sum_tree_cls()
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.alpha = float(priority_exponent)
        if hot_frame_budget_bytes > 0:
            # Tiered double-store: obs and next_obs each get half the hot
            # budget and their own spill file (JAX :229-256).
            if frame_compression:
                raise ValueError("hot_frame_budget_bytes and frame_compression are "
                                 "mutually exclusive")
            if spill_dir is None:
                raise ValueError("tiered replay needs a spill_dir")
            tier_kw = dict(hot_budget_bytes=max(1, int(hot_frame_budget_bytes) // 2),
                           span_frames=spill_span_frames,
                           watermark_high=spill_watermark_high,
                           watermark_low=spill_watermark_low)
            self._obs = TieredFrameStore(
                capacity, obs_shape, spill_path=os.path.join(spill_dir, "obs.cold"), **tier_kw)
            self._next_obs = TieredFrameStore(
                capacity, obs_shape, spill_path=os.path.join(spill_dir, "next_obs.cold"),
                **tier_kw)
        else:
            store_cls = CompressedFrameStore if frame_compression else RawFrameStore
            self._obs = store_cls(capacity, obs_shape)
            self._next_obs = store_cls(capacity, obs_shape)
        self._action = np.zeros((capacity,), dtype=np.int32)
        self._reward = np.zeros((capacity,), dtype=np.float32)
        self._discount = np.zeros((capacity,), dtype=np.float32)
        self._tree = sum_tree_cls(capacity)
        self._cursor = 0
        self._count = 0  # total transitions ever added
        self._lock = threading.Lock()
        # Incremental-checkpoint marks: (count, cursor) at the last delta
        # snapshot, and the restamped index arrays since.  None: the next
        # delta_state_dict is a full base.
        self._ckpt = None
        self._dirty: list = []
        self._dirty_rows = 0

    # -- write path (actors) ---------------------------------------------

    def add(self, priorities: np.ndarray, batch: NStepTransition) -> np.ndarray:
        """Insert a batch with actor-computed initial priorities.

        Overwrites the oldest slots when full (FIFO).  Returns the slot
        indices written.
        """
        priorities = np.asarray(priorities, dtype=np.float64)
        n = priorities.shape[0]
        if n == 0:
            return np.zeros((0,), np.int64)
        if n > self.capacity:
            raise ValueError(f"batch of {n} exceeds capacity {self.capacity}")
        # Per-frame encode work (deflate, for the compressed store) happens
        # OFF the lock, so an actor flush never stalls the learner's sample.
        enc_obs = self._obs.encode(batch.obs)
        enc_next_obs = self._next_obs.encode(batch.next_obs)
        with self._lock:
            idx = (self._cursor + np.arange(n)) % self.capacity
            self._obs.put_encoded(idx, enc_obs)
            self._next_obs.put_encoded(idx, enc_next_obs)
            self._action[idx] = batch.action
            self._reward[idx] = batch.reward
            self._discount[idx] = batch.discount
            self._tree.set(idx, np.power(np.maximum(priorities, 1e-12), self.alpha))
            self._cursor = int((self._cursor + n) % self.capacity)
            self._count += n
            return idx

    # -- read path (learner) ---------------------------------------------

    def _sample_locked(self, batch_size: int, rng: np.random.Generator) -> tuple:
        size = min(self._count, self.capacity)
        if size == 0:
            raise ValueError("cannot sample from an empty replay")
        idx = self._tree.sample_stratified(batch_size, rng)
        transition = NStepTransition(
            obs=self._obs.get(idx),
            action=self._action[idx].copy(),
            reward=self._reward[idx].copy(),
            discount=self._discount[idx].copy(),
            next_obs=self._next_obs.get(idx),
        )
        return transition, idx, self._tree.get(idx), self._tree.total, size

    def sample(
        self,
        batch_size: int,
        beta: float = 0.4,
        rng: Optional[np.random.Generator] = None,
    ) -> PrioritizedBatch:
        """Stratified proportional sample with IS weights, all numpy.

        P(i) = p_i^α / Σ p^α;  w_i = (N · P(i))^−β, normalized by max w,
        cast to float32; indices int32.
        """
        rng = rng or np.random.default_rng()
        with self._lock:
            transition, idx, mass, total, size = self._sample_locked(batch_size, rng)
        probs = mass / total
        weights = np.power(size * np.maximum(probs, 1e-12), -beta)
        weights = (weights / weights.max()).astype(np.float32)
        return PrioritizedBatch(
            transition=transition,
            indices=idx.astype(np.int32),
            is_weights=weights,
        )

    def sample_with_mass(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
    ) -> tuple:
        """(transition, indices, mass, total_mass, size) — the raw
        proportional sample without the IS-weight arithmetic, for callers
        that normalize over several replays."""
        rng = rng or np.random.default_rng()
        with self._lock:
            transition, idx, mass, total, size = self._sample_locked(batch_size, rng)
        return transition, idx.astype(np.int64), mass, float(total), size

    def update_priorities(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        """Learner priority feedback, per transition, O(B log N).  Duplicate
        indices: the last write wins.

        If a sampled slot was recycled between sample and update, the fresh
        transition briefly carries the old transition's updated priority —
        a benign race that the next restamp of that slot corrects.
        """
        indices = np.asarray(indices, dtype=np.int64)
        priorities = np.asarray(priorities, dtype=np.float64)
        if indices.size == 0:
            return
        with self._lock:
            self._tree.set(
                indices, np.power(np.maximum(priorities, 1e-12), self.alpha)
            )
            self._track_dirty_locked(indices)

    def _track_dirty_locked(self, indices: np.ndarray) -> None:
        if self._ckpt is None:
            return
        self._dirty.append(np.array(indices, np.int64, copy=True))
        self._dirty_rows += len(indices)
        if self._dirty_rows > 4 * self.capacity:
            # The sparse record would rival a full snapshot: drop it, and
            # the next delta becomes a base.
            self._dirty, self._dirty_rows, self._ckpt = [], 0, None

    # -- cold tier surface (replay/tiered.py; no-ops when the tier is off) --

    @property
    def tier(self):
        """The obs store's ``TieredFrameRing`` (None when untiered); the
        observability gauges read its counters."""
        return getattr(self._obs, "ring", None)

    def _rings(self) -> tuple:
        ring = getattr(self._obs, "ring", None)
        return () if ring is None else (ring, self._next_obs.ring)

    def tier_over_watermark(self) -> bool:
        """Lock-free evictor poll: a stale read only delays one batch."""
        return any(r.over_high_watermark() for r in self._rings())

    def spill_cold(self, max_spans: int = 0) -> tuple:
        """Evict least-recently-sampled spans in both stores down to their
        low watermarks (``TierEvictor``'s entry point).  Returns (spans,
        bytes written)."""
        rings = self._rings()
        if not rings:
            return 0, 0
        with self._lock:
            out = [r.spill(max_spans=max_spans) for r in rings]
        return sum(s for s, _ in out), sum(b for _, b in out)

    def tier_flush_dirty(self) -> int:
        """Write back every dirty hot span of both stores (residency kept)."""
        rings = self._rings()
        with self._lock:
            return sum(r.flush_dirty() for r in rings)

    def tier_stats(self) -> Optional[dict]:
        """Both stores' tier counters summed (``fault_ms``: the obs store's
        summary, or next_obs's when obs never faulted)."""
        rings = self._rings()
        if not rings:
            return None
        with self._lock:
            a, b = (r.tier_stats() for r in rings)
        out = {}
        for k in a:
            if k == "fault_ms":
                out[k] = a[k] if a[k]["count"] else b[k]
            elif k == "span_frames":
                out[k] = a[k]
            else:
                out[k] = a[k] + b[k]
        return out

    # -- misc ------------------------------------------------------------

    def size(self) -> int:
        """Current number of stored transitions."""
        with self._lock:
            return min(self._count, self.capacity)

    @property
    def total_added(self) -> int:
        return self._count

    def frames_nbytes(self) -> int:
        """Bytes held by frame storage (compressed stores report the
        deflated size)."""
        with self._lock:
            return self._obs.nbytes() + self._next_obs.nbytes()

    def max_priority(self) -> float:
        with self._lock:
            m = self._tree.max_priority()
        return float(m ** (1.0 / self.alpha)) if m > 0 else 1.0

    def digest(self, with_crc: bool = True) -> dict:
        """Content fingerprint: counters, total p^α mass and — with
        ``with_crc`` — a crc32 over every live column, the frames included.
        Two replays with equal digests hold bit-identical sampleable state;
        the crc is the same function as the JAX replay's, so a digest
        compares across the two packages."""
        with self._lock:
            size = min(self._count, self.capacity)
            out = {
                "count": int(self._count),
                "cursor": int(self._cursor),
                "size": int(size),
                "total_mass": float(self._tree.total),
                "crc": 0,
            }
            if not with_crc:
                return out
            idx = np.arange(size)
            c = zlib.crc32(struct.pack("<qq", self._count, self._cursor))
            for arr in (
                self._action[:size], self._reward[:size],
                self._discount[:size], self._tree.get(idx),
                self._obs.get(idx), self._next_obs.get(idx),
            ):
                c = zlib.crc32(np.ascontiguousarray(arr).tobytes(), c)
            out["crc"] = int(c)
            return out

    # -- snapshot ----------------------------------------------------------

    def state_dict(self) -> dict:
        """Snapshot in the JAX replay's layout, so either package loads the
        other's."""
        with self._lock:
            return self._state_dict_locked()

    def _state_dict_locked(self) -> dict:
        size = min(self._count, self.capacity)
        idx = np.arange(size)
        out = {
            "action": self._action[:size].copy(),
            "reward": self._reward[:size].copy(),
            "discount": self._discount[:size].copy(),
            "tree_priorities": self._tree.get(idx),
            "cursor": self._cursor,
            "count": self._count,
        }
        if self._obs.compressed:
            # The deflated slots verbatim: a compressed buffer never
            # materializes its dense form to snapshot.
            out["obs_blob"], out["obs_lens"] = self._obs.export_blobs(size)
            out["next_obs_blob"], out["next_obs_lens"] = (
                self._next_obs.export_blobs(size)
            )
        else:
            out["obs"] = self._obs.get(idx)
            out["next_obs"] = self._next_obs.get(idx)
        return out

    def delta_state_dict(self, force_base: bool = False) -> dict:
        """A full base (first call, forced, or a span of a whole ring) or
        the delta since the previous call: the span written since then and
        the restamped slots' masses, so the bytes follow the interval, not
        the capacity.  Resets the mark."""
        with self._lock:
            n_new = self._count - (self._ckpt[0] if self._ckpt else 0)
            if force_base or self._ckpt is None or n_new >= self.capacity:
                out = self._state_dict_locked()
                out["chain_mark"] = np.asarray([self._count], np.int64)
                self._mark_locked()
                return out
            prev_count, prev_cursor = self._ckpt
            span = (prev_cursor + np.arange(n_new)) % self.capacity
            dirty = self._drain_dirty_locked()
            out = {
                "delta": np.asarray(True),
                "chain_prev": np.asarray([prev_count], np.int64),
                "chain_mark": np.asarray([self._count], np.int64),
                "span_idx": span,
                "span_action": self._action[span].copy(),
                "span_reward": self._reward[span].copy(),
                "span_discount": self._discount[span].copy(),
                "span_tree": self._tree.get(span),
                "prio_idx": dirty,
                "prio_mass": self._tree.get(dirty),
                "cursor": self._cursor,
                "count": self._count,
            }
            if self._obs.compressed:
                out["span_obs_blob"], out["span_obs_lens"] = (
                    self._obs.export_blobs_idx(span))
                out["span_next_obs_blob"], out["span_next_obs_lens"] = (
                    self._next_obs.export_blobs_idx(span))
            else:
                out["span_obs"] = self._obs.get(span)
                out["span_next_obs"] = self._next_obs.get(span)
            self._mark_locked()
            return out

    def _mark_locked(self) -> None:
        self._ckpt = (self._count, self._cursor)
        self._dirty, self._dirty_rows = [], 0

    def _drain_dirty_locked(self) -> np.ndarray:
        if not self._dirty:
            return np.zeros((0,), np.int64)
        idx = np.unique(np.concatenate(self._dirty))
        return idx[(idx >= 0) & (idx < self.capacity)]

    def apply_delta_state_dict(self, delta: dict) -> None:
        """Apply one delta onto the current counters; a delta that does not
        continue them raises instead of composing."""
        with self._lock:
            if "delta" not in delta:
                raise ValueError("not a delta snapshot (missing 'delta' key)")
            prev = int(np.asarray(delta["chain_prev"]).reshape(-1)[0])
            if prev != self._count:
                raise ValueError(f"delta chain discontinuity: delta continues count "
                                 f"{prev}, replay is at {self._count}")
            span = np.asarray(delta["span_idx"], np.int64)
            if "span_obs_blob" in delta:
                if not self._obs.compressed:
                    raise ValueError("compressed-span delta into a raw frame store — "
                                     "replay.frame_compression must match across resume")
                self._obs.import_blobs_idx(span, delta["span_obs_blob"],
                                           delta["span_obs_lens"])
                self._next_obs.import_blobs_idx(span, delta["span_next_obs_blob"],
                                                delta["span_next_obs_lens"])
            else:
                if self._obs.compressed:
                    raise ValueError("raw-span delta into a compressed frame store — "
                                     "replay.frame_compression must match across resume")
                self._obs.put(span, delta["span_obs"])
                self._next_obs.put(span, delta["span_next_obs"])
            self._action[span] = delta["span_action"]
            self._reward[span] = delta["span_reward"]
            self._discount[span] = delta["span_discount"]
            self._tree.set(span, np.asarray(delta["span_tree"], np.float64))
            prio_idx = np.asarray(delta["prio_idx"], np.int64)
            if prio_idx.size:
                self._tree.set(prio_idx, np.asarray(delta["prio_mass"], np.float64))
            self._cursor = int(delta["cursor"]) % self.capacity
            self._count = int(delta["count"])
            self._mark_locked()

    def load_state_dict(self, state: dict) -> None:
        compressed_snap = "obs_blob" in state
        with self._lock:
            size = (
                state["obs_lens"].shape[0] if compressed_snap
                else state["obs"].shape[0]
            )
            if size > self.capacity:
                raise ValueError("snapshot larger than capacity")
            # Clear everything first so a restore into a warm buffer cannot
            # leave stale transitions sampleable past the snapshot region.
            self._tree.set(
                np.arange(self.capacity), np.zeros(self.capacity, np.float64)
            )
            rng = np.arange(size)
            if compressed_snap and self._obs.compressed:
                self._obs.import_blobs(state["obs_blob"], state["obs_lens"])
                self._next_obs.import_blobs(
                    state["next_obs_blob"], state["next_obs_lens"]
                )
            elif compressed_snap:
                # Compressed snapshot into a raw store: inflate through a
                # scratch compressed view.
                tmp = CompressedFrameStore(size, self._obs.shape)
                tmp.import_blobs(state["obs_blob"], state["obs_lens"])
                self._obs.put(rng, tmp.get(rng))
                tmp.import_blobs(state["next_obs_blob"], state["next_obs_lens"])
                self._next_obs.put(rng, tmp.get(rng))
            else:
                self._obs.put(rng, state["obs"])
                self._next_obs.put(rng, state["next_obs"])
            self._action[:size] = state["action"]
            self._reward[:size] = state["reward"]
            self._discount[:size] = state["discount"]
            self._tree.set(np.arange(size), state["tree_priorities"])
            self._cursor = int(state["cursor"]) % self.capacity
            self._count = int(state["count"])
            # A full load ends dirty tracking: the next incremental save is
            # a base unless deltas follow (their apply re-marks).
            self._ckpt, self._dirty, self._dirty_rows = None, [], 0
