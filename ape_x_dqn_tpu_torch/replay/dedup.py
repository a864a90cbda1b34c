"""Frame-dedup prioritized replay on the host: each frame stored ONCE.

Port of ``ape_x_dqn_tpu/replay/dedup.py``: ``CarryResolver`` (:48-104) and
``DedupReplay`` (:107-682).  ``PrioritizedReplay`` (``buffer.py``) stores
full ``obs`` AND ``next_obs`` arrays: 28 GB of frames for config3's 2M
slots.  This replay stores a single FRAME RING plus per-transition frame
references (``types.DedupChunk``, produced by ``ActorFleet(emit_dedup=True)``
and the process workers under ``replay.dedup``):

  * **frame ring** — ``frame_capacity ≈ frame_ratio × capacity`` unique
    observations addressed by a monotone int64 sequence number (slot =
    seq % Cf).  Steady-state arrival is ~1 frame per transition, so the
    default ``frame_ratio=1.25`` leaves slack for truncation extras and
    source interleaving while cutting storage ~1.6×.
  * **transition ring** — (obs_seq, next_seq, action, reward, discount)
    per slot, FIFO like the double-store, over the same sum-tree.
  * **invalidation sweep** — when new frames overwrite ring slots, any
    transition whose ``obs_seq`` fell out of the live window gets priority
    0, so a sampled transition's frames are ALWAYS its own.
    ``update_priorities`` applies the same liveness guard, so a deferred
    restamp cannot resurrect a frame-dead slot.

The sampling law, IS weights and FIFO semantics are
``PrioritizedReplay``'s (float64 masses, targets from the caller's numpy
generator), so the same adds and the same generator draw the same slots as
the JAX package's replay.  With ``hot_frame_budget_bytes > 0`` the frame
ring is a ``replay/tiered.TieredFrameRing`` (hot spans over a spill file);
snapshots and the incremental delta protocol keep the JAX replay's keys and
dtypes, the cold-ref base (``tier_cold_*``) included, so a chain written by
either package restores in the other.  The C++ twin is
``native_dedup.NativeDedupReplay``; this numpy replay is its oracle.  The
device ring (``device_dedup.py``, driven by ``runtime/fused_dedup.py``)
shares ``CarryResolver``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition, PrioritizedBatch


class CarryResolver:
    """Per-source (chunk_seq, frame base, U) records; ``resolve`` turns a
    chunk's relative refs into absolute frame seqs.  Past ``max_sources``
    records the oldest half (by frame base) is evicted."""

    def __init__(self, max_sources: int = 4096):
        self.sources: dict = {}   # source -> (chunk_seq, frame_base, U)
        self.dropped_carry = 0
        self._max_sources = int(max_sources)

    def resolve(self, chunk: DedupChunk, base: int):
        """``(obs_seq int64 [M], next_seq int64 [M], keep bool [M])``.
        ``base`` is the consumer's frame count where this chunk's frames
        will land.  Updates the source's record."""
        prev = self.sources.get(chunk.source)
        contiguous = (
            prev is not None
            and chunk.chunk_seq == prev[0] + 1
            and chunk.prev_frames == prev[2]
        )
        obs_ref = np.asarray(chunk.obs_ref)
        obs_seq = base + obs_ref.astype(np.int64)
        next_seq = base + np.asarray(chunk.next_ref, np.int64)
        neg = obs_ref < 0
        keep = np.ones(len(obs_seq), bool)
        if neg.any():
            if contiguous:
                obs_seq[neg] = prev[1] + prev[2] + obs_ref[neg]
            else:
                keep = ~neg
                self.dropped_carry += int(neg.sum())
        self.sources[chunk.source] = (chunk.chunk_seq, base, chunk.frames.shape[0])
        if len(self.sources) > self._max_sources:
            oldest = sorted(self.sources, key=lambda s: self.sources[s][1])
            for key in oldest[: len(self.sources) // 2]:
                del self.sources[key]
        return obs_seq, next_seq, keep

    def state_arrays(self):
        """(source ids int64 [S], records int64 [S, 3]) — the snapshot form
        (JAX :92-104)."""
        src = self.sources
        return (np.array(list(src.keys()), np.int64),
                np.array([list(v) for v in src.values()], np.int64).reshape(len(src), 3))

    def load_state_arrays(self, ids, rows) -> None:
        self.sources = {int(s): tuple(int(x) for x in row) for s, row in zip(ids, rows)}


class DedupReplay:
    """Prioritized n-step transition store over a shared frame ring.

    Args mirror ``PrioritizedReplay`` plus:
      frame_ratio: frame-ring slots per transition slot.  Must cover the
        actual frame/transition arrival ratio (≈ (flush_every + n_step) /
        flush_every for overlapping emission, + truncation extras) or the
        frame ring wraps early and the oldest transitions are invalidated
        before their FIFO death — gracefully (they become unsampleable),
        but effective capacity shrinks.  ``stats["frame_dead"]`` counts
        those; size the ratio so it stays ~0.
    """

    def __init__(
        self,
        capacity: int,
        obs_shape,
        priority_exponent: float = 0.6,
        obs_dtype=np.uint8,
        sum_tree_cls=None,
        frame_ratio: float = 1.25,
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
        if frame_ratio <= 0:
            raise ValueError("frame_ratio must be positive")
        self.capacity = int(capacity)
        self.frame_capacity = max(1, int(round(capacity * frame_ratio)))
        self.alpha = float(priority_exponent)
        # Tiered frame store (replay/tiered.py): a positive hot budget
        # replaces the dense frame ring with a hot span cache over a
        # CRC-framed cold spill file.  Only the frame BYTES tier — the
        # sum-tree, liveness, and every transition column stay hot, so
        # the sampling law and update_priorities are untouched.  Off
        # (the default) this branch allocates the dense ndarray exactly
        # as before: zero cost when disabled.
        self._tier = None
        if hot_frame_budget_bytes > 0:
            import os

            from ape_x_dqn_tpu_torch.replay.tiered import TieredFrameRing

            if spill_dir is None:
                raise ValueError("tiered replay needs a spill_dir")
            self._tier = TieredFrameRing(
                self.frame_capacity, obs_shape, dtype=obs_dtype,
                hot_budget_bytes=hot_frame_budget_bytes,
                spill_path=os.path.join(spill_dir, "frames.cold"),
                span_frames=spill_span_frames,
                watermark_high=spill_watermark_high,
                watermark_low=spill_watermark_low,
            )
            self._frames = None
        else:
            self._frames = np.zeros(
                (self.frame_capacity, *obs_shape), obs_dtype
            )
        self._obs_seq = np.zeros((capacity,), np.int64)
        self._next_seq = np.zeros((capacity,), np.int64)
        self._action = np.zeros((capacity,), np.int32)
        self._reward = np.zeros((capacity,), np.float32)
        self._discount = np.zeros((capacity,), np.float32)
        self._alive = np.zeros((capacity,), bool)
        self._tree = sum_tree_cls(capacity)
        self._cursor = 0
        self._count = 0          # transitions ever accepted
        self._fcount = 0         # frames ever written (monotone seq)
        self._resolver = CarryResolver()
        self._frame_dead = 0
        self._lock = threading.Lock()
        # Incremental-checkpoint dirty tracking (utils/checkpoint_inc):
        # (count, cursor, fcount) at the last delta snapshot + the sparse
        # indices restamped/swept since.  None = next snapshot is a base.
        self._ckpt = None
        self._dirty: list = []
        self._dirty_rows = 0

    # -- write path (actors / drain) ------------------------------------

    def add(self, priorities: np.ndarray, chunk: DedupChunk) -> np.ndarray:
        """Ingest one dedup chunk; returns the transition slots written.

        Carry refs resolve against this source's previous chunk; a
        ``chunk_seq`` gap or frame-count mismatch (dropped chunk, worker
        respawn without a bootstrap) drops just the carried rows, counted
        in ``stats["dropped_carry"]``.
        """
        priorities = np.asarray(priorities, dtype=np.float64)
        U = chunk.frames.shape[0]
        M = priorities.shape[0]
        if M != chunk.action.shape[0]:
            raise ValueError("priorities/chunk length mismatch")
        if M > self.capacity:
            raise ValueError(f"chunk of {M} exceeds capacity {self.capacity}")
        if U > self.frame_capacity:
            raise ValueError(
                f"chunk of {U} frames exceeds frame ring {self.frame_capacity}"
            )
        with self._lock:
            base = self._fcount
            obs_seq, next_seq, keep = self._resolver.resolve(chunk, base)
            # Frames land regardless of dropped rows (the NEXT chunk's
            # carry refs point into them).
            if self._tier is not None:
                self._tier.put_span(base % self.frame_capacity, U,
                                    chunk.frames)
            else:
                fidx = (base + np.arange(U)) % self.frame_capacity
                self._frames[fidx] = chunk.frames
            self._fcount = base + U
            m = int(keep.sum())
            idx = np.zeros(0, np.int64)
            if m:
                idx = (self._cursor + np.arange(m)) % self.capacity
                self._obs_seq[idx] = obs_seq[keep]
                self._next_seq[idx] = next_seq[keep]
                self._action[idx] = chunk.action[keep]
                self._reward[idx] = chunk.reward[keep]
                self._discount[idx] = chunk.discount[keep]
                self._alive[idx] = True
                self._tree.set(
                    idx,
                    np.power(np.maximum(priorities[keep], 1e-12), self.alpha),
                )
                self._cursor = int((self._cursor + m) % self.capacity)
                self._count += m
            self._sweep_locked()
            return idx

    def _sweep_locked(self) -> None:
        """Zero the priority of transitions whose obs frame was overwritten
        (obs_seq is each row's OLDEST ref — the DedupChunk layout contract)."""
        fmin = self._fcount - self.frame_capacity
        if fmin <= 0:
            return
        dead = self._alive & (self._obs_seq < fmin)
        if dead.any():
            di = np.nonzero(dead)[0]
            self._tree.set(di, np.zeros(len(di)))
            self._alive[di] = False
            self._frame_dead += len(di)
            self._track_dirty_locked(di)

    def _track_dirty_locked(self, indices: np.ndarray) -> None:
        if self._ckpt is None:
            return
        self._dirty.append(np.array(indices, np.int64, copy=True))
        self._dirty_rows += len(indices)
        if self._dirty_rows > 4 * self.capacity:
            # Overflow guard: sparse record rivals a base — retrack.
            self._dirty, self._dirty_rows, self._ckpt = [], 0, None

    def _fgather(self, seqs: np.ndarray) -> np.ndarray:
        """Frame gather by sequence number — the ONE indirection the tier
        adds to the sample path (cold spans fault here)."""
        slots = np.asarray(seqs, np.int64) % self.frame_capacity
        if self._tier is not None:
            return self._tier.get(slots)
        return self._frames[slots]

    # -- cold tier surface (replay/tiered.py; no-ops when tier is off) ---

    @property
    def tier(self):
        return self._tier

    def tier_over_watermark(self) -> bool:
        """Lock-free evictor poll: a stale read only delays one batch."""
        return self._tier is not None and self._tier.over_high_watermark()

    def spill_cold(self, max_spans: int = 0, target_bytes=None) -> tuple:
        """Evict least-recently-sampled spans down to the low watermark
        (TierEvictor's entry point — one bounded batch per lock hold).
        ``target_bytes`` overrides the watermark (0 = spill everything —
        bench/drain tooling)."""
        if self._tier is None:
            return 0, 0
        with self._lock:
            return self._tier.spill(max_spans=max_spans,
                                    target_bytes=target_bytes)

    def tier_flush_dirty(self) -> int:
        """Write-back every dirty hot span's cold record (residency kept)
        under the replay lock — pre-trim/pre-bench hygiene."""
        if self._tier is None:
            return 0
        with self._lock:
            return self._tier.flush_dirty()

    def tier_stats(self) -> Optional[dict]:
        if self._tier is None:
            return None
        with self._lock:
            return self._tier.tier_stats()

    # -- read path (learner) --------------------------------------------

    def sample(
        self,
        batch_size: int,
        beta: float = 0.4,
        rng: Optional[np.random.Generator] = None,
    ) -> PrioritizedBatch:
        """Stratified proportional sample with IS weights — the law and
        weight math of ``PrioritizedReplay.sample`` verbatim; only the
        frame gather goes through the ref indirection."""
        rng = rng or np.random.default_rng()
        with self._lock:
            size = min(self._count, self.capacity)
            if size == 0:
                raise ValueError("cannot sample from an empty replay")
            idx = self._tree.sample_stratified(batch_size, rng)
            mass = self._tree.get(idx)
            total = self._tree.total
            transition = NStepTransition(
                obs=self._fgather(self._obs_seq[idx]),
                action=self._action[idx].copy(),
                reward=self._reward[idx].copy(),
                discount=self._discount[idx].copy(),
                next_obs=self._fgather(self._next_seq[idx]),
            )
        probs = mass / total
        weights = np.power(size * np.maximum(probs, 1e-12), -beta)
        weights = (weights / weights.max()).astype(np.float32)
        return PrioritizedBatch(
            transition=transition,
            indices=idx.astype(np.int32),
            is_weights=weights,
        )

    def update_priorities(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        """Learner priority feedback, with the liveness guard: a restamp
        must not resurrect a frame-dead slot (its frames belong to newer
        transitions now — sampling it would pair stale metadata with
        recycled pixels).  Slot-recycled-by-a-newer-transition keeps the
        double-store's benign self-correcting race."""
        indices = np.asarray(indices, dtype=np.int64)
        priorities = np.asarray(priorities, dtype=np.float64)
        if indices.size == 0:
            return
        with self._lock:
            fmin = self._fcount - self.frame_capacity
            live = self._alive[indices] & (self._obs_seq[indices] >= fmin)
            if live.any():
                self._tree.set(
                    indices[live],
                    np.power(
                        np.maximum(priorities[live], 1e-12), self.alpha
                    ),
                )
                self._track_dirty_locked(indices[live])

    # -- misc ------------------------------------------------------------

    @property
    def stats(self) -> dict:
        return {
            "frame_dead": self._frame_dead,
            "dropped_carry": self._resolver.dropped_carry,
        }

    def size(self) -> int:
        with self._lock:
            return min(self._count, self.capacity)

    @property
    def total_added(self) -> int:
        return self._count

    def frames_nbytes(self) -> int:
        """Bytes held by frame storage in DRAM — the dedup win's observable
        (compare: the double-store's 2 × capacity × frame_bytes).  Tiered,
        this is the HOT bytes only — the number the hot budget caps."""
        if self._tier is not None:
            with self._lock:
                return self._tier.hot_bytes
        return self._frames.nbytes

    def max_priority(self) -> float:
        with self._lock:
            m = self._tree.max_priority()
        return float(m ** (1.0 / self.alpha)) if m > 0 else 1.0

    # -- snapshot (checkpointing) ----------------------------------------

    def state_dict(self) -> dict:
        with self._lock:
            return self._state_dict_locked()

    def _state_dict_locked(self, cold_refs: bool = False) -> dict:
        size = min(self._count, self.capacity)
        idx = np.arange(size)
        nf = min(self._fcount, self.frame_capacity)
        src_ids, src_state = self._resolver.state_arrays()
        out = {
            "dedup": np.asarray(True),
            "frames": None,  # filled below (dense or tier cold refs)
            "obs_seq": self._obs_seq[:size].copy(),
            "next_seq": self._next_seq[:size].copy(),
            "action": self._action[:size].copy(),
            "reward": self._reward[:size].copy(),
            "discount": self._discount[:size].copy(),
            "alive": self._alive[:size].copy(),
            "tree_priorities": self._tree.get(idx),
            "cursor": self._cursor,
            "count": self._count,
            "fcount": self._fcount,
            "frame_dead": self._frame_dead,
            "dropped_carry": self._resolver.dropped_carry,
            "frame_capacity": self.frame_capacity,
            "src_ids": src_ids,
            "src_state": src_state,
        }
        # Frame leg.  Dense (or tier-but-nothing-cold): the legacy "frames"
        # array.  cold_refs=True with cold spans: the tiered base format —
        # hot frames inline, cold spans referenced by (offset, len, crc)
        # into the spill file instead of being paged back in (the
        # checkpoint_inc "mostly-cold base must not re-read the cold
        # tier" contract).  state_dict() keeps cold_refs=False: the
        # public full snapshot always materializes (oracle comparisons,
        # legacy npz path).
        refs = None
        if cold_refs and self._tier is not None:
            refs = self._tier.cold_refs(nf)
        if refs is not None:
            del out["frames"]
            out.update(refs)
        elif self._tier is not None:
            out["frames"] = self._tier.get_span(0, nf)
        else:
            out["frames"] = self._frames[:nf].copy()
        return out

    # -- incremental snapshot (utils/checkpoint_inc delta protocol) -------

    def delta_state_dict(self, force_base: bool = False) -> dict:
        """Base or dirty-span delta since the last snapshot.  The frame
        ring and transition ring write sequentially at cursors, so the
        delta is the two spans written since the mark plus the sparse
        restamped/swept priorities — bytes ∝ checkpoint interval, not the
        17.6 GB ring (the whole point; see checkpoint_inc)."""
        with self._lock:
            prev = self._ckpt
            n_new = self._count - (prev[0] if prev else 0)
            f_new = self._fcount - (prev[2] if prev else 0)
            if (force_base or prev is None or n_new >= self.capacity
                    or f_new >= self.frame_capacity):
                # Base snapshots reference cold spans by offset (tiered) —
                # a mostly-cold ring must not be paged back in to save.
                out = self._state_dict_locked(cold_refs=True)
                out["chain_mark"] = np.asarray(
                    [self._count, self._fcount], np.int64
                )
                self._mark_locked()
                return out
            prev_count, prev_cursor, prev_fcount = prev
            span = (prev_cursor + np.arange(n_new)) % self.capacity
            fspan = (prev_fcount + np.arange(f_new)) % self.frame_capacity
            dirty = self._drain_dirty_locked()
            src_ids, src_state = self._resolver.state_arrays()
            out = {
                "delta": np.asarray(True),
                "dedup": np.asarray(True),
                "chain_prev": np.asarray([prev_count, prev_fcount], np.int64),
                "chain_mark": np.asarray(
                    [self._count, self._fcount], np.int64
                ),
                "span_idx": span,
                "span_obs_seq": self._obs_seq[span].copy(),
                "span_next_seq": self._next_seq[span].copy(),
                "span_action": self._action[span].copy(),
                "span_reward": self._reward[span].copy(),
                "span_discount": self._discount[span].copy(),
                "span_alive": self._alive[span].copy(),
                "span_tree": self._tree.get(span),
                "fspan_idx": fspan,
                "fspan_frames": (
                    self._tier.get_span(
                        prev_fcount % self.frame_capacity, f_new
                    )
                    if self._tier is not None
                    else self._frames[fspan].copy()
                ),
                "prio_idx": dirty,
                "prio_mass": self._tree.get(dirty),
                "prio_alive": self._alive[dirty].copy(),
                "cursor": self._cursor,
                "count": self._count,
                "fcount": self._fcount,
                "frame_dead": self._frame_dead,
                "dropped_carry": self._resolver.dropped_carry,
                "frame_capacity": self.frame_capacity,
                "src_ids": src_ids,
                "src_state": src_state,
            }
            self._mark_locked()
            return out

    def _mark_locked(self) -> None:
        self._ckpt = (self._count, self._cursor, self._fcount)
        self._dirty, self._dirty_rows = [], 0

    def _drain_dirty_locked(self) -> np.ndarray:
        if not self._dirty:
            return np.zeros((0,), np.int64)
        idx = np.unique(np.concatenate(self._dirty))
        return idx[(idx >= 0) & (idx < self.capacity)]

    def apply_delta_state_dict(self, delta: dict) -> None:
        """Restore-side replay of one delta; chain discontinuities raise."""
        with self._lock:
            if "delta" not in delta:
                raise ValueError("not a delta snapshot (missing 'delta' key)")
            if int(delta["frame_capacity"]) != self.frame_capacity:
                raise ValueError(
                    f"delta frame ring {int(delta['frame_capacity'])} != "
                    f"configured {self.frame_capacity}"
                )
            prev = np.asarray(delta["chain_prev"]).reshape(-1)
            if int(prev[0]) != self._count or int(prev[1]) != self._fcount:
                raise ValueError(
                    f"delta chain discontinuity: delta continues "
                    f"(count, fcount)=({int(prev[0])}, {int(prev[1])}), "
                    f"replay is at ({self._count}, {self._fcount})"
                )
            span = np.asarray(delta["span_idx"], np.int64)
            fspan = np.asarray(delta["fspan_idx"], np.int64)
            if self._tier is not None:
                if fspan.size:
                    self._tier.put_span(int(fspan[0]), fspan.size,
                                        delta["fspan_frames"])
            else:
                self._frames[fspan] = delta["fspan_frames"]
            self._obs_seq[span] = delta["span_obs_seq"]
            self._next_seq[span] = delta["span_next_seq"]
            self._action[span] = delta["span_action"]
            self._reward[span] = delta["span_reward"]
            self._discount[span] = delta["span_discount"]
            self._alive[span] = np.asarray(delta["span_alive"], bool)
            self._tree.set(span, np.asarray(delta["span_tree"], np.float64))
            prio_idx = np.asarray(delta["prio_idx"], np.int64)
            if prio_idx.size:
                self._tree.set(
                    prio_idx, np.asarray(delta["prio_mass"], np.float64)
                )
                self._alive[prio_idx] = np.asarray(delta["prio_alive"], bool)
            self._cursor = int(delta["cursor"]) % self.capacity
            self._count = int(delta["count"])
            self._fcount = int(delta["fcount"])
            self._frame_dead = int(delta["frame_dead"])
            self._resolver.dropped_carry = int(delta["dropped_carry"])
            self._resolver.load_state_arrays(
                delta["src_ids"], delta["src_state"]
            )
            self._mark_locked()

    def load_state_dict(self, state: dict) -> None:
        if "dedup" not in state:
            raise ValueError(
                "snapshot is not a dedup-replay snapshot (double-store "
                "snapshots don't carry frame refs; re-collect instead)"
            )
        if int(state["frame_capacity"]) != self.frame_capacity:
            raise ValueError(
                f"snapshot frame ring {int(state['frame_capacity'])} != "
                f"configured {self.frame_capacity} — frame slots are "
                "addressed seq % capacity, so the layout must match"
            )
        with self._lock:
            size = state["obs_seq"].shape[0]
            if size > self.capacity:
                raise ValueError("snapshot larger than capacity")
            self._tree.set(
                np.arange(self.capacity), np.zeros(self.capacity)
            )
            self._alive[:] = False
            self._fcount = int(state["fcount"])
            nf = min(self._fcount, self.frame_capacity)
            # Snapshot frames are SLOT-ordered [0, nf): identity placement
            # (seq % capacity addressing is stable across save/restore
            # because frame_capacity is layout-checked above).
            self._load_frames_locked(state, nf)
            rng = np.arange(size)
            self._obs_seq[:size] = state["obs_seq"]
            self._next_seq[:size] = state["next_seq"]
            self._action[:size] = state["action"]
            self._reward[:size] = state["reward"]
            self._discount[:size] = state["discount"]
            self._alive[:size] = state["alive"]
            self._tree.set(rng, state["tree_priorities"])
            self._cursor = int(state["cursor"]) % self.capacity
            self._count = int(state["count"])
            # dropped_carry/frame_dead accounting survives resume (absent
            # in pre-incremental snapshots — degrade to 0, not a crash).
            self._frame_dead = int(state.get("frame_dead", 0))
            self._resolver.dropped_carry = int(state.get("dropped_carry", 0))
            self._resolver.load_state_arrays(
                state["src_ids"], state["src_state"]
            )
            self._ckpt, self._dirty, self._dirty_rows = None, [], 0

    def _load_frames_locked(self, state: dict, nf: int) -> None:
        """Frame leg of a full restore: dense snapshots land as before;
        tiered (cold-ref) bases either ADOPT the spill file in place —
        verify each referenced record, O(hot bytes) restored — or
        materialize through ``read_cold_refs_dense`` when this replay
        has no compatible tier.  Either way every cold byte is CRC- and
        content-verified; a torn record raises the typed
        ``ColdSpanCorrupt`` the checkpoint fallback walk consumes."""
        if "tier_hot_sids" not in state:
            if self._tier is not None:
                self._tier.drop_all()
                self._tier.put_span(0, nf, state["frames"][:nf])
            else:
                self._frames[:nf] = state["frames"][:nf]
            return
        from ape_x_dqn_tpu_torch.replay.tiered import (
            ColdSpanStore,
            read_cold_refs_dense,
        )

        span_frames = int(
            np.asarray(state["tier_span_frames"]).reshape(-1)[0]
        )
        tier_cap = int(np.asarray(state["tier_capacity"]).reshape(-1)[0])
        if (self._tier is None
                or self._tier.span_frames != span_frames
                or self._tier.capacity != tier_cap):
            dense = read_cold_refs_dense(state)
            if self._tier is not None:
                self._tier.drop_all()
                self._tier.put_span(0, nf, dense[:nf])
            else:
                self._frames[:nf] = dense[:nf]
            return
        tier = self._tier
        tier.drop_all()
        path = bytes(
            np.asarray(state["tier_spill_path"], np.uint8)
        ).decode()
        import os

        same = (os.path.realpath(path)
                == os.path.realpath(tier.store.path))
        src = tier.store if same else ColdSpanStore(
            path, tier.n_spans, tier.span_bytes
        )
        try:
            hot_sids = np.asarray(state["tier_hot_sids"], np.int64)
            hot_frames = np.asarray(state["tier_hot_frames"])
            off = 0
            for sid in hot_sids:
                n = tier._span_len(int(sid))
                tier.put_span(int(sid) * span_frames, n,
                              hot_frames[off:off + n])
                off += n
            for sid, offset, length, crc in zip(
                np.asarray(state["tier_cold_sids"], np.int64),
                np.asarray(state["tier_cold_offsets"], np.int64),
                np.asarray(state["tier_cold_lens"], np.int64),
                np.asarray(state["tier_cold_crcs"], np.int64),
            ):
                tier.adopt_cold_ref(int(sid), int(offset), int(length),
                                    int(crc), src)
        finally:
            if not same:
                src.close()
