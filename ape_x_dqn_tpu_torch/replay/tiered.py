"""Two-tier frame store: hot DRAM span cache over a CRC-framed cold file.

Port of ``ape_x_dqn_tpu/replay/tiered.py``.  The 2M-slot dedup ring holds
17.64 GB of frames in one host's DRAM; this module caps the resident frame
bytes and keeps the rest in a spill file, the way external replay services
decouple replay capacity from learner memory:

  * **Spans** — the frame ring's slots are grouped into fixed spans of
    ``span_frames`` consecutive slots (~64 KiB by default), the unit of
    eviction and fault.
  * **Hot tier** — resident spans; DRAM held is ``resident spans ×
    span_bytes``.  Priority mass, the sum-tree and every transition column
    stay hot in the owning replay: the sampling law and
    ``update_priorities`` are untouched (only the frame *bytes* move).
  * **Cold tier** — one sparse file of fixed record slots, TWO per span
    (A/B), each record CRC-framed: ``APXS`` | u32 version | u64 span id |
    u64 payload length | u32 crc32, byte for byte the JAX package's, so a
    record written by either package reads in the other.  A SIGKILL
    mid-spill leaves a torn record that fails its CRC and is *detected*,
    never sampled (``ColdSpanCorrupt``).  The slot a checkpoint base
    references is PINNED at ``cold_refs()`` time: later spills write only
    the other slot, so the committed refs stay readable however often a
    span churns before the next base.
  * **Eviction** — least-recently-*sampled* first, down to a low watermark
    once the hot tier crosses the high one; a clean span (disk copy
    current) just drops.  The owning replay exposes ``spill_cold()`` and a
    ``TierEvictor`` thread calls it off the learner's critical path.
  * **Checkpoint refs** — ``cold_refs()`` describes every cold span as
    (span id, file offset, length, crc): an incremental base of a mostly
    cold replay embeds its *hot* frames and references the cold ones by
    offset instead of reading them back (``utils/checkpoint_inc``).
    Restore verifies each referenced record's CRC and its content CRC
    against the snapshot-time value; a mismatch is a typed
    ``ColdSpanCorrupt`` (a ``ChunkCorrupt``), which the checkpoint
    fallback walk treats like any bad chunk.

``TieredFrameRing`` owns its hot blocks (the numpy ``DedupReplay`` and the
tiered double-store); ``SpanTierIndex`` drives the native core's
address-stable mmap through callables (``NativeDedupReplay``).  No torch,
no jax.  All methods run under the owning replay's lock; the classes add
no locking of their own.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

# Stdlib + numpy + the port's torch-free checkpoint and metrics modules:
# kill-test children and restore tooling import this for free.
from ape_x_dqn_tpu_torch.utils.checkpoint_inc import ChunkCorrupt
from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

_REC_MAGIC = b"APXS"
_REC_VERSION = 1
# magic 4s | u32 version | u64 span_id | u64 payload_len | u32 crc32(payload)
_REC_HDR = struct.Struct("<4sIQQI")

# Auto span sizing targets ~64 KiB payloads: big enough that record framing
# and python dispatch amortize, small enough that one 32-row sample batch
# faults at most a few MB.
_AUTO_SPAN_BYTES = 64 << 10


class ColdSpanCorrupt(ChunkCorrupt):
    """A cold span record failed its CRC / framing check (torn spill,
    bit rot, or a ref whose record was since rewritten past the A/B
    retention).  Subclasses ``ChunkCorrupt`` so the incremental-restore
    fallback walk (utils/checkpoint_inc) treats a bad cold ref exactly
    like a bad chunk file: walk back a rung or surface typed — never
    return recycled pixels as replay data."""

    def __init__(self, message: str, path: Optional[str] = None,
                 span: Optional[int] = None):
        super().__init__(message, path=path, generation=None, index=span)
        self.span = span


def auto_span_frames(frame_bytes: int) -> int:
    return max(1, _AUTO_SPAN_BYTES // max(1, int(frame_bytes)))


class ColdSpanStore:
    """The spill file: ``2 × n_spans`` fixed record slots (A/B per span),
    sparse until written.  Records are self-framed (header + CRC) so a
    torn write is detectable in isolation; readers address records by
    byte offset, which is what checkpoint cold refs carry."""

    def __init__(self, path: str, n_spans: int, max_payload: int):
        self.path = str(path)
        self.n_spans = int(n_spans)
        self.max_payload = int(max_payload)
        self.record_size = _REC_HDR.size + self.max_payload
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        # Sparse preallocation: disk blocks materialize per spilled span.
        # Grow-only — a reader opened with a smaller layout (restore
        # tooling addressing records by explicit offset) must never
        # truncate a live spill file.
        need = 2 * self.n_spans * self.record_size
        if os.fstat(self._fd).st_size < need:
            os.ftruncate(self._fd, need)

    def offset(self, sid: int, ab: int) -> int:
        return (2 * int(sid) + (int(ab) & 1)) * self.record_size

    def write(self, sid: int, ab: int, payload: bytes) -> tuple:
        """pwrite one record; returns (offset, crc32).  No fsync here —
        durability is only needed once a checkpoint references the
        record, and ``sync()`` covers that boundary."""
        if len(payload) > self.max_payload:
            raise ValueError("span payload exceeds record slot")
        crc = zlib.crc32(payload)
        hdr = _REC_HDR.pack(_REC_MAGIC, _REC_VERSION, int(sid),
                            len(payload), crc)
        off = self.offset(sid, ab)
        os.pwrite(self._fd, hdr + payload, off)
        return off, crc

    def read(self, offset: int, sid: Optional[int] = None,
             want_crc: Optional[int] = None) -> bytes:
        """Read + verify one record at ``offset``.  Raises
        ``ColdSpanCorrupt`` on any framing/CRC failure, on a span-id
        mismatch, and — when ``want_crc`` is given (checkpoint refs) —
        on content drift since the ref was taken."""
        hdr = os.pread(self._fd, _REC_HDR.size, int(offset))
        if len(hdr) < _REC_HDR.size:
            raise ColdSpanCorrupt(
                f"{self.path}@{offset}: truncated record header",
                path=self.path, span=sid,
            )
        magic, version, rec_sid, plen, crc = _REC_HDR.unpack(hdr)
        if magic != _REC_MAGIC or version != _REC_VERSION:
            raise ColdSpanCorrupt(
                f"{self.path}@{offset}: bad record magic/version "
                f"(never spilled, or torn)", path=self.path, span=sid,
            )
        if sid is not None and rec_sid != int(sid):
            raise ColdSpanCorrupt(
                f"{self.path}@{offset}: record is span {rec_sid}, "
                f"expected {sid}", path=self.path, span=sid,
            )
        if plen > self.max_payload:
            raise ColdSpanCorrupt(
                f"{self.path}@{offset}: payload length {plen} exceeds "
                f"record slot", path=self.path, span=sid,
            )
        payload = os.pread(self._fd, int(plen), int(offset) + _REC_HDR.size)
        if len(payload) != plen or zlib.crc32(payload) != crc:
            raise ColdSpanCorrupt(
                f"{self.path}@{offset}: crc mismatch (torn or corrupt "
                f"cold span)", path=self.path, span=sid,
            )
        if want_crc is not None and crc != int(want_crc):
            raise ColdSpanCorrupt(
                f"{self.path}@{offset}: span {rec_sid} content changed "
                f"since the checkpoint referenced it (crc {crc} != "
                f"{int(want_crc)})", path=self.path, span=sid,
            )
        return payload

    @property
    def fd(self) -> int:
        """The raw descriptor — the native core's batched fault path
        (rc_fault_batch) preads records directly from it."""
        return self._fd

    def sync(self) -> None:
        os.fsync(self._fd)

    def close(self, unlink: bool = False) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            finally:
                self._fd = None
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __del__(self):
        try:
            if getattr(self, "_fd", None) is not None:
                os.close(self._fd)
                self._fd = None
        except OSError:
            pass


class TieredFrameRing:
    """Hot span cache + cold store presenting flat frame-slot addressing.

    Drop-in for the dense ``(capacity, *frame_shape)`` ndarray the host
    replays index: ``get``/``put`` take arbitrary slot indices,
    ``get_span``/``put_span`` take wrap-aware contiguous runs (ring
    cursor IO and checkpoint spans).  Reads of never-written slots return
    zeros, matching ndarray semantics, so a tiered replay is bit-exact
    with its dense twin from the first sample on.

    The owner's lock serializes every call; the evictor reaches eviction
    through the owner (``spill_cold``) under that same lock.
    """

    def __init__(self, capacity: int, frame_shape, dtype=np.uint8,
                 hot_budget_bytes: int = 0, spill_path: str = "",
                 span_frames: int = 0,
                 watermark_high: float = 1.0, watermark_low: float = 0.9):
        self.capacity = int(capacity)
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.frame_shape)) * self.dtype.itemsize
        self.span_frames = int(span_frames) if span_frames else \
            auto_span_frames(self.frame_bytes)
        self.n_spans = -(-self.capacity // self.span_frames)
        self.span_bytes = self.span_frames * self.frame_bytes
        self.hot_budget_bytes = int(hot_budget_bytes)
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        if not spill_path:
            raise ValueError("tiered ring needs a spill_path")
        self.store = ColdSpanStore(spill_path, self.n_spans, self.span_bytes)
        self._hot: dict = {}                  # sid -> ndarray block
        # Bytes the hot blocks hold, kept beside ``_hot``: the evictor
        # polls it without the owner's lock, and a sum over ``_hot`` there
        # would iterate a dict the drain thread is inserting into.
        self._hot_nbytes = 0
        self._touch = np.zeros(self.n_spans, np.int64)
        self._clock = 0
        # Per-span cold record state: valid flag, which A/B slot holds the
        # current content, its crc, and the spill count (drives A/B).
        self._cold_valid = np.zeros(self.n_spans, bool)
        self._cold_ab = np.zeros(self.n_spans, np.int8)
        self._cold_crc = np.zeros(self.n_spans, np.uint32)
        self._spills = np.zeros(self.n_spans, np.int64)
        # A/B slot referenced by the newest checkpoint base (-1 = none):
        # spills never write a pinned slot, so the committed refs stay
        # valid however many times a span churns between bases.
        self._pinned_ab = np.full(self.n_spans, -1, np.int8)
        # Dirty = hot content newer than the cold record (or never spilled).
        self._dirty = np.zeros(self.n_spans, bool)
        # Counters (owner exposes via tier_stats; obs layer scrapes them).
        self.spilled_bytes = 0
        self.spill_writes = 0
        self.fault_reads = 0
        self.fault_bytes = 0
        self.fault_ms = LatencyHistogram(min_s=1e-5, max_s=60.0,
                                         per_decade=10)

    # -- span helpers ----------------------------------------------------

    def _span_len(self, sid: int) -> int:
        """Frames actually covered by span ``sid`` (the last span may be
        short when capacity % span_frames != 0)."""
        return min(self.span_frames,
                   self.capacity - sid * self.span_frames)

    def _tick(self, sid) -> None:
        self._clock += 1
        self._touch[sid] = self._clock

    def _block(self, sid: int) -> np.ndarray:
        """The hot block for ``sid``, faulting from cold if needed,
        zero-allocating if the span was never written."""
        blk = self._hot.get(sid)
        if blk is None:
            blk = self._fault(sid)
        return blk

    def _install(self, sid: int, blk: np.ndarray) -> None:
        old = self._hot.get(sid)
        self._hot[sid] = blk
        self._hot_nbytes += blk.nbytes - (0 if old is None else old.nbytes)

    def _release(self, sid: int) -> Optional[np.ndarray]:
        blk = self._hot.pop(sid, None)
        if blk is not None:
            self._hot_nbytes -= blk.nbytes
        return blk

    def _fault(self, sid: int) -> np.ndarray:
        n = self._span_len(sid)
        if self._cold_valid[sid]:
            t0 = time.perf_counter()
            payload = self.store.read(
                self.store.offset(sid, int(self._cold_ab[sid])),
                sid=sid, want_crc=int(self._cold_crc[sid]),
            )
            blk = np.frombuffer(payload, self.dtype).reshape(
                n, *self.frame_shape
            ).copy()
            self.fault_reads += 1
            self.fault_bytes += len(payload)
            self.fault_ms.record(time.perf_counter() - t0)
            self._dirty[sid] = False   # disk copy is current
        else:
            blk = np.zeros((n, *self.frame_shape), self.dtype)
            self._dirty[sid] = True    # nothing on disk yet
        self._install(sid, blk)
        return blk

    # -- flat-index access (sample gather / scattered put) ---------------

    def get(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        out = np.empty((idx.shape[0], *self.frame_shape), self.dtype)
        sids = idx // self.span_frames
        for sid in np.unique(sids):
            sel = sids == sid
            blk = self._block(int(sid))
            out[sel] = blk[idx[sel] - int(sid) * self.span_frames]
            self._tick(int(sid))
        return out

    def put(self, idx: np.ndarray, frames) -> None:
        idx = np.asarray(idx, np.int64)
        frames = np.asarray(frames, self.dtype)
        sids = idx // self.span_frames
        for sid in np.unique(sids):
            sel = sids == sid
            blk = self._block(int(sid))
            blk[idx[sel] - int(sid) * self.span_frames] = frames[sel]
            self._dirty[sid] = True
            self._tick(int(sid))

    # -- wrap-aware contiguous runs (ring cursor IO, checkpoint spans) ---

    def get_span(self, start: int, n: int) -> np.ndarray:
        """n frames from ring slot ``start`` (wrap-aware)."""
        out = np.empty((n, *self.frame_shape), self.dtype)
        self._run(start, n, out, write=False)
        return out

    def put_span(self, start: int, n: int, frames) -> None:
        frames = np.ascontiguousarray(frames, self.dtype)
        self._run(start, n, frames, write=True)

    def _run(self, start: int, n: int, buf: np.ndarray, write: bool) -> None:
        start = int(start) % self.capacity
        done = 0
        while done < n:
            slot = (start + done) % self.capacity
            sid = slot // self.span_frames
            within = slot - sid * self.span_frames
            take = min(n - done, self._span_len(sid) - within)
            if write and within == 0 and take == self._span_len(sid) \
                    and sid not in self._hot:
                # Full-span overwrite of a non-resident span: no fault —
                # the old content is dead, allocate fresh.
                blk = np.empty((take, *self.frame_shape), self.dtype)
                self._install(sid, blk)
            else:
                blk = self._block(sid)
            if write:
                blk[within:within + take] = buf[done:done + take]
                self._dirty[sid] = True
            else:
                buf[done:done + take] = blk[within:within + take]
            self._tick(sid)
            done += take

    # -- eviction --------------------------------------------------------

    @property
    def hot_bytes(self) -> int:
        return self._hot_nbytes

    @property
    def cold_bytes(self) -> int:
        """Bytes only the cold tier holds (cold-valid spans not resident)."""
        return sum(
            self._span_len(int(s)) * self.frame_bytes
            for s in np.nonzero(self._cold_valid)[0]
            if int(s) not in self._hot
        )

    def over_high_watermark(self) -> bool:
        return (self.hot_budget_bytes > 0 and
                self.hot_bytes > self.hot_budget_bytes * self.watermark_high)

    def spill(self, max_spans: int = 0, target_bytes: Optional[int] = None
              ) -> tuple:
        """Evict least-recently-touched hot spans until the hot tier is at
        or under ``target_bytes`` (default: low watermark × budget), or
        ``max_spans`` were spilled (0 = unbounded).  Returns
        (spans_spilled, bytes_written) — bytes_written counts only dirty
        spans (clean ones just drop their block)."""
        if target_bytes is None:
            target_bytes = int(self.hot_budget_bytes * self.watermark_low)
        spilled = wrote = 0
        if not self._hot:
            return 0, 0
        order = sorted(self._hot, key=lambda s: self._touch[s])
        for sid in order:
            if self.hot_bytes <= target_bytes:
                break
            wrote += self._evict_one(sid)
            spilled += 1
            if max_spans and spilled >= max_spans:
                break
        return spilled, wrote

    def flush_dirty(self) -> int:
        """Write every dirty hot span's cold record WITHOUT dropping
        residency — after this, any eviction is a free clean drop (and a
        kill loses no span that was hot at flush time).  Returns bytes
        written."""
        wrote = 0
        for sid, blk in self._hot.items():
            if not self._dirty[sid]:
                continue
            ab = self._next_ab(sid)
            payload = np.ascontiguousarray(blk).tobytes()
            _, crc = self.store.write(sid, ab, payload)
            self._spills[sid] += 1
            self._cold_ab[sid] = ab
            self._cold_crc[sid] = np.uint32(crc)
            self._cold_valid[sid] = True
            self._dirty[sid] = False
            self.spilled_bytes += len(payload)
            self.spill_writes += 1
            wrote += len(payload)
        return wrote

    def _evict_one(self, sid: int) -> int:
        blk = self._release(sid)
        if not self._dirty[sid] and self._cold_valid[sid]:
            return 0  # disk copy current — eviction is free
        ab = self._next_ab(sid)
        payload = np.ascontiguousarray(blk).tobytes()
        _, crc = self.store.write(sid, ab, payload)
        self._spills[sid] += 1
        self._cold_ab[sid] = ab
        self._cold_crc[sid] = np.uint32(crc)
        self._cold_valid[sid] = True
        self._dirty[sid] = False
        self.spilled_bytes += len(payload)
        self.spill_writes += 1
        return len(payload)

    # -- checkpoint integration (utils/checkpoint_inc) -------------------

    def _next_ab(self, sid: int) -> int:
        """The record slot the next spill of ``sid`` may write: never the
        slot the newest checkpoint base references (pinned at cold_refs
        time), else plain A/B alternation — a committed base's refs stay
        readable however often the span churns before the next base."""
        pinned = int(self._pinned_ab[sid])
        if pinned >= 0:
            return pinned ^ 1
        return int(self._spills[sid] + 1) & 1

    def cold_refs(self, nf: int) -> Optional[dict]:
        """Offset references for every span that is cold right now, and the
        hot remainder inline — the base-snapshot split.  ``nf`` bounds the
        written region (slots >= nf were never written; their spans are
        skipped entirely).  Returns None when nothing is cold (the caller
        keeps the legacy dense format).  fsyncs the store first: a
        manifest must never reference a record the disk hasn't seen."""
        written = -(-int(nf) // self.span_frames) if nf else 0
        cold = [s for s in range(written)
                if s not in self._hot and self._cold_valid[s]]
        if not cold:
            return None
        self.store.sync()
        # Pin the about-to-be-referenced records: spills now avoid
        # these slots until the next base supersedes the pin set.
        self._pinned_ab[:] = -1
        for sid_ in cold:
            self._pinned_ab[sid_] = self._cold_ab[sid_]
        hot = [s for s in range(written) if s not in cold]
        hot_frames = (
            np.concatenate([self._span_block_copy(s) for s in hot])
            if hot else np.zeros((0, *self.frame_shape), self.dtype)
        )
        return {
            "tier_span_frames": np.asarray([self.span_frames], np.int64),
            "tier_capacity": np.asarray([self.capacity], np.int64),
            "tier_hot_sids": np.asarray(hot, np.int64),
            "tier_hot_frames": hot_frames,
            "tier_cold_sids": np.asarray(cold, np.int64),
            "tier_cold_offsets": np.asarray(
                [self.store.offset(s, int(self._cold_ab[s])) for s in cold],
                np.int64),
            "tier_cold_lens": np.asarray(
                [self._span_len(s) for s in cold], np.int64),
            "tier_cold_crcs": np.asarray(
                [int(self._cold_crc[s]) for s in cold], np.int64),
            "tier_spill_path": np.frombuffer(
                self.store.path.encode(), np.uint8).copy(),
        }

    def _span_block_copy(self, sid: int) -> np.ndarray:
        blk = self._hot.get(sid)
        if blk is not None:
            return np.array(blk, copy=True)
        return self.get_span(sid * self.span_frames, self._span_len(sid))

    def adopt_cold_ref(self, sid: int, offset: int, length: int,
                       crc: int, src: "ColdSpanStore") -> None:
        """Restore-side: take ownership of one cold span.  Same store +
        same layout → verify the record in place and mark the span cold
        without copying a byte (the O(hot) restore).  Different store →
        read (verified) and install hot; the evictor re-spills later."""
        same = (os.path.realpath(src.path)
                == os.path.realpath(self.store.path)
                and src.record_size == self.store.record_size)
        if same:
            # Verify, then reference in place.
            src.read(offset, sid=sid, want_crc=crc)
            ab = (int(offset) // self.store.record_size) & 1
            self._release(sid)
            self._cold_valid[sid] = True
            self._cold_ab[sid] = ab
            self._cold_crc[sid] = np.uint32(int(crc) & 0xFFFFFFFF)
            # Keep future A/B alternation away from the adopted slot.
            self._spills[sid] = ab
            # The restored chain still references this record — pin it
            # until the next base supersedes the set.
            self._pinned_ab[sid] = ab
            self._dirty[sid] = False
            return
        payload = src.read(offset, sid=sid, want_crc=crc)
        blk = np.frombuffer(payload, self.dtype).reshape(
            int(length), *self.frame_shape).copy()
        self._install(sid, blk)
        self._cold_valid[sid] = False
        self._dirty[sid] = True
        self._tick(sid)

    def drop_all(self) -> None:
        """Full-restore preamble: forget every tier state (the snapshot
        about to load defines the new contents)."""
        self._hot.clear()
        self._hot_nbytes = 0
        self._cold_valid[:] = False
        self._dirty[:] = False
        self._pinned_ab[:] = -1
        self._touch[:] = 0

    # -- stats / lifecycle ------------------------------------------------

    def tier_stats(self) -> dict:
        out = {
            "hot_bytes": self.hot_bytes,
            "hot_spans": len(self._hot),
            "cold_spans": int(np.count_nonzero(self._cold_valid)),
            "hot_budget_bytes": self.hot_budget_bytes,
            "span_frames": self.span_frames,
            "spilled_bytes": self.spilled_bytes,
            "spill_writes": self.spill_writes,
            "fault_reads": self.fault_reads,
            "fault_bytes": self.fault_bytes,
        }
        out["fault_ms"] = self.fault_ms.summary()  # keys already in ms
        return out

    def close(self, unlink: bool = False) -> None:
        self.store.close(unlink=unlink)


def read_cold_refs_dense(state: dict) -> np.ndarray:
    """Materialize a cold-ref base snapshot's full frame region [0, nf)
    as one dense array — the restore path for replays WITHOUT a tier (or
    with an incompatible layout).  Every referenced record is CRC- and
    content-verified; failures raise ``ColdSpanCorrupt`` so the
    checkpoint fallback walk can act on them."""
    span_frames = int(np.asarray(state["tier_span_frames"]).reshape(-1)[0])
    capacity = int(np.asarray(state["tier_capacity"]).reshape(-1)[0])
    path = bytes(np.asarray(state["tier_spill_path"], np.uint8)).decode()
    hot_sids = np.asarray(state["tier_hot_sids"], np.int64)
    cold_sids = np.asarray(state["tier_cold_sids"], np.int64)
    cold_offsets = np.asarray(state["tier_cold_offsets"], np.int64)
    cold_lens = np.asarray(state["tier_cold_lens"], np.int64)
    cold_crcs = np.asarray(state["tier_cold_crcs"], np.int64)
    hot_frames = np.asarray(state["tier_hot_frames"])
    frame_shape = hot_frames.shape[1:]
    if not len(frame_shape):
        raise ColdSpanCorrupt("tiered base has no frame shape witness",
                              path=path)
    sids = list(hot_sids) + list(cold_sids)
    written = (max(int(s) for s in sids) + 1) * span_frames if sids else 0
    nf = min(written, capacity)
    dense = np.zeros((nf, *frame_shape), hot_frames.dtype)

    def span_len(sid):
        return min(span_frames, capacity - sid * span_frames)

    off = 0
    for sid in hot_sids:
        n = span_len(int(sid))
        lo = int(sid) * span_frames
        dense[lo:lo + min(n, nf - lo)] = hot_frames[off:off + n][:nf - lo]
        off += n
    if len(cold_sids):
        store = ColdSpanStore(
            path, int(max(cold_sids)) + 1,
            span_frames * int(np.prod(frame_shape))
            * hot_frames.dtype.itemsize,
        )
        try:
            for sid, offset, length, crc in zip(
                    cold_sids, cold_offsets, cold_lens, cold_crcs):
                payload = store.read(int(offset), sid=int(sid),
                                     want_crc=int(crc))
                blk = np.frombuffer(payload, hot_frames.dtype).reshape(
                    int(length), *frame_shape)
                lo = int(sid) * span_frames
                dense[lo:lo + min(int(length), nf - lo)] = blk[:nf - lo]
        finally:
            store.close()
    return dense


class SpanTierIndex:
    """Tier bookkeeping for a ring whose hot storage lives ELSEWHERE —
    the native core's address-stable frame mmap.  Same span states,
    LRU, cold store, counters, and checkpoint-ref format as
    ``TieredFrameRing``; instead of owning hot blocks it drives three
    callables against the external storage:

      read_fn(fstart_slot, n)  -> ndarray   (wrap-aware copy, no drop)
      evict_fn(fstart_slot, n) -> ndarray   (copy out + release pages —
                                             rc_evict_span: the mmap's
                                             region MADV_DONTNEEDs)
      fault_fn(fstart_slot, n, frames)      (copy verified bytes back —
                                             rc_fault_span)

    A span is *resident* (counts toward hot bytes) once written or
    faulted; evicting drops residency and the RSS with it.  All calls
    run under the owning replay's lock.
    """

    def __init__(self, capacity: int, frame_shape, dtype,
                 hot_budget_bytes: int, spill_path: str,
                 read_fn, evict_fn, fault_fn,
                 span_frames: int = 0,
                 watermark_high: float = 1.0, watermark_low: float = 0.9,
                 fault_batch_fn=None, drop_fn=None):
        self.capacity = int(capacity)
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.frame_shape)) * self.dtype.itemsize
        self.span_frames = int(span_frames) if span_frames else \
            auto_span_frames(self.frame_bytes)
        self.n_spans = -(-self.capacity // self.span_frames)
        self.span_bytes = self.span_frames * self.frame_bytes
        self.hot_budget_bytes = int(hot_budget_bytes)
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        self.store = ColdSpanStore(spill_path, self.n_spans, self.span_bytes)
        self._read, self._evict, self._fault_in = read_fn, evict_fn, fault_fn
        # Optional fast paths (the native core provides both):
        # fault_batch_fn(fd, offsets, fstarts, lens, sids, want_crcs) -> i
        # preads + CRC-verifies + installs a whole batch in ONE
        # GIL-released call (-1 = all ok, else first failing index);
        # drop_fn(fstart, n) releases a CLEAN span's pages without the
        # copy-out rc_evict_span would do.
        self._fault_batch = fault_batch_fn
        self._drop = drop_fn
        self._n_resident = 0
        self._resident = np.zeros(self.n_spans, bool)
        self._dirty = np.zeros(self.n_spans, bool)
        self._cold_valid = np.zeros(self.n_spans, bool)
        self._cold_ab = np.zeros(self.n_spans, np.int8)
        self._cold_crc = np.zeros(self.n_spans, np.uint32)
        self._spills = np.zeros(self.n_spans, np.int64)
        # Checkpoint-referenced A/B slots (see TieredFrameRing): spills
        # never write a pinned slot.
        self._pinned_ab = np.full(self.n_spans, -1, np.int8)
        self._touch = np.zeros(self.n_spans, np.int64)
        self._clock = 0
        self.spilled_bytes = 0
        self.spill_writes = 0
        self.fault_reads = 0
        self.fault_bytes = 0
        self.fault_ms = LatencyHistogram(min_s=1e-5, max_s=60.0,
                                         per_decade=10)

    def _span_len(self, sid: int) -> int:
        return min(self.span_frames,
                   self.capacity - sid * self.span_frames)

    def _tick(self, sid) -> None:
        self._clock += 1
        self._touch[sid] = self._clock

    def spans_of_slots(self, slots: np.ndarray) -> np.ndarray:
        return np.unique(np.asarray(slots, np.int64) // self.span_frames)

    def spans_of_run(self, start: int, n: int) -> np.ndarray:
        """Span ids overlapped by the wrap-aware run [start, start+n)."""
        if n <= 0:
            return np.zeros(0, np.int64)
        start = int(start) % self.capacity
        if start + n <= self.capacity:
            return np.arange(start // self.span_frames,
                             (start + n - 1) // self.span_frames + 1)
        head = np.arange(start // self.span_frames, self.n_spans)
        tail = np.arange(0, (start + n - self.capacity - 1)
                         // self.span_frames + 1)
        return np.unique(np.concatenate([head, tail]))

    def _set_resident(self, sid: int, value: bool) -> None:
        if bool(self._resident[sid]) != value:
            self._resident[sid] = value
            self._n_resident += 1 if value else -1

    def ensure_hot(self, sids) -> None:
        """Fault every cold span in ``sids`` back into the external
        storage (the pre-gather / pre-export step).  Never-spilled,
        non-resident spans are zeros in the mmap already — nothing to do
        beyond marking them resident on first touch.  With the native
        fast path the whole batch lands in ONE GIL-released pread+CRC
        call; a failure falls back to the per-span python read, whose
        error carries the full typed diagnosis."""
        sids = np.asarray(sids, np.int64)
        self._clock += 1
        self._touch[sids] = self._clock
        need_arr = sids[~self._resident[sids]]
        if not need_arr.size:
            return
        if self._fault_batch is not None:
            cold_arr = need_arr[self._cold_valid[need_arr]]
            if cold_arr.size:
                t0 = time.perf_counter()
                offsets = (2 * cold_arr
                           + self._cold_ab[cold_arr]) \
                    * self.store.record_size
                fstarts = cold_arr * self.span_frames
                lens = np.minimum(self.span_frames,
                                  self.capacity - fstarts)
                crcs = self._cold_crc[cold_arr].astype(np.int64)
                bad = self._fault_batch(
                    self.store.fd, np.ascontiguousarray(offsets),
                    np.ascontiguousarray(fstarts),
                    np.ascontiguousarray(lens),
                    np.ascontiguousarray(cold_arr), crcs,
                )
                if bad >= 0:
                    # Re-read the failing span through the python path:
                    # same verification, full typed diagnosis.
                    s = int(cold_arr[int(bad)])
                    self.store.read(int(offsets[bad]), sid=s,
                                    want_crc=int(crcs[bad]))
                    raise ColdSpanCorrupt(
                        f"{self.store.path}: span {s} failed the batched "
                        "fault but verified alone (concurrent rewrite?)",
                        path=self.store.path, span=s,
                    )
                self.fault_reads += int(cold_arr.size)
                self.fault_bytes += int(lens.sum()) * self.frame_bytes
                self.fault_ms.record(time.perf_counter() - t0)
                self._dirty[cold_arr] = False
            self._n_resident += int(
                np.count_nonzero(~self._resident[need_arr])
            )
            self._resident[need_arr] = True
            # Every span the caller is about to read stays, not only the
            # ones just faulted: a resident clean span of this batch dropped
            # here would gather as zero-filled pages (the JAX copy excludes
            # only the faulted ones, and a sample then reads zeros).
            self._trim_clean_inline(exclude=sids)
            return
        for sid in [int(s) for s in need_arr]:
            if self._cold_valid[sid]:
                t0 = time.perf_counter()
                payload = self.store.read(
                    self.store.offset(sid, int(self._cold_ab[sid])),
                    sid=sid, want_crc=int(self._cold_crc[sid]),
                )
                blk = np.frombuffer(payload, self.dtype).reshape(
                    self._span_len(sid), *self.frame_shape)
                self._fault_in(sid * self.span_frames, blk.shape[0], blk)
                self.fault_reads += 1
                self.fault_bytes += len(payload)
                self.fault_ms.record(time.perf_counter() - t0)
                self._dirty[sid] = False
            self._set_resident(sid, True)

    def _trim_clean_inline(self, exclude: np.ndarray) -> None:
        """Keep the budget tight WITHOUT cross-thread lock ping-pong: a
        fault batch that pushed the hot tier over its high watermark
        drops the least-recently-sampled CLEAN spans (disk record
        current — a drop is one madvise, ~10 us) right here, excluding
        every span the batch references.  Dirty spans are never
        touched: their write-back stays on the evictor thread (the
        learner-critical-path contract covers WRITES, not page drops)."""
        if self._drop is None or self.hot_budget_bytes <= 0:
            return
        if self.hot_bytes <= self.hot_budget_bytes * self.watermark_high:
            return
        droppable = self._resident & self._cold_valid & ~self._dirty
        droppable[exclude] = False
        cand = np.nonzero(droppable)[0]
        if not cand.size:
            return
        target = int(self.hot_budget_bytes * self.watermark_low)
        excess_spans = max(
            0, -(-(self.hot_bytes - target) // self.span_bytes)
        )
        for sid in cand[np.argsort(self._touch[cand])][:excess_spans]:
            sid = int(sid)
            self._drop(sid * self.span_frames, self._span_len(sid))
            self._set_resident(sid, False)

    def note_write(self, start: int, n: int) -> None:
        """Pre-ingest hook for the wrap-aware run about to be written:
        cold spans only PARTIALLY covered must fault first (their
        untouched slots' content lives only in the cold record); fully
        covered spans skip the fault — their content is being replaced
        wholesale.  Afterwards every overlapped span is resident+dirty."""
        sids = self.spans_of_run(start, n)
        if not sids.size:
            return
        start = int(start) % self.capacity
        end = start + int(n)
        for sid in sids:
            sid = int(sid)
            lo = sid * self.span_frames
            hi = lo + self._span_len(sid)
            covered = (
                (start <= lo and end >= hi)
                or (end > self.capacity
                    and (end - self.capacity) >= hi)  # wrapped tail
            )
            if not covered and not self._resident[sid] \
                    and self._cold_valid[sid]:
                self.ensure_hot([sid])
            self._set_resident(sid, True)
            self._dirty[sid] = True
            self._tick(sid)

    @property
    def hot_bytes(self) -> int:
        return self._n_resident * self.span_bytes

    @property
    def cold_bytes(self) -> int:
        return sum(
            self._span_len(int(s)) * self.frame_bytes
            for s in np.nonzero(self._cold_valid & ~self._resident)[0]
        )

    def over_high_watermark(self) -> bool:
        return (self.hot_budget_bytes > 0 and
                self.hot_bytes > self.hot_budget_bytes * self.watermark_high)

    def spill(self, max_spans: int = 0,
              target_bytes: Optional[int] = None) -> tuple:
        if target_bytes is None:
            target_bytes = int(self.hot_budget_bytes * self.watermark_low)
        resident = np.nonzero(self._resident)[0]
        if not resident.size:
            return 0, 0
        order = resident[np.argsort(self._touch[resident])]
        spilled = wrote = 0
        for sid in order:
            if self.hot_bytes <= target_bytes:
                break
            sid = int(sid)
            n = self._span_len(sid)
            if not self._dirty[sid] and self._cold_valid[sid] \
                    and self._drop is not None:
                # Clean drop: disk record current — release pages only.
                self._drop(sid * self.span_frames, n)
            else:
                blk = self._evict(sid * self.span_frames, n)
                if self._dirty[sid] or not self._cold_valid[sid]:
                    ab = self._next_ab(sid)
                    payload = np.ascontiguousarray(blk).tobytes()
                    _, crc = self.store.write(sid, ab, payload)
                    self._spills[sid] += 1
                    self._cold_ab[sid] = ab
                    self._cold_crc[sid] = np.uint32(crc)
                    self._cold_valid[sid] = True
                    self.spilled_bytes += len(payload)
                    self.spill_writes += 1
                    wrote += len(payload)
            self._dirty[sid] = False
            self._set_resident(sid, False)
            spilled += 1
            if max_spans and spilled >= max_spans:
                break
        return spilled, wrote

    def flush_dirty(self) -> int:
        """Write every dirty resident span's record without dropping
        residency — evictions afterwards are clean drops."""
        wrote = 0
        for sid in np.nonzero(self._resident & self._dirty)[0]:
            sid = int(sid)
            n = self._span_len(sid)
            blk = self._read(sid * self.span_frames, n)
            ab = self._next_ab(sid)
            payload = np.ascontiguousarray(blk).tobytes()
            _, crc = self.store.write(sid, ab, payload)
            self._spills[sid] += 1
            self._cold_ab[sid] = ab
            self._cold_crc[sid] = np.uint32(crc)
            self._cold_valid[sid] = True
            self._dirty[sid] = False
            self.spilled_bytes += len(payload)
            self.spill_writes += 1
            wrote += len(payload)
        return wrote

    # -- checkpoint integration (same dict format as TieredFrameRing) ----

    def _next_ab(self, sid: int) -> int:
        """The record slot the next spill of ``sid`` may write: never the
        slot the newest checkpoint base references (pinned at cold_refs
        time), else plain A/B alternation — a committed base's refs stay
        readable however often the span churns before the next base."""
        pinned = int(self._pinned_ab[sid])
        if pinned >= 0:
            return pinned ^ 1
        return int(self._spills[sid] + 1) & 1

    def cold_refs(self, nf: int) -> Optional[dict]:
        written = -(-int(nf) // self.span_frames) if nf else 0
        cold = [s for s in range(written)
                if not self._resident[s] and self._cold_valid[s]]
        if not cold:
            return None
        self.store.sync()
        # Pin the about-to-be-referenced records: spills now avoid
        # these slots until the next base supersedes the pin set.
        self._pinned_ab[:] = -1
        for sid_ in cold:
            self._pinned_ab[sid_] = self._cold_ab[sid_]
        hot = [s for s in range(written) if s not in set(cold)]
        hot_frames = (
            np.concatenate([
                self._read(s * self.span_frames, self._span_len(s))
                for s in hot
            ])
            if hot else np.zeros((0, *self.frame_shape), self.dtype)
        )
        return {
            "tier_span_frames": np.asarray([self.span_frames], np.int64),
            "tier_capacity": np.asarray([self.capacity], np.int64),
            "tier_hot_sids": np.asarray(hot, np.int64),
            "tier_hot_frames": hot_frames,
            "tier_cold_sids": np.asarray(cold, np.int64),
            "tier_cold_offsets": np.asarray(
                [self.store.offset(s, int(self._cold_ab[s])) for s in cold],
                np.int64),
            "tier_cold_lens": np.asarray(
                [self._span_len(s) for s in cold], np.int64),
            "tier_cold_crcs": np.asarray(
                [int(self._cold_crc[s]) for s in cold], np.int64),
            "tier_spill_path": np.frombuffer(
                self.store.path.encode(), np.uint8).copy(),
        }

    def install_hot(self, sid: int, frames: np.ndarray) -> None:
        """Restore-side: place one span's frames into the external
        storage and account it resident+dirty."""
        blk = np.ascontiguousarray(frames, self.dtype)
        self._fault_in(sid * self.span_frames, blk.shape[0], blk)
        self._set_resident(sid, True)
        self._dirty[sid] = True
        self._tick(sid)

    def adopt_cold_ref(self, sid: int, offset: int, length: int,
                       crc: int, src: "ColdSpanStore") -> None:
        same = (os.path.realpath(src.path)
                == os.path.realpath(self.store.path)
                and src.record_size == self.store.record_size)
        if same:
            src.read(offset, sid=sid, want_crc=crc)
            # Stale mmap bytes for this span drop now; the next access
            # faults the verified record in.
            if self._drop is not None:
                self._drop(sid * self.span_frames, self._span_len(sid))
            else:
                self._evict(sid * self.span_frames, self._span_len(sid))
            ab = (int(offset) // self.store.record_size) & 1
            self._set_resident(sid, False)
            self._cold_valid[sid] = True
            self._cold_ab[sid] = ab
            self._cold_crc[sid] = np.uint32(int(crc) & 0xFFFFFFFF)
            self._spills[sid] = ab
            # The restored chain still references this record — pin it
            # until the next base supersedes the set.
            self._pinned_ab[sid] = ab
            self._dirty[sid] = False
            return
        payload = src.read(offset, sid=sid, want_crc=crc)
        blk = np.frombuffer(payload, self.dtype).reshape(
            int(length), *self.frame_shape)
        self._fault_in(sid * self.span_frames, blk.shape[0], blk)
        self._set_resident(sid, True)
        self._cold_valid[sid] = False
        self._dirty[sid] = True
        self._tick(sid)

    def drop_all(self) -> None:
        self._resident[:] = False
        self._n_resident = 0
        self._cold_valid[:] = False
        self._dirty[:] = False
        self._pinned_ab[:] = -1
        self._touch[:] = 0

    def tier_stats(self) -> dict:
        out = {
            "hot_bytes": self.hot_bytes,
            "hot_spans": self._n_resident,
            "cold_spans": int(np.count_nonzero(self._cold_valid)),
            "hot_budget_bytes": self.hot_budget_bytes,
            "span_frames": self.span_frames,
            "spilled_bytes": self.spilled_bytes,
            "spill_writes": self.spill_writes,
            "fault_reads": self.fault_reads,
            "fault_bytes": self.fault_bytes,
        }
        out["fault_ms"] = self.fault_ms.summary()
        return out

    def close(self, unlink: bool = False) -> None:
        self.store.close(unlink=unlink)


class TierEvictor(threading.Thread):
    """Background eviction — the stager/writer-thread pattern applied to
    the cold tier: the learner thread never pays for a spill; it only
    faults what it samples.  Wakes on a short cadence, spills in bounded
    batches (each batch is one replay-lock acquisition) whenever the ring
    is over its high watermark."""

    def __init__(self, replay, poll_s: float = 0.05,
                 batch_spans: int = 32):
        super().__init__(name="tier-evictor", daemon=True)
        self._replay = replay
        self._poll_s = float(poll_s)
        self._batch = int(batch_spans)
        # NB: not `_stop` — threading.Thread owns that name internally.
        self._halt = threading.Event()
        self.heartbeat = time.monotonic()
        self.error: Optional[BaseException] = None

    def stop(self, timeout: float = 10.0) -> None:
        self._halt.set()
        self.join(timeout=timeout)

    def run(self) -> None:
        try:
            while not self._halt.is_set():
                self.heartbeat = time.monotonic()
                if self._replay.tier_over_watermark():
                    self._replay.spill_cold(max_spans=self._batch)
                else:
                    self._halt.wait(self._poll_s)
        except BaseException as e:  # noqa: BLE001 — surfaced by the owner
            self.error = e
