"""SIGKILL-safe SPSC shared-memory experience ring — the actor→learner
chunk transport for process actors.

Port of ``ape_x_dqn_tpu/runtime/shm_ring.py``; the segment layout and the
record framing are the JAX package's, so a ring written by one package is
read by the other.

  * **Single producer / single consumer** per ring, one ring per worker
    incarnation.  No locks: the writer owns the write cursor, the reader
    the read cursor, and each record commits through a commit word, so a
    worker killed mid-record leaves a *detectably torn tail* instead of a
    held lock.
  * **Records are CRC-framed**: ``u32 len | u32 crc32 | i64 seq | payload``.
    The writer copies the payload, then the len+crc words, and writes the
    monotone ``seq`` LAST — the commit.  The reader accepts a record only if
    ``seq`` is the next expected index AND the crc matches, so stale bytes
    of an earlier lap and half-written tails are both rejected.  The crc
    covers the payload's head and tail windows (``_CRC_WINDOW`` bytes each;
    the whole payload when it fits twice the window, or always with
    ``crc_full=True``): a kill cannot reorder program-order stores, so a
    visible commit word proves every payload store ran, and torn tails are
    caught by the seq alone.  On weakly ordered CPUs (non-x86) payload
    stores may become visible after the commit word; construct both ends
    with ``crc_full=True`` there.
  * **Backpressure**: the writer sleeps (bounded, abortable) while
    ``capacity`` bytes are in flight and counts ``full_waits``.
  * **Payloads are written once**: ``pack_array_parts`` emits the APXT wire
    format (``utils/serialization``) as a header plus the arrays' own
    buffer views, gathered straight into shared memory.  The reader copies
    each record out of the ring once and decodes read-only numpy views over
    that copy.

stdlib + numpy only: a spawned worker imports this before anything else.

Cursor-torn-word note: the reader publishes its cursor twice (``ridx_b``
then ``ridx_a``); the writer takes ``min(a, b)``, so an update caught
between the two stores only makes the writer conservative (sees less free
space), never lets it overwrite unread bytes.

The owner of a segment (the side that created it) unlinks it in
``unlink()``, and a finalizer does so when the owner is collected or the
interpreter exits, so no exit path leaves a segment in ``/dev/shm``.
"""

from __future__ import annotations

import json
import os
import secrets
import struct
import time
import weakref
import zlib
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def session_shm_name(kind: str) -> str:
    """A /dev/shm segment name carrying this session's token: ``apx<tok>_
    <kind>_<pid>_<rand>``.  ``APEX_SHM_SESSION``, when set, is inherited by
    every child, so tooling can attribute segments to their session by
    prefix."""
    tok = os.environ.get("APEX_SHM_SESSION", "")
    return f"apx{tok}_{kind}_{os.getpid()}_{secrets.token_hex(4)}"


def create_shared_memory(kind: str, size: int) -> shared_memory.SharedMemory:
    """SharedMemory(create=True) under a session-prefixed name (collision
    retried; the random suffix makes one vanishingly rare)."""
    for _ in range(8):
        try:
            return shared_memory.SharedMemory(
                name=session_shm_name(kind), create=True, size=size
            )
        except FileExistsError:
            continue
    return shared_memory.SharedMemory(create=True, size=size)


def release_segment(shm: shared_memory.SharedMemory) -> None:
    """Close and unlink an owned segment; safe to call twice."""
    try:
        shm.close()
    except BufferError:
        pass  # a view still exports the buffer; unlinking frees the name
    try:
        shm.unlink()
    except FileNotFoundError:
        pass


def owner_finalizer(owner, shm: shared_memory.SharedMemory) -> weakref.finalize:
    """Unlink ``shm`` when ``owner`` is collected or the interpreter exits."""
    return weakref.finalize(owner, release_segment, shm)


_RING_MAGIC = b"APXR"
_RING_VERSION = 1

# Header layout (all fields 8-byte aligned; 64 bytes total):
#   0: 4s magic | u32 version
#   8: u64 data capacity (sanity check on attach)
#  16: u64 ridx_a   — reader cursor, written second   (reader-owned)
#  24: u64 ridx_b   — reader cursor, written first    (reader-owned)
#  32: u64 w_started   — records begun                (writer-owned)
#  40: u64 w_committed — records committed            (writer-owned)
#  48: u64 w_bytes     — committed bytes incl. record headers (writer-owned)
#  56: u64 w_full_waits — ring-full backpressure sleeps (writer-owned)
_HEADER_SIZE = 64
_IDENT = struct.Struct("<4sIQ")
_U64 = struct.Struct("<Q")
_REC = struct.Struct("<IIq")  # len, crc32, seq (seq is the commit word)

_OFF_RIDX_A = 16
_OFF_RIDX_B = 24
_OFF_STARTED = 32
_OFF_COMMITTED = 40
_OFF_BYTES = 48
_OFF_FULL_WAITS = 56

_CRC_WINDOW = 4096  # sampled-crc coverage at each payload boundary


def _as_bytes_view(part) -> memoryview:
    """A flat uint8 view of any C-contiguous buffer (bytes, numpy array)."""
    mv = memoryview(part)
    return mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")


class ShmRing:
    """One SPSC byte ring in a POSIX shared-memory segment.

    The creator (the learner-side pool) is the owner: it reads and, at
    teardown, unlinks.  The attacher (the worker) is the single writer.
    Records may wrap around the ring end (byte-granular split copies), so
    there are no wasted tail slots and no wrap markers.
    """

    def __init__(self, capacity: int, name: Optional[str] = None,
                 create: bool = True, crc_full: bool = False):
        self.capacity = int(capacity)
        self._crc_full = bool(crc_full)
        self._finalizer = None
        if create:
            if self.capacity < _REC.size + 1:
                raise ValueError(f"ring capacity {capacity} too small")
            self._shm = create_shared_memory("ring", _HEADER_SIZE + self.capacity)
            self._finalizer = owner_finalizer(self, self._shm)
            self._shm.buf[:_HEADER_SIZE] = b"\x00" * _HEADER_SIZE
            _IDENT.pack_into(self._shm.buf, 0, _RING_MAGIC, _RING_VERSION,
                             self.capacity)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            magic, version, cap = _IDENT.unpack_from(self._shm.buf, 0)
            if magic != _RING_MAGIC or version != _RING_VERSION:
                raise ValueError(f"not an APXR v{_RING_VERSION} ring: {name}")
            if cap != self.capacity:
                raise ValueError(
                    f"ring {name} capacity {cap} != expected {self.capacity}"
                )
        self._owner = create
        # Writer-local state (resumed from the header so a late attach starts
        # consistent).
        self._widx = self._get(_OFF_BYTES)
        self._wseq = self._get(_OFF_COMMITTED)
        # Reader-local state.
        self._ridx = self._get(_OFF_RIDX_A)
        self._rseq = self._get(_OFF_COMMITTED) if not create else 0
        self.records_read = 0
        self.bytes_read = 0

    # -- shared-header accessors ------------------------------------------

    def _get(self, off: int) -> int:
        return _U64.unpack_from(self._shm.buf, off)[0]

    def _set(self, off: int, value: int) -> None:
        _U64.pack_into(self._shm.buf, off, value)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def started(self) -> int:
        """Records the writer has BEGUN (intent mark, pre-payload)."""
        return self._get(_OFF_STARTED)

    @property
    def committed(self) -> int:
        """Records whose commit word landed (the counter may lag the commit
        word by one if the writer died between the two stores)."""
        return self._get(_OFF_COMMITTED)

    @property
    def committed_bytes(self) -> int:
        """Bytes committed by the writer, record headers included."""
        return self._get(_OFF_BYTES)

    @property
    def full_waits(self) -> int:
        """Writer-side count of ring-full backpressure sleeps."""
        return self._get(_OFF_FULL_WAITS)

    # -- ring byte copies (wrap-aware) ------------------------------------

    def _copy_in(self, pos: int, src: memoryview) -> None:
        off = pos % self.capacity
        n = len(src)
        head = min(n, self.capacity - off)
        base = _HEADER_SIZE
        self._shm.buf[base + off:base + off + head] = src[:head]
        if n > head:
            self._shm.buf[base:base + (n - head)] = src[head:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        off = pos % self.capacity
        head = min(n, self.capacity - off)
        base = _HEADER_SIZE
        out = bytes(self._shm.buf[base + off:base + off + head])
        if n > head:
            out += bytes(self._shm.buf[base:base + (n - head)])
        return out

    # -- crc framing -------------------------------------------------------

    def _crc_range(self, views: Sequence[memoryview], start: int, end: int,
                   crc: int) -> int:
        """crc32 over payload byte range [start, end) across the parts."""
        off = 0
        for v in views:
            ln = len(v)
            s, e = max(start, off), min(end, off + ln)
            if e > s:
                crc = zlib.crc32(v[s - off:e - off], crc)
            off += ln
            if off >= end:
                break
        return crc

    def _crc_parts(self, views: Sequence[memoryview], n: int) -> int:
        if self._crc_full or n <= 2 * _CRC_WINDOW:
            crc = 0
            for v in views:
                crc = zlib.crc32(v, crc)
            return crc
        crc = self._crc_range(views, 0, _CRC_WINDOW, 0)
        return self._crc_range(views, n - _CRC_WINDOW, n, crc)

    def _crc_payload(self, payload: bytes) -> int:
        n = len(payload)
        if self._crc_full or n <= 2 * _CRC_WINDOW:
            return zlib.crc32(payload)
        mv = memoryview(payload)
        return zlib.crc32(mv[n - _CRC_WINDOW:], zlib.crc32(mv[:_CRC_WINDOW]))

    # -- writer side -------------------------------------------------------

    def _reader_cursor(self) -> int:
        # min() of the duplicated words: a torn-between-stores read is
        # merely conservative (see module docstring).
        return min(self._get(_OFF_RIDX_A), self._get(_OFF_RIDX_B))

    def try_write(self, parts: Sequence) -> bool:
        """Commit one record gathered from ``parts`` (buffer views); False
        if the ring lacks space.  The payload is copied into shared memory
        exactly once — no staging concatenation."""
        views = [_as_bytes_view(p) for p in parts]
        n = sum(len(v) for v in views)
        need = _REC.size + n
        if need > self.capacity:
            raise ValueError(
                f"record of {n} bytes cannot fit ring capacity "
                f"{self.capacity} (raise actor.xp_ring_bytes)"
            )
        if self.capacity - (self._widx - self._reader_cursor()) < need:
            return False
        self._set(_OFF_STARTED, self._wseq + 1)  # intent: tail may be torn
        pos = self._widx + _REC.size
        for v in views:
            self._copy_in(pos, v)
            pos += len(v)
        self._copy_in(self._widx, struct.pack("<II", n, self._crc_parts(views, n)))
        # Commit word stores seq+1: freshly zeroed ring bytes (len=0,
        # crc32(b"")=0, seq=0) must never alias a committed empty record.
        self._copy_in(self._widx + 8, struct.pack("<q", self._wseq + 1))
        self._widx += need
        self._wseq += 1
        self._set(_OFF_COMMITTED, self._wseq)
        self._set(_OFF_BYTES, self._widx)
        return True

    def write(self, parts: Sequence, should_stop: Optional[Callable] = None,
              sleep_s: float = 0.001, timeout: Optional[float] = None) -> bool:
        """Blocking write with backpressure: sleep-poll while the ring is
        full, counting ``full_waits``; abort (False) when ``should_stop``
        fires or ``timeout`` elapses."""
        deadline = time.monotonic() + timeout if timeout else None
        while not self.try_write(parts):
            self._set(_OFF_FULL_WAITS, self._get(_OFF_FULL_WAITS) + 1)
            if should_stop is not None and should_stop():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(sleep_s)
        return True

    # -- reader side -------------------------------------------------------

    def read_next(self) -> Optional[bytes]:
        """The next committed record's payload (one copy out of the ring),
        or None.  Advances and publishes the read cursor, freeing the
        record's bytes for the writer."""
        hdr = self._copy_out(self._ridx, _REC.size)
        length, crc, seq = _REC.unpack(hdr)
        if seq != self._rseq + 1 or length > self.capacity - _REC.size:
            return None  # no committed record (or stale lap bytes)
        payload = self._copy_out(self._ridx + _REC.size, length)
        if self._crc_payload(payload) != crc:
            return None  # commit word visible before payload — retry later
        self._ridx += _REC.size + length
        self._rseq += 1
        self.records_read += 1
        self.bytes_read += _REC.size + length
        self._set(_OFF_RIDX_B, self._ridx)
        self._set(_OFF_RIDX_A, self._ridx)
        return payload

    def torn_tail(self) -> bool:
        """After the writer is dead and the ring drained: True iff the
        writer began a record it never committed (killed mid-write)."""
        return self.started > self.records_read

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._shm.close()

    def unlink(self) -> None:
        if self._finalizer is not None:
            self._finalizer()


# ---------------------------------------------------------------------------
# Flat-dict APXT serialization for the string-keyed array dicts the
# experience wire carries.  Byte-identical to utils.serialization's
# tree_to_bytes on the same dict, so either side may use either.
# ---------------------------------------------------------------------------

_APXT_MAGIC = b"APXT"
_APXT_VERSION = 1
_APXT_PREFIX = struct.Struct("<4sIQ")  # magic, version, header_len


def pack_array_parts(arrays: Dict[str, np.ndarray]) -> List:
    """[prefix bytes, manifest bytes, buf0, buf1, ...] for a flat str-keyed
    dict of arrays — concatenating the parts yields exactly
    ``utils.serialization.tree_to_bytes(arrays)`` (keys in sorted order).
    The array buffers are VIEWS: no copy happens until they are gathered
    into the ring."""
    manifest: List[dict] = []
    bufs: List[np.ndarray] = []
    for key in sorted(arrays):
        arr = np.asarray(arrays[key])
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        manifest.append(
            {"path": [{"k": key}], "dtype": str(arr.dtype), "shape": list(arr.shape)}
        )
        bufs.append(arr)
    header = json.dumps({"leaves": manifest}).encode()
    return [
        _APXT_PREFIX.pack(_APXT_MAGIC, _APXT_VERSION, len(header)),
        header,
        *bufs,
    ]


def unpack_arrays(data) -> Dict[str, np.ndarray]:
    """Decode a flat str-keyed APXT payload back to {name: array}: read-only
    views over ``data`` (zero-copy; a consumer that keeps rows past the next
    poll copies them)."""
    view = memoryview(data)
    magic, version, header_len = _APXT_PREFIX.unpack_from(view, 0)
    if magic != _APXT_MAGIC:
        raise ValueError("not an APXT payload (bad magic)")
    if version != _APXT_VERSION:
        raise ValueError(f"unsupported APXT version {version}")
    off = _APXT_PREFIX.size
    header = json.loads(bytes(view[off:off + header_len]))
    off += header_len
    out: Dict[str, np.ndarray] = {}
    for entry in header["leaves"]:
        path = entry["path"]
        if len(path) != 1 or "k" not in path[0]:
            raise ValueError(
                "nested payload — this decoder handles flat dicts only; "
                "use utils.serialization.tree_from_bytes"
            )
        shape = tuple(entry["shape"])
        if entry["dtype"] == "bfloat16":
            raise ValueError("bfloat16 experience payloads are unsupported")
        dt = np.dtype(entry["dtype"])
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(view, dt, count, off).reshape(shape)
        off += count * dt.itemsize
        out[path[0]["k"]] = arr
    return out


# ---------------------------------------------------------------------------
# Experience-record envelope: a fixed metadata prefix + the APXT array dict.
# ---------------------------------------------------------------------------

XP = 1    # dense NStepTransition chunk
DXP = 2   # frame-dedup DedupChunk (written by the JAX package's dedup path)

# kind u8 | pad | version i64 | sent_t f64 (CLOCK_MONOTONIC, comparable
# across processes on one Linux host) | actor_steps i64 | source i64 |
# chunk_seq i64 | prev_frames i64 | trace_id i64 (0 = unsampled)
_MSG = struct.Struct("<B7xqdqqqqq")


def encode_chunk_parts(kind: int, version: int, actor_steps: int,
                       arrays: Dict[str, np.ndarray], source: int = 0,
                       chunk_seq: int = 0, prev_frames: int = 0,
                       sent_t: Optional[float] = None,
                       trace_id: int = 0) -> List:
    """Ring-ready parts for one experience chunk (prefix + APXT parts)."""
    prefix = _MSG.pack(
        kind, int(version), sent_t if sent_t is not None else time.monotonic(),
        int(actor_steps), int(source), int(chunk_seq), int(prev_frames),
        int(trace_id),
    )
    return [prefix, *pack_array_parts(arrays)]


def decode_chunk(payload: bytes):
    """(kind, version, sent_t, actor_steps, source, chunk_seq, prev_frames,
    trace_id, arrays) from one ring record."""
    (kind, version, sent_t, actor_steps, source, chunk_seq, prev_frames,
     trace_id) = _MSG.unpack_from(payload, 0)
    arrays = unpack_arrays(memoryview(payload)[_MSG.size:])
    return (kind, version, sent_t, actor_steps, source, chunk_seq,
            prev_frames, trace_id, arrays)
