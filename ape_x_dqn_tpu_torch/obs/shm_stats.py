"""Per-worker shared-memory stats block: a worker's metrics that survive
SIGKILL.

Port of ``ape_x_dqn_tpu/obs/shm_stats.py`` (``WorkerStatsBlock``, :89),
byte for byte: a block one package writes, the other reads.  The parent
(``runtime/process_actors.ProcessActorPool``) creates one ``/dev/shm``
segment per worker incarnation and unlinks it at salvage, retire or pool
close; the worker attaches as its single writer.

  * **Slots** — named f64 cells (``WORKER_SLOTS``), written by the worker
    once per quantum and swept by the parent.  An aligned 8-byte store is
    effectively atomic on x86; a torn read costs one display sample.
  * **Event ring** — ``depth`` 256-byte slots of JSON records (the worker's
    flight-recorder mirror, ``obs/recorder.py``), the oldest overwritten.
    A kill mid-write leaves one slot that does not decode: the reader
    counts it as torn and skips it.
  * **Heartbeat and seq** — the writer's CLOCK_MONOTONIC time (comparable
    across processes on one host) and an update count.

Layout: a 64-byte header (``APXO`` magic, version 1, slot count, event
depth, events written, heartbeat, writer pid, seq, reserved), a 2048-byte
JSON table of slot names, 8 bytes per slot, then the event slots (u32
length, JSON payload).

Standard library only: a worker imports this before it imports torch.
"""

from __future__ import annotations

import json
import os
import struct
import time
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Sequence, Tuple

_MAGIC = b"APXO"
_VERSION = 1

# Header (64 bytes, every field 8-byte aligned):
#   0: 4s magic | u32 version
#   8: u64 n_slots
#  16: u64 event ring depth (slots)
#  24: u64 events written (monotone; slot = count % depth)   (writer-owned)
#  32: f64 heartbeat (CLOCK_MONOTONIC seconds)               (writer-owned)
#  40: u64 writer pid                                        (writer-owned)
#  48: u64 seq — bumped once per writer update               (writer-owned)
#  56: u64 reserved
_HEADER_SIZE = 64
_IDENT = struct.Struct("<4sIQQ")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")

_OFF_EV_COUNT = 24
_OFF_HEARTBEAT = 32
_OFF_PID = 40
_OFF_SEQ = 48

_NAMES_SIZE = 2048          # JSON slot-name table, written by the creator
_EVENT_SLOT = 256           # u32 len | JSON payload (truncated)

# The slots the pool provisions for actor workers.
WORKER_SLOTS: Tuple[str, ...] = (
    "env_steps",        # fleet steps of this incarnation
    "chunks",           # chunks committed to the experience channel
    "transitions",      # transitions across those chunks
    "param_version",    # newest adopted param snapshot
    "eps_mean",         # ε-ladder stats of this worker's actors
    "eps_min",
    "eps_max",
    "episodes",         # episode stats reported so far
    "collect_s",        # cumulative seconds inside fleet.collect
    "write_s",          # cumulative seconds writing the experience channel
)


class WorkerStatsBlock:
    """One stats block (slots and event ring): the creator (parent) reads,
    the attacher (worker) writes.  Every reader method works after the
    writer died."""

    def __init__(self, slots: Optional[Sequence[str]] = None, name: Optional[str] = None,
                 create: bool = True, event_depth: int = 64):
        if create:
            if not slots:
                raise ValueError("creator must define the slot layout")
            names = list(slots)
            blob = json.dumps(names).encode()
            if len(blob) > _NAMES_SIZE:
                raise ValueError(f"slot-name table of {len(blob)} bytes exceeds {_NAMES_SIZE}")
            depth = int(event_depth)
            if depth < 1:
                raise ValueError("event_depth must be >= 1")
            size = _HEADER_SIZE + _NAMES_SIZE + 8 * len(names) + depth * _EVENT_SLOT
            from ape_x_dqn_tpu_torch.runtime.shm_ring import create_shared_memory

            self._shm = create_shared_memory("stats", size)
            self._shm.buf[:size] = b"\x00" * size
            _IDENT.pack_into(self._shm.buf, 0, _MAGIC, _VERSION, len(names), depth)
            self._shm.buf[_HEADER_SIZE:_HEADER_SIZE + len(blob)] = blob
            self._names = names
            self._depth = depth
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            magic, version, n_slots, depth = _IDENT.unpack_from(self._shm.buf, 0)
            if magic != _MAGIC or version != _VERSION:
                self._shm.close()
                raise ValueError(f"not an APXO v{_VERSION} block: {name}")
            blob = bytes(self._shm.buf[_HEADER_SIZE:_HEADER_SIZE + _NAMES_SIZE]
                         ).split(b"\x00", 1)[0]
            self._names = json.loads(blob)
            if len(self._names) != n_slots:
                self._shm.close()
                raise ValueError(f"corrupt slot-name table in {name}")
            self._depth = int(depth)
            # The writer's pid lands at attach: a worker killed before its
            # first update still leaves an identifiable block.
            _U64.pack_into(self._shm.buf, _OFF_PID, os.getpid())
        self._owner = create
        self._index = {n: i for i, n in enumerate(self._names)}
        self._slots_off = _HEADER_SIZE + _NAMES_SIZE
        self._events_off = self._slots_off + 8 * len(self._names)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def slot_names(self) -> List[str]:
        return list(self._names)

    @property
    def pid(self) -> int:
        return _U64.unpack_from(self._shm.buf, _OFF_PID)[0]

    @property
    def seq(self) -> int:
        return _U64.unpack_from(self._shm.buf, _OFF_SEQ)[0]

    @property
    def events_written(self) -> int:
        return _U64.unpack_from(self._shm.buf, _OFF_EV_COUNT)[0]

    # -- writer side (the worker) -------------------------------------------

    def set(self, slot: str, value: float) -> None:
        _F64.pack_into(self._shm.buf, self._slots_off + 8 * self._index[slot], float(value))

    def add(self, slot: str, delta: float) -> None:
        # Read-modify-write by the single writer: no lock.
        self.set(slot, self.get(slot) + float(delta))

    def get(self, slot: str) -> float:
        return _F64.unpack_from(self._shm.buf, self._slots_off + 8 * self._index[slot])[0]

    def update(self, **slots: float) -> None:
        """Write slots, then the heartbeat and seq: a worker's once-per-
        quantum call."""
        for k, v in slots.items():
            self.set(k, v)
        self.heartbeat()

    def heartbeat(self) -> None:
        _F64.pack_into(self._shm.buf, _OFF_HEARTBEAT, time.monotonic())
        _U64.pack_into(self._shm.buf, _OFF_SEQ, self.seq + 1)

    def record_event(self, record: Dict) -> None:
        """Append one JSON event (the oldest slot overwritten).  A payload
        longer than a slot is truncated and so reads as torn, never as a
        different record."""
        payload = json.dumps(record).encode()[:_EVENT_SLOT - 4]
        count = self.events_written
        off = self._events_off + (count % self._depth) * _EVENT_SLOT
        # Payload first, length next, the count last: a kill between two
        # stores leaves a slot that fails to decode or is not yet counted.
        self._shm.buf[off + 4:off + 4 + len(payload)] = payload
        struct.pack_into("<I", self._shm.buf, off, len(payload))
        _U64.pack_into(self._shm.buf, _OFF_EV_COUNT, count + 1)

    # -- reader side (the parent; valid after the writer died) ---------------

    def heartbeat_age_s(self) -> float:
        t = _F64.unpack_from(self._shm.buf, _OFF_HEARTBEAT)[0]
        if t <= 0.0:
            return float("inf")  # never beat
        return max(0.0, time.monotonic() - t)

    def snapshot(self) -> Dict:
        """Every slot plus the writer's pid, seq, heartbeat age and event
        count."""
        out: Dict = {n: self.get(n) for n in self._names}
        out["pid"] = self.pid
        out["seq"] = self.seq
        out["heartbeat_age_s"] = round(self.heartbeat_age_s(), 3)
        out["events_written"] = self.events_written
        return out

    def recent_events(self, max_events: Optional[int] = None) -> Tuple[List[Dict], int]:
        """(events oldest to newest, torn count): the last ``max_events``
        slots, each decodable one delivered, each other counted as torn."""
        count = self.events_written
        depth = self._depth
        n = min(count, depth, max_events if max_events else depth)
        events: List[Dict] = []
        torn = 0
        for k in range(count - n, count):
            off = self._events_off + (k % depth) * _EVENT_SLOT
            (length,) = struct.unpack_from("<I", self._shm.buf, off)
            if not 0 < length <= _EVENT_SLOT - 4:
                torn += 1
                continue
            raw = bytes(self._shm.buf[off + 4:off + 4 + length])
            try:
                events.append(json.loads(raw))
            except ValueError:
                torn += 1
        return events, torn

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._shm.close()

    def unlink(self) -> None:
        """Remove the segment (the creator only)."""
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
