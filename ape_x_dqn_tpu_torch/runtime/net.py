"""The serving wire: CRC-framed requests and replies over TCP.

Port of the serving half of ``ape_x_dqn_tpu/runtime/net.py`` (:1-578 and
:665-892), byte for byte: a JAX client can talk to a port server and the
other way round (``tests/test_torch_serving_net.py`` compares every codec's
bytes with the JAX package's).

  * **Serve hello** (client → server, once per connection): v1 is
    ``4s magic "APXQ" | u32 version``; v2 appends the fleet extension
    ``i64 worker_id | i64 attempt | i64 token | u8 codec | u8 flags | 6x``
    (``HELLO_FLAG_TRACE`` makes every request payload lead with an i64
    trace id).
  * **Frames** (both directions after the hello)::

        u32 len | u32 crc | i64 seq | u8 kind | 7x pad   + payload

    The crc covers the payload (head and tail 4 KiB windows past 8 KiB);
    ``seq`` runs from 1 per connection per direction.  Any framing fault —
    truncation, a crc mismatch, a seq skip, a length over the bound — is a
    torn frame: nothing of it is decoded, and the connection is retired.
  * **Kinds**: ``F_SREQ`` / ``F_SREP`` / ``F_SERR`` (one observation,
    greedy action and q, typed refusal) and ``F_IREQ`` / ``F_IREP`` (a
    worker's batch of observation rows in the ``F_XPB`` container, with
    in-request frame dedup and an optional zlib codec; the greedy actions,
    q rows and the oldest param version that served them).

The experience plane's tcp transport (``NetChannel``, ``NetTransport``,
``NetWriter``) and the param-delta helpers are not part of the port yet
(ROADMAP item 6).  Standard library only at module scope (numpy is imported
inside the codecs that need it): a worker process imports this module
before anything else.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

_FRAME = struct.Struct("<IIqB7x")     # len, crc32, seq, kind (24 B, aligned)
FRAME = _FRAME                        # public alias (serving plane, tools)

F_XP = 1           # worker → learner: one experience record payload
F_PARAM_FULL = 2   # learner → worker: i64 version | snapshot blob
F_PARAM_DELTA = 3  # learner → worker: page-delta against the previous version
F_XPB = 4          # worker → learner: coalesced/encoded experience batch

# Batch codec ids (the leading byte of every F_XPB payload, and the v2
# hello's negotiated capability — a writer may only compress when the
# transport's policy accepted CODEC_ZLIB at the handshake).
CODEC_OFF = 0
CODEC_ZLIB = 1

# Serving request/reply kinds (serving/net_server.py) — the policy tier's
# wire protocol rides the SAME frame header + crc/seq discipline, so one
# parser and one adversarial-decode contract cover both planes.
F_SREQ = 16        # client → server: one observation to act on
F_SREP = 17        # server → client: greedy action + evidence
F_SERR = 18        # server → client: typed refusal (shed / closed / bad)
F_IREQ = 19        # fleet worker → server: batched inference request
F_IREP = 20        # server → worker: batched greedy actions + q rows

# Replay-service RPC kinds (replay/service.py) — the replay plane is the
# third protocol on this frame discipline: sample/add/update-priorities/
# digest between a learner and a replay shard, torn/bitflipped/oversize/
# out-of-seq frames counted and never decoded exactly like the other two.
F_RREQ = 32        # learner → shard: one replay RPC request
F_RREP = 33        # shard → learner: reply
F_RERR = 34        # shard → learner: typed refusal (bad / empty / closed)

# Fleet-discovery kinds (fleet/registry.py) — the fourth protocol on this
# frame discipline: every fleet member (replay shard, serving replica,
# remote worker host) announces itself to the run's membership registry
# over the same header + crc/seq contract; a torn/bitflipped/wrong-token/
# stale-incarnation announce is counted and never mutates membership.
F_FANN = 48        # member → registry: announce / heartbeat / leave doc
F_FREP = 49        # registry → member: membership snapshot reply

# F_SERR error codes.
E_OVERLOADED = 1   # admission control shed the request (retry later)
E_CLOSED = 2       # server shutting down
E_BAD_REQUEST = 3  # well-framed but undecodable/ill-shaped request
E_INTERNAL = 4     # batch raised; the exception type rides the message

_CRC_WINDOW = 4096          # shm_ring's sampled-crc coverage, mirrored
_MAX_FRAME = 1 << 30        # sanity bound on the length prefix

# Serving hello: v1 clients are anonymous (no run token — the serving
# port is a public-ish front door, not the fleet's private experience
# plane), but the magic/version still reject port confusion before any
# framing state.  v2 adds the fleet-internal extension (central
# inference, serving/central.py): worker id + spawn attempt (per-source
# stats), the pool's per-run token (a server started with one rejects
# mismatches at the handshake), and the negotiated obs-payload codec.
SERVE_MAGIC = b"APXQ"
SERVE_VERSION = 1
SERVE_VERSION_EXT = 2
# Hello feature flags (the former pad byte right behind the codec in the
# v2 extension structs — every pre-flags hello packed 0 there, so an old
# client reads as flags=0 and the wire stays bit-identical).  Bit 0
# negotiates CROSS-TIER TRACING: on a trace-negotiated connection every
# REQUEST-kind payload (F_SREQ / F_IREQ / F_RREQ) begins with one
# little-endian i64 trace id (0 = this request unsampled), so a lineage
# trace survives the RPC hop instead of dying at the socket.  Replies
# are unchanged — the requester keys its span on its own req_id.
HELLO_FLAG_TRACE = 1
_TRACE_ID = struct.Struct("<q")


def wrap_trace(trace_id: int, payload) -> bytes:
    """Prefix one request payload with its trace id (trace-negotiated
    connections only — the flags-off wire never carries this)."""
    return _TRACE_ID.pack(int(trace_id)) + _as_bytes(payload)


def split_trace(payload):
    """(trace_id, rest) of a trace-prefixed request payload.  Raises
    ValueError on a payload too short to carry the prefix — the caller
    replies typed (the crc already proved the bytes arrived intact)."""
    if len(payload) < _TRACE_ID.size:
        raise ValueError("request shorter than its trace prefix")
    (tid,) = _TRACE_ID.unpack_from(payload, 0)
    return int(tid), memoryview(payload)[_TRACE_ID.size:]
# Replay-service hello magics (replay/service.py speaks them; declared
# HERE because net.py is the registry of every wire-plane magic — one
# place to see that no two protocols share a handshake byte pattern; "APXR"
# is shm_ring's ring-header magic).
RSVC_MAGIC = b"APXV"
RSVC_ACK_MAGIC = b"APXA"
# Fleet-discovery hello magics (fleet/registry.py): a member dialing the
# registry leads with FLEET_MAGIC; the registry's admit ack leads with
# FLEET_ACK_MAGIC.  Wrong-token hellos are rejected by close BEFORE any
# framing state exists — port confusion and cross-run strays never reach
# the membership table.
FLEET_MAGIC = b"APXF"
FLEET_ACK_MAGIC = b"APXG"
# Fleet timeline record magic (obs/timeline.py): every record of the
# on-disk flight-data recorder leads with this header magic on the
# chunk framing discipline (magic | version | flags | payload_len |
# crc32).  Registered HERE — not in obs/ — so the wire registry owns
# every 4-byte magic in one module and a collision with a future
# protocol is a lint finding, not a decode ambiguity.
TIMELINE_MAGIC = b"APXL"
# magic, version, member_id (stable per member name), incarnation, token
FLEET_HELLO = struct.Struct("<4sIqqq")
FLEET_HELLO_VERSION = 1
# magic, version, token, registry incarnation
FLEET_ACK = struct.Struct("<4sIqq")
SERVE_HELLO = struct.Struct("<4sI")
# wid, attempt, token, codec, flags (HELLO_FLAG_*; was pad — old hellos
# read as flags=0, the bit-identical-wire gate for tracing).
SERVE_HELLO_EXT = struct.Struct("<qqqBB6x")
# Request: u64 req_id | u8 ndim | u8 dtype (0=uint8) | 6x pad | u32 dims…
_SREQ_HEAD = struct.Struct("<QBB6x")
_SREQ_DIM = struct.Struct("<I")
# Reply: u64 req_id | i32 action | i64 param_version | u32 num_q | f32 q…
_SREP_HEAD = struct.Struct("<QiqI4x")
# Error: u64 req_id | u16 code | utf-8 message
_SERR_HEAD = struct.Struct("<QH6x")


def _as_bytes(part) -> bytes:
    if isinstance(part, (bytes, bytearray)):
        return bytes(part)
    mv = memoryview(part)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return bytes(mv)


def _crc_payload(payload, crc_full: bool = False) -> int:
    """The ring's sampled head+tail window crc over one joined payload
    (full when small or ``crc_full`` — see shm_ring's weak-ordering
    note; over TCP the window still catches in-flight corruption and
    framing drift, while full crc at chunk rates was the ring's measured
    whole budget)."""
    mv = memoryview(payload)
    n = len(mv)
    if crc_full or n <= 2 * _CRC_WINDOW:
        return zlib.crc32(mv)
    return zlib.crc32(mv[n - _CRC_WINDOW:], zlib.crc32(mv[:_CRC_WINDOW]))


def frame_bytes(kind: int, seq: int, parts: Sequence,
                crc_full: bool = False) -> bytes:
    """One wire frame: header + payload joined (the socket path pays one
    gather copy into the kernel regardless — no shm-style zero-copy)."""
    payload = b"".join(_as_bytes(p) for p in parts)
    n = len(payload)
    return _FRAME.pack(n, _crc_payload(payload, crc_full), seq, kind) + payload


def serve_hello_bytes() -> bytes:
    return SERVE_HELLO.pack(SERVE_MAGIC, SERVE_VERSION)


def serve_hello_ext_bytes(wid: int, attempt: int, token: int,
                          codec: int = CODEC_OFF,
                          flags: int = 0) -> bytes:
    """The v2 fleet-internal hello (central inference): the v1 header
    with the extension struct right behind it.  ``flags=0`` keeps the
    pre-flags bytes exactly."""
    return SERVE_HELLO.pack(SERVE_MAGIC, SERVE_VERSION_EXT) + \
        SERVE_HELLO_EXT.pack(int(wid), int(attempt), int(token), int(codec),
                             int(flags))


def parse_serve_hello(buf: bytes) -> bool:
    """True iff ``buf`` is a valid v1 serving-protocol hello."""
    if len(buf) != SERVE_HELLO.size:
        return False
    try:
        magic, version = SERVE_HELLO.unpack(buf)
    except struct.error:
        return False
    return magic == SERVE_MAGIC and version == SERVE_VERSION


def parse_serve_hello_ext(buf: bytes) -> Optional[dict]:
    """Decode a v2 hello extension (the bytes AFTER the 8-byte header);
    None on malformation."""
    if len(buf) != SERVE_HELLO_EXT.size:
        return None
    try:
        wid, attempt, token, codec, flags = SERVE_HELLO_EXT.unpack(buf)
    except struct.error:
        return None
    if codec not in (CODEC_OFF, CODEC_ZLIB):
        return None
    return {"wid": int(wid), "attempt": int(attempt),
            "token": int(token), "codec": int(codec),
            "flags": int(flags)}


def encode_request(req_id: int, obs) -> bytes:
    """One F_SREQ payload: id + shape manifest + raw uint8 observation
    bytes (the APXT discipline in miniature — nothing executable)."""
    import numpy as np

    arr = np.ascontiguousarray(obs, dtype=np.uint8)
    if arr.ndim > 8:
        raise ValueError(f"observation rank {arr.ndim} > 8")
    return b"".join(
        [_SREQ_HEAD.pack(int(req_id), arr.ndim, 0),
         *(_SREQ_DIM.pack(d) for d in arr.shape),
         arr.tobytes()]
    )


def decode_request(payload: bytes):
    """(req_id, uint8 obs array) from one verified F_SREQ payload.
    Raises ValueError on a shape manifest that does not match the byte
    count — a well-framed-but-ill-formed request (E_BAD_REQUEST), NOT a
    torn frame (the crc already verified these bytes arrived intact)."""
    import numpy as np

    if len(payload) < _SREQ_HEAD.size:
        raise ValueError("request shorter than its header")
    req_id, ndim, dtype_code = _SREQ_HEAD.unpack_from(payload, 0)
    if dtype_code != 0:
        raise ValueError(f"unknown request dtype code {dtype_code}")
    if ndim > 8:
        raise ValueError(f"observation rank {ndim} > 8")
    off = _SREQ_HEAD.size
    if len(payload) < off + ndim * _SREQ_DIM.size:
        raise ValueError("request truncated inside its shape manifest")
    shape = tuple(
        _SREQ_DIM.unpack_from(payload, off + k * _SREQ_DIM.size)[0]
        for k in range(ndim)
    )
    off += ndim * _SREQ_DIM.size
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if len(payload) - off != n:
        raise ValueError(
            f"request body {len(payload) - off} B != shape {shape} ({n} B)"
        )
    arr = np.frombuffer(payload, np.uint8, n, off).reshape(shape)
    return int(req_id), arr.copy()  # own the memory past the recv buffer


def encode_reply(req_id: int, action: int, param_version: int,
                 q_values) -> bytes:
    import numpy as np

    q = np.ascontiguousarray(q_values, dtype=np.float32).reshape(-1)
    return _SREP_HEAD.pack(int(req_id), int(action), int(param_version),
                           q.size) + q.tobytes()


def decode_reply(payload: bytes):
    """(req_id, action, param_version, float32 q_values)."""
    import numpy as np

    req_id, action, version, num_q = _SREP_HEAD.unpack_from(payload, 0)
    q = np.frombuffer(payload, np.float32, num_q, _SREP_HEAD.size)
    return int(req_id), int(action), int(version), q.copy()


def encode_error(req_id: int, code: int, message: str = "") -> bytes:
    return _SERR_HEAD.pack(int(req_id), int(code)) + message.encode()[:512]


def decode_error(payload: bytes):
    """(req_id, code, message)."""
    req_id, code = _SERR_HEAD.unpack_from(payload, 0)
    return int(req_id), int(code), payload[_SERR_HEAD.size:].decode(
        errors="replace"
    )


# Batched inference (central actors, serving/central.py): one F_IREQ
# carries a whole observation-row group; the body is the F_XPB container
# (per-row encode_request records + in-request frame dedup + negotiated
# codec), so the obs→inference path has the experience plane's wire
# economy and its adversarial decode contract unchanged.
_IREQ_HEAD = struct.Struct("<QI4x")    # req_id, n_rows
_IREP_HEAD = struct.Struct("<QIIq")    # req_id, n_rows, n_actions, version
_MAX_IREQ_ROWS = 1 << 16


def _obs_record_spans(rec: bytes, ndim: int, shape) -> List[Tuple[int, int]]:
    """Dedup-candidate spans of one encode_request record: the leading-
    axis planes of the obs body (frame-stacked obs repeat stack−1 planes
    between rows that coincide) or the whole body when it doesn't carve."""
    off = _SREQ_HEAD.size + ndim * _SREQ_DIM.size
    body = len(rec) - off
    if body < _MIN_DEDUP_FRAME:
        return []
    rows = int(shape[0]) if ndim >= 2 else 1
    if rows > 0 and body % rows == 0 and body // rows >= _MIN_DEDUP_FRAME:
        fb = body // rows
        return [(off + r * fb, fb) for r in range(rows)]
    return [(off, body)]


def encode_inference_request(req_id: int, obs_batch, codec: int = CODEC_OFF,
                             dedup: bool = True):
    """(payload, stats) for one F_IREQ frame: head + xpb body of per-row
    ``encode_request`` records (row index in each record's id slot)."""
    import numpy as np

    arr = np.ascontiguousarray(obs_batch, dtype=np.uint8)
    if arr.ndim < 2:
        raise ValueError("inference request needs a [rows, ...] obs batch")
    n = arr.shape[0]
    if not 0 < n <= _MAX_IREQ_ROWS:
        raise ValueError(f"absurd inference row count {n}")
    records = [encode_request(i, arr[i]) for i in range(n)]
    spans = [
        _obs_record_spans(r, arr.ndim - 1, arr.shape[1:]) for r in records
    ] if dedup else None
    body, st = encode_xpb_payload(records, codec=codec, dedup=dedup,
                                  spans=spans)
    return _IREQ_HEAD.pack(int(req_id), n) + body, st


def decode_inference_request(payload, allow_zlib: bool = True,
                             max_bytes: int = _MAX_FRAME):
    """(req_id, [uint8 obs rows]) from one verified F_IREQ payload.
    Raises ValueError on any malformation — the frame crc already
    verified these bytes arrived intact, so the caller replies TYPED
    (E_BAD_REQUEST), mirroring the single-request path."""
    if len(payload) < _IREQ_HEAD.size:
        raise ValueError("inference request shorter than its header")
    req_id, n = _IREQ_HEAD.unpack_from(payload, 0)
    if not 0 < n <= _MAX_IREQ_ROWS:
        raise ValueError(f"absurd inference row count {n}")
    recs = decode_xpb_payload(
        memoryview(payload)[_IREQ_HEAD.size:], allow_zlib=allow_zlib,
        max_bytes=max_bytes,
    )
    if len(recs) != n:
        raise ValueError(
            f"inference request body has {len(recs)} rows, head says {n}"
        )
    rows = []
    for i, rec in enumerate(recs):
        rid, obs = decode_request(bytes(rec))
        if rid != i:
            raise ValueError(f"inference row {i} carries id {rid}")
        rows.append(obs)
    return int(req_id), rows


def encode_inference_reply(req_id: int, actions, param_version: int,
                           q_values) -> bytes:
    """One F_IREP payload: greedy actions + per-row q evidence + the
    version floor of the params that produced them (ε stays worker-side
    — the ladder partition is the fleet's, not the server's)."""
    import numpy as np

    a = np.ascontiguousarray(actions, dtype=np.int32).reshape(-1)
    q = np.ascontiguousarray(q_values, dtype=np.float32)
    q = q.reshape(a.size, -1)
    return _IREP_HEAD.pack(int(req_id), a.size, q.shape[1],
                           int(param_version)) + a.tobytes() + q.tobytes()


def decode_inference_reply(payload):
    """(req_id, int32 actions [N], param_version, float32 q [N, A]).
    Raises ValueError on a body that disagrees with its head."""
    import numpy as np

    if len(payload) < _IREP_HEAD.size:
        raise ValueError("inference reply shorter than its header")
    req_id, n, na, version = _IREP_HEAD.unpack_from(payload, 0)
    if not 0 < n <= _MAX_IREQ_ROWS or na > 1 << 20:
        raise ValueError("absurd inference reply geometry")
    off = _IREP_HEAD.size
    need = off + 4 * n + 4 * n * na
    if len(payload) != need:
        raise ValueError(
            f"inference reply {len(payload)} B != expected {need} B"
        )
    actions = np.frombuffer(payload, np.int32, n, off).copy()
    q = np.frombuffer(payload, np.float32, n * na, off + 4 * n)
    return int(req_id), actions, int(version), q.reshape(n, na).copy()


class FrameParser:
    """Incremental decoder of one connection's framed byte stream.

    ``feed`` raw recv bytes, ``next`` complete verified frames.  Any
    framing fault sets ``error`` and the parser yields nothing further —
    the caller counts a torn frame and retires the connection (the
    stream-level analogue of a torn ring tail: detected, never
    delivered).

    ``max_frame`` tightens the length-prefix sanity bound below the
    module default — the serving plane caps requests at
    ``serving.max_request_bytes`` so one absurd prefix cannot make the
    server buffer a GiB before the crc check would catch it.
    """

    def __init__(self, crc_full: bool = False,
                 max_frame: int = _MAX_FRAME):
        self._buf = bytearray()
        self._crc_full = bool(crc_full)
        self._max_frame = int(max_frame)
        self.seq = 0          # last accepted seq
        self.frames = 0
        self.bytes = 0        # raw bytes fed
        self.error: Optional[str] = None

    def feed(self, data) -> None:
        self.bytes += len(data)
        self._buf += data

    def pending(self) -> int:
        """Buffered bytes not yet a complete frame — nonzero at
        disconnect means the stream was truncated mid-frame (torn)."""
        return len(self._buf)

    def next(self) -> Optional[Tuple[int, bytes]]:
        """(kind, payload) of the next complete frame, else None."""
        if self.error is not None:
            return None
        if len(self._buf) < _FRAME.size:
            return None
        length, crc, seq, kind = _FRAME.unpack_from(self._buf, 0)
        if length > self._max_frame:
            self.error = "length"
            return None
        if len(self._buf) < _FRAME.size + length:
            return None
        payload = bytes(self._buf[_FRAME.size:_FRAME.size + length])
        if seq != self.seq + 1:
            self.error = "seq"
            return None
        if _crc_payload(payload, self._crc_full) != crc:
            self.error = "crc"
            return None
        del self._buf[:_FRAME.size + length]
        self.seq = seq
        self.frames += 1
        return kind, payload


class Backoff:
    """Exponential reconnect backoff with jitter — the in-process twin of
    the supervisor's RespawnPolicy arithmetic (base doubling per failure,
    capped, multiplicative jitter so a fleet-wide learner restart does
    not reconnect in lockstep).  Process-level respawn stays the pool
    supervisor's job; this only paces one worker's socket retries."""

    def __init__(self, base_s: float = 0.25, max_s: float = 5.0,
                 jitter: float = 0.25, seed: int = 0):
        import random

        self._base = float(base_s)
        self._max = float(max_s)
        self._jitter = float(jitter)
        self._rng = random.Random(seed ^ 0xB0FF)
        self._fails = 0
        self._next_ok = 0.0

    def ready(self) -> bool:
        return time.monotonic() >= self._next_ok

    def fail(self) -> None:
        self._fails += 1
        delay = min(self._max, self._base * (2 ** (self._fails - 1)))
        delay *= 1.0 + self._jitter * (2.0 * self._rng.random() - 1.0)
        self._next_ok = time.monotonic() + delay

    def reset(self) -> None:
        self._fails = 0
        self._next_ok = 0.0




# ---------------------------------------------------------------------------
# Wire-efficiency layers: the F_XPB batch container.
#
# Body layout (before the optional codec wrap):
#
#     u32 n_records | n_records x u32 record_len | segment stream
#
# The segment stream rebuilds the CONCATENATION of the original record
# payloads:
#
#     u8 0 (literal) | u32 len | len bytes
#     u8 1 (ref)     | u32 len | u64 offset into the reconstructed stream
#
# Refs only ever point BACKWARD into the stream decoded so far — the
# coalescing window — so decode is stateless per frame: a reconnect (fresh
# seq stream) carries no cross-frame dictionary to resynchronize.  The
# framed payload is ``u8 codec | body`` with body zlib-deflated when
# codec == CODEC_ZLIB; the frame crc covers these ENCODED bytes, and any
# decode surprise raises ValueError — counted torn, never ingested.
# ---------------------------------------------------------------------------

_BU32 = struct.Struct("<I")
_SEG_LIT = 0
_SEG_REF = 1
_SEGL = struct.Struct("<BI")          # literal: op, length
_SEGR = struct.Struct("<BIQ")         # ref: op, length, stream offset
_MAX_BATCH_RECORDS = 1 << 20
_MIN_DEDUP_FRAME = 64                 # don't chase sub-cacheline "frames"

# shm_ring's experience-record envelope + APXT prefix, mirrored here so
# the dedup encoder can walk a record WITHOUT importing shm_ring (this
# module stays standalone-loadable); the layout is shm_ring's.
_XP_ENVELOPE = struct.Struct("<B7xqdqqqqq")
_APXT_MAGIC = b"APXT"
_APXT_PREFIX = struct.Struct("<4sIQ")
_DEDUP_KEYS = frozenset(("obs", "next_obs", "frames"))
_DTYPE_SIZES = {
    "uint8": 1, "int8": 1, "bool": 1, "uint16": 2, "int16": 2,
    "float16": 2, "bfloat16": 2, "uint32": 4, "int32": 4, "float32": 4,
    "uint64": 8, "int64": 8, "float64": 8,
}


def _frame_spans(payload) -> List[Tuple[int, int]]:
    """(offset, nbytes) spans of the fixed-size uint8 observation frames
    inside one experience record, in stream order — the dedup encoder's
    candidate set.  Best-effort by design: any parse surprise returns []
    and the record ships as one literal (dedup is an optimization layered
    on a payload that stays byte-complete either way)."""
    try:
        mv = memoryview(payload)
        off = _XP_ENVELOPE.size
        magic, version, hlen = _APXT_PREFIX.unpack_from(mv, off)
        if magic != _APXT_MAGIC or version != 1:
            return []
        off += _APXT_PREFIX.size
        header = json.loads(bytes(mv[off:off + hlen]))
        off += hlen
        spans: List[Tuple[int, int]] = []
        for leaf in header["leaves"]:
            itemsize = _DTYPE_SIZES.get(leaf["dtype"])
            if itemsize is None:
                return []           # can't size this leaf: stop walking
            shape = leaf["shape"]
            n = 1
            for d in shape:
                n *= int(d)
            nbytes = n * itemsize
            path = leaf["path"]
            key = path[0].get("k") if len(path) == 1 else None
            if (key in _DEDUP_KEYS and leaf["dtype"] == "uint8"
                    and len(shape) >= 2 and int(shape[0]) > 0):
                rows = int(shape[0])
                fb = nbytes // rows
                if fb >= _MIN_DEDUP_FRAME and fb * rows == nbytes:
                    spans.extend(
                        (off + r * fb, fb) for r in range(rows)
                    )
            off += nbytes
        if off > len(mv):
            return []
        return spans
    except Exception:  # noqa: BLE001 — malformed candidate: no dedup
        return []


def encode_batch(records: Sequence[bytes], dedup: bool = True,
                 spans: Optional[Sequence] = None):
    """(body, stats) for one F_XPB batch.  With ``dedup``, observation
    frames repeated within the batch (n-step overlap makes obs[i+n] ==
    next_obs[i] inside one dense chunk) ship once; repeats become refs
    into the reconstructed stream.  Window lookups key the dict by the
    frame BYTES (one slice copy + one siphash per frame — measured
    cheaper than any crc-bucket scheme on this interpreter, and exact by
    construction: a ref is only ever emitted for full byte equality).

    ``spans`` (optional, one ``[(offset, nbytes), ...]`` list per record)
    overrides the APXT-walking candidate finder for records that are not
    experience chunks — the inference plane hands its own obs-plane
    spans.  Decode is unchanged either way: the container is
    span-agnostic (literals + backward refs)."""
    parts: List = [_BU32.pack(len(records))]
    parts += [_BU32.pack(len(r)) for r in records]
    seen: Dict[bytes, int] = {}   # frame bytes -> offset in the stream
    base = 0
    hits = saved = 0
    for ri, rec in enumerate(records):
        mrec = memoryview(rec)
        lit = 0
        rec_spans = () if not dedup else (
            spans[ri] if spans is not None else _frame_spans(rec)
        )
        for off, fb in rec_spans:
            prev = seen.setdefault(rec[off:off + fb], base + off)
            if prev == base + off:
                continue                 # first sighting: ships literal
            if off > lit:
                parts.append(_SEGL.pack(_SEG_LIT, off - lit))
                parts.append(mrec[lit:off])
            parts.append(_SEGR.pack(_SEG_REF, fb, prev))
            lit = off + fb
            hits += 1
            saved += fb
        if len(rec) > lit:
            parts.append(_SEGL.pack(_SEG_LIT, len(rec) - lit))
            parts.append(mrec[lit:] if lit else rec)
        base += len(rec)
    return b"".join(parts), {"dedup_hits": hits, "dedup_bytes": saved}


def decode_batch(body) -> List:
    """Record payloads from one F_XPB body, bit-identical to what
    ``encode_batch`` consumed — as READ-ONLY memoryviews over one shared
    reconstruction buffer (the zero-copy hand-off the shm reader makes
    to replay ingest; the buffer lives exactly as long as any record
    view does).  Raises ValueError on ANY malformation — truncated
    tables, a ref outside the decoded window, a stream that disagrees
    with its length table — the caller counts torn and retires the
    connection."""
    mv = memoryview(body)
    end = len(mv)
    if end < _BU32.size:
        raise ValueError("batch: truncated record count")
    (n,) = _BU32.unpack_from(mv, 0)
    if not 0 < n <= _MAX_BATCH_RECORDS:
        raise ValueError(f"batch: absurd record count {n}")
    off = _BU32.size * (1 + n)
    if end < off:
        raise ValueError("batch: truncated length table")
    lens = struct.unpack_from(f"<{n}I", mv, _BU32.size)
    total = sum(lens)
    if total > _MAX_FRAME:
        raise ValueError("batch: absurd logical size")
    # Preallocated reconstruction: segment copies land straight in place
    # (growth-free — this loop is on the learner's drain path).
    out = bytearray(total)
    mo = memoryview(out)
    pos = 0
    while off < end:
        op = mv[off]
        if op == _SEG_LIT:
            if off + _SEGL.size > end:
                raise ValueError("batch: truncated literal header")
            _, ln = _SEGL.unpack_from(mv, off)
            off += _SEGL.size
            if ln == 0 or off + ln > end:
                raise ValueError("batch: truncated literal")
            if pos + ln > total:
                raise ValueError("batch: stream overruns its length table")
            mo[pos:pos + ln] = mv[off:off + ln]
            pos += ln
            off += ln
        elif op == _SEG_REF:
            if off + _SEGR.size > end:
                raise ValueError("batch: truncated ref")
            _, ln, src = _SEGR.unpack_from(mv, off)
            off += _SEGR.size
            if ln == 0 or src + ln > pos:
                raise ValueError("batch: ref outside the decoded window")
            if pos + ln > total:
                raise ValueError("batch: stream overruns its length table")
            # src + ln <= pos (checked above): source and destination
            # never overlap.
            mo[pos:pos + ln] = mo[src:src + ln]
            pos += ln
        else:
            raise ValueError(f"batch: unknown segment op {op}")
    if pos != total:
        raise ValueError("batch: stream shorter than its length table")
    ro = mo.toreadonly()
    recs: List = []
    p = 0
    for ln in lens:
        recs.append(ro[p:p + ln])
        p += ln
    return recs


def encode_xpb_payload(records: Sequence[bytes], codec: int = CODEC_OFF,
                       dedup: bool = True, level: int = 1,
                       spans: Optional[Sequence] = None):
    """(payload, stats) — the framed F_XPB payload (codec byte + body).
    zlib only sticks when it actually shrinks the body (a batch of
    incompressible frames ships raw under the same codec negotiation)."""
    body, st = encode_batch(records, dedup=dedup, spans=spans)
    used = CODEC_OFF
    if codec == CODEC_ZLIB:
        comp = zlib.compress(body, level)
        if len(comp) < len(body):
            body = comp
            used = CODEC_ZLIB
    st["compressed"] = used == CODEC_ZLIB
    return bytes((used,)) + body, st


def decode_xpb_payload(payload, allow_zlib: bool = True,
                       max_bytes: int = _MAX_FRAME) -> List[bytes]:
    """Record payloads from one verified F_XPB frame payload.  A zlib
    body is bounded (``max_bytes``) against decompression bombs and must
    terminate its stream exactly (zlib's adler32 makes a mid-body bitflip
    the sampled frame crc missed fail HERE); a compressed payload on a
    connection whose hello negotiated codec off is a protocol violation.
    Every fault raises ValueError — torn, never ingested."""
    if len(payload) < 1:
        raise ValueError("batch: empty payload")
    codec = payload[0]
    body = memoryview(payload)[1:]
    if codec == CODEC_ZLIB:
        if not allow_zlib:
            raise ValueError("batch: compressed payload but codec "
                             "negotiated off")
        d = zlib.decompressobj()
        try:
            body = d.decompress(bytes(body), max_bytes + 1)
        except zlib.error as e:
            raise ValueError(f"batch: decompress failed: {e}") from None
        if (not d.eof or d.unconsumed_tail or d.unused_data
                or len(body) > max_bytes):
            raise ValueError("batch: decompress truncated/oversize")
    elif codec != CODEC_OFF:
        raise ValueError(f"batch: unknown codec {codec}")
    return decode_batch(body)
