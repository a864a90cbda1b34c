"""The tcp wire: CRC-framed experience, params and serving over TCP.

Port of ``ape_x_dqn_tpu/runtime/net.py``, byte for byte: a JAX writer can
feed a port transport and the other way round, and a JAX client can talk to
a port server (``tests/test_torch_net_transport.py`` and
``tests/test_torch_serving_net.py`` compare the bytes with the JAX
package's).

  * **Experience hello** (worker → learner, once per connection): v1 is
    ``4s magic "APXN" | u32 version | i64 worker_id | i64 attempt | i64
    token``; v2 appends ``u8 codec | u8 flags | 6x`` (the batch codec the
    writer proposes, bit 0 of flags: batch frames).  ``token`` is the
    pool's per-run secret and ``attempt`` the worker's incarnation: a
    writer of another run, or of an earlier incarnation, is rejected at the
    handshake.
  * **Serve hello** (client → server): v1 is ``4s magic "APXQ" | u32
    version``; v2 appends the fleet extension ``i64 worker_id | i64 attempt
    | i64 token | u8 codec | u8 flags | 6x`` (``HELLO_FLAG_TRACE`` makes
    every request payload lead with an i64 trace id).
  * **Frames** (both directions after the hello)::

        u32 len | u32 crc | i64 seq | u8 kind | 7x pad   + payload

    The crc covers the payload (head and tail 4 KiB windows past 8 KiB);
    ``seq`` runs from 1 per connection per direction.  Any framing fault —
    truncation, a crc mismatch, a seq skip, a length over the bound — is a
    torn frame: nothing of it is decoded, and the connection is retired.
    The writer reconnects with ``Backoff`` and a fresh seq stream.
  * **Experience kinds**: ``F_XP`` (one shm-ring record payload, byte for
    byte, so ``shm_ring.decode_chunk`` decodes either transport) and
    ``F_XPB`` (many records in one frame: the coalescing budget
    ``actor.net_coalesce_bytes``, in-window frame dedup, an optional zlib
    codec negotiated at the hello; every layer off keeps the v1 wire).
    The learner answers on the same connection with ``F_PARAM_FULL`` on
    connect and ``F_PARAM_DELTA`` page-deltas after (64 KiB pages over the
    serialized snapshot, crc-checked after the patch).
  * **Serving kinds**: ``F_SREQ`` / ``F_SREP`` / ``F_SERR`` (one
    observation, greedy action and q, typed refusal) and ``F_IREQ`` /
    ``F_IREP`` (a worker's batch of observation rows in the ``F_XPB``
    container; the greedy actions, q rows and the oldest param version
    that served them).

Standard library only at module scope (numpy is imported inside the codecs
that need it): a worker process imports this module before anything else,
and before it hides the card.
"""

from __future__ import annotations

import json
import secrets
import select
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NET_MAGIC = b"APXN"
_NET_VERSION = 1
_NET_VERSION_EXT = 2                  # v2 hello: v1 fields + _HELLO_EXT
_HELLO = struct.Struct("<4sIqqq")     # magic, version, worker_id, attempt, token
_HELLO_EXT = struct.Struct("<BB6x")   # codec id, flags (bit0: batch frames)

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
_CODEC_IDS = {"off": CODEC_OFF, "zlib": CODEC_ZLIB, "auto": CODEC_ZLIB}

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
_RECV_CHUNK = 1 << 18
_PARAM_PAGE = 64 << 10      # delta granule over the serialized snapshot
_PFULL = struct.Struct("<q")              # version
_PDELTA = struct.Struct("<qqIIII")        # version, base, full_crc,
#                                           page_size, total_pages, changed
_PIDX = struct.Struct("<I")

_SEND_SLICE = 1 << 18
_AUTO_OFF_FLUSHES = 256   # net_codec=auto: raw again after this many
#                           backpressure-free flushes

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


def _send_queue_bytes(sock: socket.socket) -> Optional[int]:
    """Bytes written but not yet acknowledged by the peer (Linux SIOCOUTQ);
    None where the platform cannot say."""
    try:
        import fcntl
        import termios

        return struct.unpack("i", fcntl.ioctl(sock.fileno(), termios.TIOCOUTQ,
                                              b"\0\0\0\0"))[0]
    except (ImportError, OSError, AttributeError):
        return None


def close_gracefully(sock: socket.socket, timeout_s: float = 2.0) -> None:
    """Close a connection this end is done writing to without resetting it.

    A plain ``close()`` with unread bytes in the receive buffer (a reply or
    a param push that arrived after the last read) makes the kernel send a
    reset, and a reset discards whatever this end wrote that still sits in
    its send queue: the peer reads a frame cut short and counts it torn.
    So: FIN after every byte already written, then read and discard what
    the peer sends until it has acknowledged every byte written (the send
    queue is empty: nothing is left to lose), it closes, or ``timeout_s``
    passes; then close."""
    try:
        sock.shutdown(socket.SHUT_WR)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and _send_queue_bytes(sock) != 0:
            if select.select([sock], [], [], 0.01)[0] and not sock.recv(_RECV_CHUNK):
                break
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def build_param_full(version: int, payload: bytes) -> bytes:
    return _PFULL.pack(int(version)) + payload


def build_param_delta(version: int, base_version: int, prev: bytes,
                      new: bytes, page: int = _PARAM_PAGE) -> Optional[bytes]:
    """Page-delta between two serialized snapshots, or None when a delta
    is impossible (size changed) or not worth it (the encoded delta is
    not meaningfully smaller than the full snapshot — a steady-state
    training publish touches every page, and then the full frame is the
    cheaper message)."""
    if len(prev) != len(new):
        return None
    # Small snapshots delta at fine granularity; big ones at the default
    # page so the per-page compare/index overhead stays negligible.
    page = min(page, max(256, len(new) // 64))
    total = (len(new) + page - 1) // page
    pv, nv = memoryview(prev), memoryview(new)
    changed: List[int] = []
    for i in range(total):
        s = i * page
        e = min(s + page, len(new))
        if pv[s:e] != nv[s:e]:
            changed.append(i)
    head = _PDELTA.pack(int(version), int(base_version), zlib.crc32(new),
                        page, total, len(changed))
    idx = b"".join(_PIDX.pack(i) for i in changed)
    pages = b"".join(
        bytes(nv[i * page:min(i * page + page, len(new))]) for i in changed
    )
    delta = head + idx + pages
    if len(delta) > 0.6 * (len(new) + _PFULL.size):
        return None
    return delta


def apply_param_delta(prev: bytes, payload: bytes) -> Tuple[int, int, bytes]:
    """(version, base_version, new blob) from one delta frame applied to
    ``prev``.  Raises ValueError on base mismatch or a crc that does not
    match the patched blob — the caller's recovery is the connection
    (drop → reconnect → full snapshot)."""
    version, base, full_crc, page, total, changed = _PDELTA.unpack_from(
        payload, 0
    )
    off = _PDELTA.size
    idxs = [
        _PIDX.unpack_from(payload, off + k * _PIDX.size)[0]
        for k in range(changed)
    ]
    off += changed * _PIDX.size
    blob = bytearray(prev)
    if (len(blob) + page - 1) // page != total:
        raise ValueError("param delta page count mismatch")
    for i in idxs:
        s = i * page
        e = min(s + page, len(blob))
        blob[s:e] = payload[off:off + (e - s)]
        off += e - s
    out = bytes(blob)
    if zlib.crc32(out) != full_crc:
        raise ValueError("param delta crc mismatch after patch")
    return version, base, out



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


# ---------------------------------------------------------------------------
# Learner side: listener + per-worker channels.
# ---------------------------------------------------------------------------


class NetChannel:
    """Learner-side endpoint of one worker incarnation's connection — the
    ring-reader surface ``ProcessActorPool`` sweeps (``read_next`` /
    ``torn_tail`` / ``committed`` / ``close``), so the pool's poll,
    salvage, lineage and stats paths are backend-agnostic.

    A channel outlives individual connections: a worker whose socket
    drops reconnects (fresh hello, same worker_id+attempt) and the
    channel adopts the new socket, counting the reconnect and treating
    any half-received frame from the old one as torn.
    """

    def __init__(self, wid: int, attempt: int, drain_budget: int,
                 crc_full: bool = False):
        self.wid = int(wid)
        self.attempt = int(attempt)
        self._drain_budget = max(1 << 16, int(drain_budget))
        self._crc_full = bool(crc_full)
        self._sock: Optional[socket.socket] = None
        self._parser = FrameParser(crc_full=crc_full)
        self._send_lock = threading.Lock()
        self._out_seq = 0
        self._ready: List[Tuple[int, bytes]] = []
        self.records_read = 0
        self.bytes_read = 0          # delivered frames (header + payload)
        self.raw_bytes_in = 0        # everything recv'd, incl. torn tails
        self.reconnects = 0
        self.torn_frames = 0
        self.param_sent_version = -1
        self.param_full_sent = 0
        self.param_delta_sent = 0
        self.param_bytes_sent = 0
        self._ever_connected = False
        self.full_waits = 0          # backpressure lives worker-side (0)
        # Wire-efficiency accounting:
        # wire bytes are raw_bytes_in; these count the LOGICAL side.
        self.codec = CODEC_OFF       # negotiated at adopt (v2 hello ext)
        self.wire_frames = 0         # accepted xp wire frames (F_XP|F_XPB)
        self.coalesced_frames = 0    # F_XPB batches among them
        self.codec_frames = 0        # compressed batches among those
        self.logical_bytes = 0       # decoded record bytes delivered
        self.decode_s = 0.0          # batch decompress+reconstruct time
        self._rbuf = bytearray(_RECV_CHUNK)  # persistent recv_into scratch

    # -- connection lifecycle ---------------------------------------------

    def adopt(self, sock: socket.socket, codec: int = CODEC_OFF) -> None:
        """Route a freshly-handshaked connection here.  A live previous
        connection is retired first (its partial frame, if any, counts
        torn — same as a disconnect).  ``codec`` is the hello-negotiated
        batch codec this connection may use; a compressed batch on an
        off-codec connection decodes as a protocol violation."""
        with self._send_lock:
            if self._sock is not None or self._ever_connected:
                self.reconnects += int(self._ever_connected)
            self._retire_conn_locked()
            sock.setblocking(False)
            self._sock = sock
            self._parser = FrameParser(crc_full=self._crc_full)
            self._out_seq = 0
            self.codec = int(codec)
            self.param_sent_version = -1
            self._ever_connected = True

    def _accept_frame(self, kind: int, payload: bytes) -> bool:
        """Route one crc/seq-verified frame into the ready queue; False =
        protocol violation (wrong kind, un-negotiated codec, or a batch
        that fails to decode) — the caller counts torn and retires."""
        if kind == F_XP:
            self._ready.append((kind, payload))
            self.wire_frames += 1
            self.logical_bytes += len(payload)
            return True
        if kind == F_XPB:
            t0 = time.perf_counter()
            try:
                recs = decode_xpb_payload(
                    payload, allow_zlib=self.codec != CODEC_OFF
                )
            except ValueError:
                return False
            self.decode_s += time.perf_counter() - t0
            self.wire_frames += 1
            self.coalesced_frames += 1
            self.codec_frames += int(payload[:1] == b"\x01")
            for r in recs:
                self._ready.append((F_XP, r))
                self.logical_bytes += len(r)
            return True
        return False

    def _retire_conn_locked(self) -> None:
        # Deliver every frame that already verified BEFORE declaring the
        # remainder torn — a disconnect must not discard committed
        # records buffered ahead of the torn tail (the ring's
        # drain-then-torn salvage order).
        while True:
            got = self._parser.next()
            if got is None:
                break
            if not self._accept_frame(*got):
                self.torn_frames += 1
                self._parser = FrameParser(crc_full=self._crc_full)
                break
        if self._parser.pending() or self._parser.error is not None:
            self.torn_frames += 1
            self._parser = FrameParser(crc_full=self._crc_full)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    @property
    def connected(self) -> bool:
        return self._sock is not None

    # -- reader surface (the ring interface) ------------------------------

    def _pump_recv(self) -> None:
        sock = self._sock
        if sock is None:
            return
        budget = self._drain_budget
        while budget > 0:
            try:
                # recv_into the persistent scratch: no per-sweep bytes
                # allocation on the hot drain path (the parser's append
                # is the one remaining copy).
                n = sock.recv_into(self._rbuf, min(_RECV_CHUNK, budget))
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                with self._send_lock:
                    self._retire_conn_locked()
                return
            if n == 0:
                # Orderly close: a truncated frame in the buffer is torn.
                with self._send_lock:
                    self._retire_conn_locked()
                return
            budget -= n
            self.raw_bytes_in += n
            self._parser.feed(memoryview(self._rbuf)[:n])

    def _drain_parser(self) -> None:
        while True:
            got = self._parser.next()
            if got is None:
                if self._parser.error is not None:
                    # Unrecoverable stream: torn, retire the connection —
                    # the writer's reconnect is the resync point.
                    with self._send_lock:
                        self._retire_conn_locked()
                return
            if not self._accept_frame(*got):
                # Protocol violation from a worker (param kinds only flow
                # learner→worker; an undecodable batch is stream
                # corruption however well it framed).
                self.torn_frames += 1
                with self._send_lock:
                    self._retire_conn_locked()
                return

    def read_next(self) -> Optional[bytes]:
        """The next verified experience payload, or None — the exact
        ShmRing.read_next contract (bounded work per call: one budgeted
        recv sweep)."""
        if not self._ready:
            self._pump_recv()
            self._drain_parser()
        if not self._ready:
            return None
        _, payload = self._ready.pop(0)
        self.records_read += 1
        self.bytes_read += _FRAME.size + len(payload)
        return payload

    def torn_tail(self) -> bool:
        """After the writer is gone and the channel drained: did any
        stream end mid-frame / fail verification?  (Cumulative over the
        channel's connections — the salvage counter's contract.)"""
        if self._parser.pending() or self._parser.error is not None:
            return True
        return self.torn_frames > 0

    @property
    def torn_live(self) -> int:
        """Torn count safe to read on a LIVE channel: a partial frame
        still arriving on a connected socket is mid-receive, not torn —
        only a dead connection's leftover (or a parser fault) counts."""
        return self.torn_frames + int(
            self._parser.error is not None
            or (self._parser.pending() > 0 and not self.connected)
        )

    @property
    def started(self) -> int:
        return self.records_read + len(self._ready) + (
            1 if (self._parser.pending() or self._parser.error) else 0
        )

    @property
    def committed(self) -> int:
        return self.records_read + len(self._ready)

    @property
    def committed_bytes(self) -> int:
        return self.raw_bytes_in

    # -- param push (learner → worker) ------------------------------------

    def send_frame(self, kind: int, payload: bytes,
                   timeout: float = 2.0) -> bool:
        """Bounded send of one learner→worker frame.  On timeout or error
        the connection is dropped (a slow/stuck subscriber must not stall
        the publish fan-out; the worker reconnects and gets a full
        snapshot) — False is returned either way."""
        with self._send_lock:
            sock = self._sock
            if sock is None:
                return False
            buf = memoryview(frame_bytes(kind, self._out_seq + 1, [payload],
                                         self._crc_full))
            deadline = time.monotonic() + timeout
            off = 0
            while off < len(buf):
                try:
                    off += sock.send(buf[off:off + _SEND_SLICE])
                except (BlockingIOError, InterruptedError):
                    if time.monotonic() > deadline:
                        self._retire_conn_locked()
                        return False
                    select.select([], [sock], [], 0.05)
                except OSError:
                    self._retire_conn_locked()
                    return False
            self._out_seq += 1
            return True

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        # Settle accounting BEFORE dropping the socket: bytes the kernel
        # already buffered may still complete frames (they are simply
        # discarded unread — close is teardown, not salvage; salvage
        # drains via read_next first).
        self._pump_recv()
        self._drain_parser()
        with self._send_lock:
            self._retire_conn_locked()

    def unlink(self) -> None:  # shm-interface parity: nothing on disk
        pass


class NetTransport:
    """Learner-side TCP transport: one nonblocking listener, one
    ``NetChannel`` per live worker incarnation, and the param fan-out.

    ``pump()`` (called from the pool's poll sweep) accepts pending
    connections, completes hellos, routes each to its channel — rejecting
    stale tokens/attempts — and pushes the current param snapshot to
    fresh connections.  ``set_params`` fans a new version out to every
    connected worker as delta-or-full frames, recording the cost per
    push.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 drain_budget_per_conn: int = 1 << 20,
                 conn_buf_bytes: int = 1 << 20, crc_full: bool = False,
                 hello_timeout_s: float = 5.0, codec: str = "off"):
        if codec not in _CODEC_IDS:
            raise ValueError(f"unknown net codec: {codec}")
        self.host = host
        self._conn_buf = int(conn_buf_bytes)
        self._drain_budget = int(drain_budget_per_conn)
        self._crc_full = bool(crc_full)
        self._hello_timeout = float(hello_timeout_s)
        # Accept policy for v2 hellos: "off" admits only codec-off
        # writers; "zlib"/"auto" additionally admit zlib-capable ones.
        self._codec_policy = codec
        self._accept_codecs = (
            {CODEC_OFF} if codec == "off" else {CODEC_OFF, CODEC_ZLIB}
        )
        self.codec_rejects = 0
        self.token = secrets.randbits(63) or 1
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(512)
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self._lock = threading.RLock()
        self._channels: Dict[int, NetChannel] = {}
        self._pending: List[list] = []   # [sock, bytearray, deadline]
        self.rejects = 0
        self.param_pushes = 0
        self.param_bytes = 0
        self.param_full = 0
        self.param_delta = 0
        self.param_drops = 0
        self.param_fanout_ms_total = 0.0
        self.param_last_push: Optional[dict] = None
        self._param_payload: Optional[bytes] = None
        self._param_version = 0
        self._param_prev: Optional[bytes] = None
        self._param_prev_version = -1
        self._rate_t = time.monotonic()
        self._rate_bytes = 0
        # Retired-channel accumulators: a respawned worker's old channel
        # (or the whole fleet at stop) must not take its traffic history
        # with it — stats() reports base + live sums, the pool's
        # _full_waits_base discipline.
        self._base = {"bytes_in": 0, "frames_in": 0, "torn_frames": 0,
                      "reconnects": 0, "logical_bytes": 0, "wire_frames": 0,
                      "coalesced_frames": 0, "codec_frames": 0,
                      "decode_s": 0.0}
        self._closed = False

    # -- channel registry --------------------------------------------------

    def make_channel(self, wid: int, attempt: int) -> NetChannel:
        """A fresh channel for one worker incarnation (the per-incarnation
        ring's twin — the pool replaces it on respawn, so a zombie
        previous incarnation can never write into the new stream)."""
        ch = NetChannel(wid, attempt, self._drain_budget,
                        crc_full=self._crc_full)
        with self._lock:
            self._channels[wid] = ch
        return ch

    def _fold_retired_locked(self, ch: NetChannel) -> None:
        self._base["bytes_in"] += ch.raw_bytes_in
        self._base["frames_in"] += ch.records_read + len(ch._ready)
        self._base["torn_frames"] += ch.torn_live
        self._base["reconnects"] += ch.reconnects
        self._base["logical_bytes"] += ch.logical_bytes
        self._base["wire_frames"] += ch.wire_frames
        self._base["coalesced_frames"] += ch.coalesced_frames
        self._base["codec_frames"] += ch.codec_frames
        self._base["decode_s"] += ch.decode_s

    def drop_channel(self, wid: int, channel: NetChannel) -> None:
        with self._lock:
            if self._channels.get(wid) is channel:
                del self._channels[wid]
                self._fold_retired_locked(channel)

    # -- accept/handshake pump ---------------------------------------------

    def pump(self) -> None:
        if self._closed:
            return
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                self._conn_buf)
            except OSError:
                pass
            self._pending.append(
                [sock, bytearray(), time.monotonic() + self._hello_timeout]
            )
        still = []
        for ent in self._pending:
            sock, buf, deadline = ent
            try:
                # v1 hellos are _HELLO.size bytes; a v2 version word
                # promises a feature extension right behind it.
                need = _HELLO.size
                if len(buf) >= _HELLO.size:
                    need += _HELLO_EXT.size * int(
                        _HELLO.unpack_from(buf, 0)[1] == _NET_VERSION_EXT
                    )
                while len(buf) < need:
                    data = sock.recv(need - len(buf))
                    if not data:
                        raise OSError("eof before hello")
                    buf += data
                    if len(buf) == _HELLO.size and \
                            _HELLO.unpack_from(buf, 0)[1] == _NET_VERSION_EXT:
                        need = _HELLO.size + _HELLO_EXT.size
            except (BlockingIOError, InterruptedError):
                if time.monotonic() > deadline:
                    self.rejects += 1
                    sock.close()
                else:
                    still.append(ent)
                continue
            except OSError:
                self.rejects += 1
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            self._route(sock, bytes(buf))
        self._pending = still

    def _route(self, sock: socket.socket, hello: bytes) -> None:
        conn_codec = CODEC_OFF
        try:
            magic, version, wid, attempt, token = _HELLO.unpack_from(
                hello, 0
            )
            if version == _NET_VERSION_EXT:
                if len(hello) != _HELLO.size + _HELLO_EXT.size:
                    raise struct.error("v2 hello without its extension")
                conn_codec, _flags = _HELLO_EXT.unpack_from(
                    hello, _HELLO.size
                )
            elif len(hello) != _HELLO.size:
                raise struct.error("hello length mismatch")
        except struct.error:
            magic = b""
            version = wid = attempt = token = -1
        with self._lock:
            ch = self._channels.get(wid)
            ok = (
                magic == _NET_MAGIC
                and version in (_NET_VERSION, _NET_VERSION_EXT)
                and token == self.token and ch is not None
                and ch.attempt == attempt
            )
            if ok and conn_codec not in self._accept_codecs:
                # Codec-mismatch hello: the writer proposes a codec this
                # transport's policy refuses — reject BEFORE any framing
                # state exists (the adversarial-decode contract's
                # handshake rung), counted separately for the operator.
                self.codec_rejects += 1
                ok = False
            if not ok:
                self.rejects += 1
                try:
                    sock.close()
                except OSError:
                    pass
                return
            ch.adopt(sock, codec=conn_codec)
            payload, pversion = self._param_payload, self._param_version
        # Fresh connection: the current snapshot rides down immediately
        # (full — the worker has no baseline), so a worker that connects
        # after the first publish still syncs without waiting a cadence.
        if payload is not None:
            if ch.send_frame(F_PARAM_FULL,
                             build_param_full(pversion, payload)):
                ch.param_sent_version = pversion
                ch.param_full_sent += 1
                ch.param_bytes_sent += len(payload)
                self.param_full += 1
                self.param_bytes += len(payload)
            else:
                self.param_drops += 1

    # -- param fan-out ------------------------------------------------------

    def set_params(self, payload: bytes, version: int) -> dict:
        """Fan one published version out to every connected worker —
        delta against the previous push where the worker holds it, full
        otherwise.  Returns the per-push cost record (also kept as
        ``param_last_push`` for the stats surface)."""
        t0 = time.perf_counter()
        with self._lock:
            prev, prev_v = self._param_payload, self._param_version
            self._param_prev, self._param_prev_version = prev, prev_v
            self._param_payload, self._param_version = payload, int(version)
            channels = list(self._channels.values())
        delta = None
        if prev is not None:
            delta = build_param_delta(version, prev_v, prev, payload)
        sent_full = sent_delta = sent_bytes = drops = 0
        for ch in channels:
            if not ch.connected:
                continue
            if delta is not None and ch.param_sent_version == prev_v:
                if ch.send_frame(F_PARAM_DELTA, delta):
                    ch.param_sent_version = int(version)
                    ch.param_delta_sent += 1
                    ch.param_bytes_sent += len(delta)
                    sent_delta += 1
                    sent_bytes += len(delta)
                else:
                    drops += 1
                continue
            full = build_param_full(version, payload)
            if ch.send_frame(F_PARAM_FULL, full):
                ch.param_sent_version = int(version)
                ch.param_full_sent += 1
                ch.param_bytes_sent += len(full)
                sent_full += 1
                sent_bytes += len(full)
            else:
                drops += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.param_pushes += 1
        self.param_full += sent_full
        self.param_delta += sent_delta
        self.param_bytes += sent_bytes
        self.param_drops += drops
        self.param_fanout_ms_total += ms
        push = {
            "version": int(version),
            "subscribers": sent_full + sent_delta,
            "full": sent_full,
            "delta": sent_delta,
            "bytes": sent_bytes,
            "delta_bytes": len(delta) if delta is not None else None,
            "fanout_ms": round(ms, 3),
            "drops": drops,
        }
        self.param_last_push = push
        return push

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        """The JSONL ``net`` section, the JAX package's key set (pinned
        by ``tests/test_torch_net_transport.py``)."""
        with self._lock:
            channels = list(self._channels.values())
            base = dict(self._base)
        bytes_in = base["bytes_in"] + sum(c.raw_bytes_in for c in channels)
        logical = base["logical_bytes"] + sum(
            c.logical_bytes for c in channels
        )
        wire_frames = base["wire_frames"] + sum(
            c.wire_frames for c in channels
        )
        frames_in = base["frames_in"] + sum(
            c.records_read + len(c._ready) for c in channels
        )
        now = time.monotonic()
        dt = max(1e-3, now - self._rate_t)
        rate = max(0.0, bytes_in - self._rate_bytes) / dt
        if dt >= 0.2:
            self._rate_t, self._rate_bytes = now, bytes_in
        return {
            "connections": sum(1 for c in channels if c.connected),
            "expected": len(channels),
            "bytes_in": bytes_in,
            "bytes_in_per_s": round(rate, 1),
            "frames_in": frames_in,
            # Wire-efficiency surface: logical bytes are the decoded APXT
            # record bytes replay ingest sees; wire bytes (bytes_in) fall
            # below them when dedup/compression are winning.
            "logical_bytes_in": logical,
            "wire_over_logical": (
                round(bytes_in / logical, 4) if logical else None
            ),
            "wire_frames_in": wire_frames,
            "coalesced_frames_in": base["coalesced_frames"] + sum(
                c.coalesced_frames for c in channels
            ),
            "records_per_frame": round(
                frames_in / max(1, wire_frames), 2
            ),
            "codec": self._codec_policy,
            "codec_frames_in": base["codec_frames"] + sum(
                c.codec_frames for c in channels
            ),
            "codec_ms": round(1e3 * (base["decode_s"] + sum(
                c.decode_s for c in channels
            )), 1),
            "codec_rejects": self.codec_rejects,
            "torn_frames": base["torn_frames"] + sum(
                c.torn_live for c in channels
            ),
            "reconnects": base["reconnects"] + sum(
                c.reconnects for c in channels
            ),
            "rejects": self.rejects,
            "param_pushes": self.param_pushes,
            "param_full": self.param_full,
            "param_delta": self.param_delta,
            "param_bytes": self.param_bytes,
            "param_drops": self.param_drops,
            "param_fanout_ms_last": (
                self.param_last_push["fanout_ms"]
                if self.param_last_push else None
            ),
            "param_fanout_ms_mean": round(
                self.param_fanout_ms_total / max(1, self.param_pushes), 3
            ),
            "param_last_push": self.param_last_push,
        }

    def close(self) -> None:
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass
        for ent in self._pending:
            try:
                ent[0].close()
            except OSError:
                pass
        self._pending = []
        with self._lock:
            for ch in self._channels.values():
                try:
                    ch.close()
                except OSError:
                    pass
                self._fold_retired_locked(ch)
            self._channels.clear()


# ---------------------------------------------------------------------------
# Worker side.
# ---------------------------------------------------------------------------


class NetWriter:
    """Worker-side end of the transport: the ShmRing-writer surface
    (``write(parts, should_stop, ...)``) over a TCP connection, plus the
    param subscription riding the same socket in reverse.

    Backpressure comes from the kernel send buffer instead of ring
    occupancy — a blocked send counts ``full_waits`` exactly like a
    ring-full sleep.  On any socket error the writer reconnects with
    jittered exponential backoff (``Backoff``) and re-sends the frame in
    flight whole.  Delivery contract at a connection loss: the ONE frame
    in flight may be duplicated (send errored, re-sent whole — a
    duplicate experience chunk is harmless to replay) or lost (the
    kernel accepted it before the peer's reset — experience streams are
    loss-tolerant by design; the pool's respawn/salvage discipline is
    what bounds it); every other frame is exactly-once, and the
    per-connection seq stream guarantees no SILENT gaps within a
    connection.
    """

    def __init__(self, spec: dict, crc_full: bool = False):
        self.host = spec["host"]
        self.port = int(spec["port"])
        self.wid = int(spec["wid"])
        self.attempt = int(spec["attempt"])
        self.token = int(spec["token"])
        self._conn_buf = int(spec.get("conn_buf", 1 << 20))
        self._crc_full = bool(crc_full)
        # Wire-efficiency knobs (spec defaults keep legacy specs — tests,
        # old tooling — on the bit-identical v1 wire).
        self._codec = str(spec.get("codec", "off"))
        if self._codec not in _CODEC_IDS:
            raise ValueError(f"unknown net codec: {self._codec}")
        self._coalesce = int(spec.get("coalesce", 0))
        self._coal_wait_ms = float(spec.get("coalesce_wait_ms", 20.0))
        self._dedup = bool(spec.get("dedup", True))
        self._features = self._codec != "off" or self._coalesce > 0
        self._coal: List[bytes] = []
        self._coal_bytes = 0
        self._coal_t0 = 0.0
        # net_codec=auto control loop: compress only while the kernel
        # buffer backpressures (full_waits growing); fall back to raw
        # after a long quiet spell so fast links stop paying codec CPU.
        self._auto_on = False
        self._auto_idle = 0
        self._auto_fw_mark = 0
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._parser = FrameParser(crc_full=crc_full)
        self._backoff = Backoff(seed=(self.wid << 8) ^ self.attempt)
        self.full_waits = 0
        self.reconnects = 0
        self.records_written = 0
        self.bytes_written = 0       # wire bytes (frames as sent)
        self.logical_bytes_out = 0   # record bytes before encoding
        self.flushes = 0             # F_XPB frames sent
        self.compressed_frames = 0
        self.dedup_ref_bytes = 0     # bytes replaced by window refs
        self.codec_s = 0.0           # encode (dedup scan + deflate) time
        self.param_crc_errors = 0
        self._param_payload: Optional[bytes] = None
        self._param_version = -1
        self._ever_connected = False

    # -- connection management ---------------------------------------------

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def ensure_connected(self) -> bool:
        """One bounded connect attempt when the backoff window allows —
        callers poll (the write loop, pump_params) rather than block."""
        if self._sock is not None:
            return True
        if not self._backoff.ready():
            return False
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=2.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self._conn_buf)
            except OSError:
                pass
            hello = _HELLO.pack(
                _NET_MAGIC,
                _NET_VERSION_EXT if self._features else _NET_VERSION,
                self.wid, self.attempt, self.token,
            )
            if self._features:
                # v2 extension: propose the codec capability ("auto"
                # proposes zlib — whether a given frame compresses is the
                # writer's per-flush decision) + the batch-frames flag.
                hello += _HELLO_EXT.pack(_CODEC_IDS[self._codec], 1)
            sock.sendall(hello)
            sock.setblocking(False)
        except OSError:
            self._backoff.fail()
            return False
        self._sock = sock
        self._seq = 0
        self._parser = FrameParser(crc_full=self._crc_full)
        self._backoff.reset()
        self.reconnects += int(self._ever_connected)
        self._ever_connected = True
        return True

    # -- experience writes (the ring-writer surface) -----------------------

    def _send_frame(self, kind: int, payload: bytes,
                    should_stop: Optional[Callable] = None,
                    sleep_s: float = 0.001,
                    deadline: Optional[float] = None) -> bool:
        """Blocking send of one frame with backpressure and reconnect;
        aborts (False) on ``should_stop`` or the deadline.  On a mid-send
        connection loss the frame is rebuilt whole against the fresh
        connection's seq stream (the documented at-most-one-duplicate
        contract)."""
        buf: Optional[memoryview] = None
        off = 0
        while True:
            if should_stop is not None and should_stop():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self._sock is None:
                buf = None
                if not self.ensure_connected():
                    time.sleep(sleep_s)
                    continue
            if buf is None:
                buf = memoryview(
                    _FRAME.pack(len(payload),
                                _crc_payload(payload, self._crc_full),
                                self._seq + 1, kind) + payload
                )
                off = 0
            try:
                off += self._sock.send(buf[off:off + _SEND_SLICE])
            except (BlockingIOError, InterruptedError):
                # Kernel buffer full: the socket twin of a ring-full sleep.
                self.full_waits += 1
                self.pump_params()
                select.select([], [self._sock], [], sleep_s)
                continue
            except OSError:
                self._drop_conn()
                self._backoff.fail()
                continue
            if off >= len(buf):
                self._seq += 1
                self.bytes_written += len(buf)
                self.pump_params()
                return True

    def write(self, parts: Sequence, should_stop: Optional[Callable] = None,
              sleep_s: float = 0.001, timeout: Optional[float] = None) -> bool:
        """Blocking send of one experience record with backpressure and
        reconnect; aborts (False) on ``should_stop`` or ``timeout`` —
        the exact ShmRing.write contract.  With the wire-efficiency
        layers enabled the record lands in the coalescing buffer and the
        wire send happens at the flush boundary (budget reached, max-wait
        elapsed, or an explicit ``flush()``)."""
        payload = b"".join(_as_bytes(p) for p in parts)
        deadline = time.monotonic() + timeout if timeout else None
        if not self._features:
            # Legacy path: one F_XP frame per record, bit-identical to
            # the v1 wire format.
            if not self._send_frame(F_XP, payload, should_stop, sleep_s,
                                    deadline):
                return False
            self.records_written += 1
            self.logical_bytes_out += len(payload)
            return True
        now = time.monotonic()
        if not self._coal:
            self._coal_t0 = now
        self._coal.append(payload)
        self._coal_bytes += len(payload)
        if (self._coalesce <= 0
                or self._coal_bytes >= self._coalesce
                or (now - self._coal_t0) * 1e3 >= self._coal_wait_ms):
            return self._flush(should_stop, sleep_s, deadline)
        return True

    def _effective_codec(self) -> int:
        if self._codec == "zlib":
            return CODEC_ZLIB
        if self._codec == "auto" and self._auto_on:
            return CODEC_ZLIB
        return CODEC_OFF

    def _auto_update(self) -> None:
        if self._codec != "auto":
            return
        if self.full_waits > self._auto_fw_mark:
            self._auto_fw_mark = self.full_waits
            self._auto_on = True
            self._auto_idle = 0
        elif self._auto_on:
            self._auto_idle += 1
            if self._auto_idle >= _AUTO_OFF_FLUSHES:
                self._auto_on = False

    def _flush(self, should_stop: Optional[Callable] = None,
               sleep_s: float = 0.001,
               deadline: Optional[float] = None) -> bool:
        if not self._coal:
            return True
        records = self._coal
        n_logical = self._coal_bytes
        self._coal = []
        self._coal_bytes = 0
        t0 = time.perf_counter()
        payload, st = encode_xpb_payload(
            records, codec=self._effective_codec(), dedup=self._dedup
        )
        self.codec_s += time.perf_counter() - t0
        self.dedup_ref_bytes += st["dedup_bytes"]
        ok = self._send_frame(F_XPB, payload, should_stop, sleep_s,
                              deadline)
        if ok:
            self.flushes += 1
            self.compressed_frames += int(st["compressed"])
            self.records_written += len(records)
            self.logical_bytes_out += n_logical
        self._auto_update()
        return ok

    def flush(self, should_stop: Optional[Callable] = None,
              sleep_s: float = 0.001,
              timeout: Optional[float] = None) -> bool:
        """Push any coalesced records to the wire now (quantum
        boundaries, teardown) — no-op on the legacy path."""
        deadline = time.monotonic() + timeout if timeout else None
        return self._flush(should_stop, sleep_s, deadline)

    # -- param subscription -------------------------------------------------

    def pump_params(self) -> None:
        """Drain learner→worker frames (nonblocking).  A delta that fails
        to apply — wrong base, crc mismatch after patch — drops the
        connection: the reconnect's full snapshot is the recovery, and
        the stale params stay served meanwhile (never torn ones)."""
        if self._sock is None:
            self.ensure_connected()
            if self._sock is None:
                return
        while True:
            try:
                data = self._sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop_conn()
                self._backoff.fail()
                return
            if not data:
                self._drop_conn()
                self._backoff.fail()
                return
            self._parser.feed(data)
        while True:
            got = self._parser.next()
            if got is None:
                if self._parser.error is not None:
                    self._drop_conn()
                    self._backoff.fail()
                return
            kind, payload = got
            try:
                if kind == F_PARAM_FULL:
                    (version,) = _PFULL.unpack_from(payload, 0)
                    self._param_payload = payload[_PFULL.size:]
                    self._param_version = int(version)
                elif kind == F_PARAM_DELTA:
                    if self._param_payload is None:
                        raise ValueError("delta with no baseline")
                    version, base, blob = apply_param_delta(
                        self._param_payload, payload
                    )
                    if base != self._param_version:
                        raise ValueError("delta base version mismatch")
                    self._param_payload = blob
                    self._param_version = int(version)
                # Unknown kinds: ignored (forward compatibility).
            except ValueError:
                self.param_crc_errors += 1
                self._drop_conn()
                self._backoff.fail()
                return

    def latest_params(self) -> Optional[Tuple[bytes, int]]:
        if self._param_payload is None:
            return None
        return self._param_payload, self._param_version

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        # Orderly teardown flushes the coalescing buffer (bounded — a
        # dead learner must not wedge a stopping worker); a SIGKILL loses
        # it, exactly like bytes the kernel hadn't flushed.
        if self._coal and self._ever_connected:
            try:
                self._flush(deadline=time.monotonic() + 2.0)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if self._sock is not None:
            close_gracefully(self._sock)
            self._sock = None
