"""Replay as a service — a fault-tolerant sharded replay fleet.

Port of ``ape_x_dqn_tpu/replay/service.py``.  Every wire struct and
constant, the endpoints file and the shard's announce document are the JAX
package's byte for byte: a client of either package talks to a shard of
the other, and a chain one package's shard commits is restored by the
other's.  The module is numpy over the port's net/shm codecs, and a shard
process loads no torch at all (``types.py`` imports it for annotations
only); the fleet also spawns shards with ``CUDA_VISIBLE_DEVICES`` empty, so
none ever holds a CUDA context.

Ape-X names the central replay as its scaling bottleneck; this module lets
N learner processes sample one shared replay fleet and survive a replay
process dying:

  * **Shard servers** (:class:`ReplayShardServer`): a replay-hosting
    process speaking framed RPCs (``sample`` / ``add`` /
    ``update_priorities`` / ``state_digest`` / ``stats``) over the
    runtime/net.py frame discipline (``u32 len | u32 crc | i64 seq |
    u8 kind``).  Torn, bitflipped, oversize and out-of-seq frames are
    counted and never decoded: the connection retires.  add/sample bodies
    are F_XPB-encoded (in-window frame dedup + negotiated zlib).
  * **Sharding by slot range**: the global slot space ``[0, capacity)``
    splits into equal ranges, one plain :class:`PrioritizedReplay` per
    shard; clients map local↔global by the shard's base offset, adds
    route round-robin over healthy shards, priority updates route by
    ``index // shard_capacity``.
  * **Retrying clients** (:class:`ShardClient` per shard,
    :class:`ShardedReplayClient` over the fleet): per-request deadline,
    jittered exponential backoff that resets only on a verified reply,
    whole-request retry across reconnects, and graceful degradation —
    while a shard is down the learner samples and adds against the
    survivors, write-backs to the dead shard buffer last-write-wins and
    flush on recovery, and the failure surface is the typed
    :class:`ReplayShardUnavailable` plus a degraded ``replay_svc`` health
    component, never a wedge.
  * **At-most-once adds**: every logical ``add`` carries one req_id for
    its whole retry span; the shard remembers each client's last applied
    add and answers a retried duplicate from cache without re-applying.
    Re-routing an add to a different shard after a deadline is
    at-least-once across the fleet by design.
  * **Supervision + recovery** (:class:`ReplayServiceFleet`): shard
    processes respawn under the supervisor's RespawnPolicy, each
    incarnation recovers from the shard's own incremental checkpoint
    chain (``utils/checkpoint_inc``), announces a fresh incarnation, and
    the fleet rewrites the endpoints file atomically.  A mid-run SIGKILL
    yields a restore whose ``state_digest`` equals the committed chain's,
    or a typed ``degraded_restore``.

Hello handshake (one struct each way, before any framing state):

    client → shard:  4s "APXV" | u32 version | i64 client_id | i64
                     shard_id | i64 incarnation | i64 token | u8 codec
    shard  → client: 4s "APXA" | u32 version | i64 shard_id | i64
                     incarnation | i64 capacity | i64 count

A hello with the wrong magic/version/shard_id/token, or a stale
incarnation, is rejected by closing before the ack (``stale_rejects`` /
``bad_hellos``); the client re-resolves and reconnects.  ``incarnation =
-1`` in the hello means "current".
"""

from __future__ import annotations

import collections
import json
import os
import secrets
import select
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ape_x_dqn_tpu_torch.fleet.registry import (
    FleetAnnouncer,
    FleetClient,
    member_doc,
    member_id_for,
)

from ape_x_dqn_tpu_torch.runtime.net import (
    CODEC_OFF,
    CODEC_ZLIB,
    F_RERR,
    F_RREP,
    F_RREQ,
    HELLO_FLAG_TRACE,
    RSVC_ACK_MAGIC,
    RSVC_MAGIC,
    Backoff,
    FrameParser,
    decode_xpb_payload,
    encode_xpb_payload,
    frame_bytes,
    split_trace,
    wrap_trace,
)
from ape_x_dqn_tpu_torch.obs.lineage import BucketExemplars, TraceSpanLog
from ape_x_dqn_tpu_torch.runtime.shm_ring import XP, decode_chunk, encode_chunk_parts
from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

RSVC_VERSION = 1
# magic, version, client_id, shard_id, incarnation, token, codec, flags
# (flags was a pad byte — a pre-flags client packs 0 there, so the old
# hello reads as flags=0 and the wire stays bit-identical; bit 0 =
# HELLO_FLAG_TRACE negotiates the per-request trace prefix).
RSVC_HELLO = struct.Struct("<4sIqqqqBB6x")
# magic, version, shard_id, incarnation, capacity, count
RSVC_ACK = struct.Struct("<4sIqqqq")

# RPC ops.
OP_SAMPLE = 1
OP_ADD = 2
OP_UPDATE = 3
OP_DIGEST = 4
OP_STATS = 5
_OP_NAMES = {OP_SAMPLE: "sample", OP_ADD: "add", OP_UPDATE: "update",
             OP_DIGEST: "digest", OP_STATS: "stats"}

# Typed refusal codes (F_RERR payloads).
RE_BAD_REQUEST = 1   # well-framed but undecodable/ill-shaped request
RE_EMPTY = 2         # sample against an empty shard
RE_CLOSED = 3        # shard shutting down
RE_INTERNAL = 4      # op raised; the exception type rides the message

_RPC = struct.Struct("<QB7x")        # request head: req_id, op
_RREP = struct.Struct("<QBB6x")      # reply head: req_id, op, flags
_RERR = struct.Struct("<QH6x")       # error head: req_id, code | message
FLAG_DUP = 1                         # add reply served from the dedup cache
_SAMPLE_REQ = struct.Struct("<I4xdQ")   # batch_size, beta, sample seed
_SAMPLE_REP = struct.Struct("<dq")      # shard total p^α mass, shard size
_DIGEST_REQ = struct.Struct("<B7x")     # with_crc flag
# count, cursor, size, incarnation, capacity, total_mass, crc
_DIGEST_REP = struct.Struct("<qqqqqdI4x")

# "auto" proposes the zlib capability at the hello (like the experience
# plane's net_codec=auto); whether a given SAMPLE reply actually
# compresses is the shard's per-reply decision, gated on observed socket
# backpressure — see ReplayShardServer._reply_codec.
_CODEC_IDS = {"off": CODEC_OFF, "zlib": CODEC_ZLIB, "auto": CODEC_ZLIB}
_RECV_CHUNK = 1 << 16
_DEFAULT_MAX_FRAME = 64 << 20
# service_codec=auto: raw sample replies again after this many
# backpressure-free reply flushes (NetWriter's _AUTO_OFF_FLUSHES twin).
_AUTO_OFF_REPLIES = 256


class ReplayShardUnavailable(RuntimeError):
    """A replay RPC could not be served within its deadline — the shard
    (or, from :class:`ShardedReplayClient`, every shard) is down.  The
    typed degradation signal: callers route around it, buffer against it,
    or surface it; nothing ever silently samples wrong data."""

    def __init__(self, message: str, shard_id: Optional[int] = None,
                 op: Optional[str] = None):
        super().__init__(message)
        self.shard_id = shard_id
        self.op = op


class ReplayRpcError(RuntimeError):
    """A typed F_RERR refusal from a shard (bad request / empty /
    internal) — the request WAS answered; this is not unavailability."""

    def __init__(self, code: int, message: str):
        super().__init__(f"replay rpc error {code}: {message}")
        self.code = code


# ---------------------------------------------------------------------------
# RPC body codec: numpy dicts ride the APXT record format wrapped in the
# wire-efficiency container (F_XPB: in-window frame dedup + negotiated
# zlib).  One record per body; ``obs``/``next_obs`` uint8 leaves are
# exactly what the dedup encoder's span walk targets, so n-step overlap
# inside an add chunk ships each frame once — the 0.63 KB/transition
# economy, carried through to the replay plane.
# ---------------------------------------------------------------------------


def encode_body(arrays: Dict[str, np.ndarray], codec: int = CODEC_OFF,
                dedup: bool = True) -> bytes:
    rec = b"".join(
        bytes(p) if isinstance(p, (bytes, bytearray)) else memoryview(p)
        .cast("B").tobytes()
        for p in encode_chunk_parts(XP, 0, 0, arrays)
    )
    payload, _st = encode_xpb_payload([rec], codec=codec, dedup=dedup)
    return payload


def decode_body(payload, allow_zlib: bool = True,
                max_bytes: int = _DEFAULT_MAX_FRAME) -> Dict[str, np.ndarray]:
    """Arrays from one verified RPC body.  Raises ValueError on ANY
    malformation (bad codec, out-of-window dedup ref, truncated tables,
    short APXT buffers) — the caller counts torn / replies typed."""
    recs = decode_xpb_payload(payload, allow_zlib=allow_zlib,
                              max_bytes=max_bytes)
    if len(recs) != 1:
        raise ValueError(f"rpc body: expected 1 record, got {len(recs)}")
    # The port's decode_chunk returns read-only views over the record:
    # copy, so the arrays outlive it and are writable.
    return {k: np.array(v) for k, v in decode_chunk(recs[0])[8].items()}


class _Transition:
    """Attribute shim matching the replay's batch surface (obs/action/
    reward/discount/next_obs) over the decoded arrays."""

    __slots__ = ("obs", "action", "reward", "discount", "next_obs")

    def __init__(self, arrays: Dict[str, np.ndarray]):
        for k in self.__slots__:
            setattr(self, k, arrays[k])


# ---------------------------------------------------------------------------
# Shard server.
# ---------------------------------------------------------------------------


class _RConn:
    __slots__ = ("sock", "parser", "hello", "client_id", "codec", "flags",
                 "outbox", "out_off", "out_seq", "bytes_in", "bytes_out")

    def __init__(self, sock: socket.socket, max_frame: int):
        self.sock = sock
        self.parser = FrameParser(max_frame=max_frame)
        self.hello = bytearray()
        self.client_id: Optional[int] = None   # None until the ack went out
        self.codec = CODEC_OFF
        self.flags = 0
        self.outbox: collections.deque = collections.deque()
        self.out_off = 0
        self.out_seq = 0
        self.bytes_in = 0
        self.bytes_out = 0


class ReplayShardServer:
    """One replay shard: a PrioritizedReplay behind a framed-RPC socket
    front, with its own incremental checkpoint chain.

    A single pump thread runs accept + hello + parse + execute + reply in
    a select loop (replay ops are host-memory array work — there is no
    compute tier to batch behind, so inline execution IS the latency
    floor; one slow op delays the loop exactly as long as the op takes).
    The wall-cadence checkpoint save rides the same thread, so snapshots
    and mutations are serialized by construction.
    """

    def __init__(self, replay, shard_id: int, *, incarnation: int = 0,
                 token: int = 0, host: str = "127.0.0.1", port: int = 0,
                 codec: str = "zlib",
                 max_request_bytes: int = _DEFAULT_MAX_FRAME,
                 ckpt_dir: Optional[str] = None, save_every_s: float = 0.0,
                 base_every: int = 16, chaos=None, on_event=None):
        if codec not in _CODEC_IDS:
            raise ValueError(f"unknown replay service codec: {codec}")
        self.replay = replay
        self.shard_id = int(shard_id)
        self.incarnation = int(incarnation)
        self.token = int(token)
        self._codec_policy = codec
        self._accept_codecs = (
            {CODEC_OFF} if codec == "off" else {CODEC_OFF, CODEC_ZLIB}
        )
        self._max_frame = int(max_request_bytes)
        self._chaos = chaos
        self._on_event = on_event
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(128)
        self._lsock.setblocking(False)
        self.host = host
        self.port = self._lsock.getsockname()[1]
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._lock = threading.Lock()
        self._conns: Dict[int, _RConn] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"replay-shard{shard_id}", daemon=True
        )
        self._started = False
        # At-most-once adds: client_id -> (last applied req_id, its reply
        # payload).  A retried duplicate is answered from here WITHOUT
        # re-applying; req_ids are monotone per client by contract.
        self._last_add: Dict[int, Tuple[int, bytes]] = {}
        # Counters (the shard half of the replay_svc schema).
        self.accepted = 0
        self.requests = 0
        self.replies = 0
        self.errors = 0
        self.torn_frames = 0
        self.bad_hellos = 0
        self.stale_rejects = 0
        self.add_dups = 0
        self.ops = {name: 0 for name in _OP_NAMES.values()}
        self.chaos_dropped = 0
        self.chaos_delay_s = 0.0
        self.bytes_in = 0
        self.bytes_out = 0
        self.logical_bytes_in = 0   # decoded add/update record bytes
        # service_codec=auto control loop: compress sample replies only
        # while the reply path observes kernel-buffer backpressure
        # (blocked sends), so the incompressible worst case — zlib CPU
        # for bytes the link didn't need — is paid only when the wire is
        # the bottleneck.  The hello still negotiates the CAPABILITY; this
        # gates per-reply use.
        self.reply_full_waits = 0   # sends that hit a full kernel buffer
        self.reply_zlib = 0         # sample replies shipped compressed
        self.reply_raw = 0          # sample replies shipped raw
        # Per-request service latency (request verified → reply enqueued)
        # on the shared log-bucket layout, so the fleet aggregator can
        # merge shard histograms bucket-wise across the fleet; plus the
        # cross-tier span log (a traced request's server-side hop).
        self.op_ms = LatencyHistogram(min_s=1e-5, max_s=120.0)
        # Newest trace id per op-latency bucket (fleet-rollup
        # exemplars: a replay op p95 spike links to its timeline).
        self.op_exemplars = BucketExemplars(self.op_ms)
        self.spans = TraceSpanLog(depth=64)
        self._auto_on = False
        self._auto_idle = 0
        self._auto_fw_mark = 0
        # Shard-owned persistence: the incremental chain under
        # <ckpt_dir>; save() runs on the pump thread at the wall cadence
        # (step = transitions ever added — the shard's own clock).
        # Tiered (spill-backed) hosting: spans/bytes spilled cold by the
        # pump thread's watermark sweep (zeros on an untiered store).
        self.spill_spans = 0
        self.spill_bytes = 0
        self._ckpt = None
        self._save_every_s = float(save_every_s)
        self._next_save = time.monotonic() + self._save_every_s
        self.saves = 0
        if ckpt_dir:
            from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
                IncrementalCheckpointer,
            )

            self._ckpt = IncrementalCheckpointer(
                ckpt_dir, replay, base_every=base_every
            )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplayShardServer":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._wake()
        if self._started:
            self._thread.join(timeout=10.0)
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self._wake_r.close()
        self._wake_w.close()
        if self._ckpt is not None:
            # Final committed snapshot so a clean stop never loses the
            # tail (a SIGKILL loses at most one save interval — the chain
            # is the recovery contract either way).
            try:
                self._ckpt.save(int(self.replay.total_added))
                self._ckpt.close(timeout=30.0)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    def __enter__(self) -> "ReplayShardServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, shard=self.shard_id, **fields)
            except Exception:  # noqa: BLE001 — telemetry must not serve
                pass

    # -- pump thread -------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                socks = {c.sock: c for c in self._conns.values()}
                wlist = [c.sock for c in self._conns.values() if c.outbox]
            rlist = [self._lsock, self._wake_r, *socks]
            try:
                r, w, _ = select.select(rlist, wlist, [], 0.25)
            except (OSError, ValueError):
                time.sleep(0.005)
                continue
            if self._wake_r in r:
                try:
                    while self._wake_r.recv(4096):
                        pass
                except OSError:
                    pass
            if self._lsock in r:
                self._accept_pending()
            for sock in w:
                conn = socks.get(sock)
                if conn is not None:
                    self._flush(conn)
            for sock in r:
                conn = socks.get(sock)
                if conn is not None:
                    self._on_readable(conn)
            self._maybe_save()
            self._maybe_spill()

    def _maybe_spill(self) -> None:
        """Spill-backed shard (replay.service_hot_frame_budget_bytes):
        evict cold spans on the pump thread when the tiered store runs
        over its high watermark — serialized with every mutation by
        construction, so the spill never races an add.  A no-op on the
        untiered store."""
        over = getattr(self.replay, "tier_over_watermark", None)
        if over is None or not over():
            return
        try:
            spans, nbytes = self.replay.spill_cold()
            self.spill_spans += int(spans)
            self.spill_bytes += int(nbytes)
        except Exception as e:  # noqa: BLE001 — a sick spill path is an event, sampling stays correct
            self._event("shard_spill_error",
                        error=f"{type(e).__name__}: {e}")

    def _maybe_save(self) -> None:
        if self._ckpt is None or self._save_every_s <= 0:
            return
        now = time.monotonic()
        if now < self._next_save:
            return
        self._next_save = now + self._save_every_s
        try:
            if self._ckpt.save(int(self.replay.total_added)):
                self.saves += 1
        except Exception as e:  # noqa: BLE001 — a dead writer is an event
            self._event("shard_ckpt_error",
                        error=f"{type(e).__name__}: {e}")

    def _accept_pending(self) -> None:
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            self.accepted += 1
            with self._lock:
                self._conns[sock.fileno()] = _RConn(sock, self._max_frame)

    def _retire(self, conn: _RConn, torn: bool = False) -> None:
        if torn or conn.parser.pending() or conn.parser.error is not None:
            self.torn_frames += 1
        with self._lock:
            self._conns.pop(conn.sock.fileno(), None)
            self.bytes_in += conn.bytes_in
            self.bytes_out += conn.bytes_out
        try:
            conn.sock.close()
        except OSError:
            pass

    def _on_readable(self, conn: _RConn) -> None:
        while True:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._retire(conn)
                return
            if not data:
                self._retire(conn)
                return
            conn.bytes_in += len(data)
            if conn.client_id is None:
                need = RSVC_HELLO.size - len(conn.hello)
                conn.hello += data[:need]
                data = data[need:]
                if len(conn.hello) == RSVC_HELLO.size:
                    if not self._admit(conn):
                        return
                if not data:
                    continue
            conn.parser.feed(data)
        if conn.client_id is not None:
            self._drain_frames(conn)

    def _admit(self, conn: _RConn) -> bool:
        """Verify the hello; ack or reject-by-close.  A stale incarnation
        (the client pinning one this shard has outlived — or a client
        from before a respawn pinning the OLD incarnation against the new
        process) is rejected BEFORE any framing state exists."""
        try:
            (magic, version, client_id, shard_id, incarnation, token, codec,
             flags) = RSVC_HELLO.unpack(bytes(conn.hello))
        except struct.error:
            magic = b""
            version = client_id = shard_id = incarnation = token = -1
            codec, flags = 255, 0
        ok = (magic == RSVC_MAGIC and version == RSVC_VERSION
              and shard_id == self.shard_id and token == self.token)
        stale = ok and incarnation not in (-1, self.incarnation)
        if stale:
            self.stale_rejects += 1
        elif not ok:
            self.bad_hellos += 1
        if ok and not stale and codec not in self._accept_codecs:
            # Codec-mismatch hello: refused at the handshake, the
            # experience plane's codec_rejects rung.
            self.bad_hellos += 1
            ok = False
        if not ok or stale:
            self._retire(conn)
            return False
        conn.client_id = int(client_id)
        conn.codec = int(codec)
        conn.flags = int(flags)
        ack = RSVC_ACK.pack(
            RSVC_ACK_MAGIC, RSVC_VERSION, self.shard_id, self.incarnation,
            int(self.replay.capacity), int(self.replay.total_added),
        )
        conn.outbox.append(ack)   # raw bytes before the framed stream
        self._flush(conn)
        return True

    def _drain_frames(self, conn: _RConn) -> None:
        while True:
            got = conn.parser.next()
            if got is None:
                if conn.parser.error is not None:
                    self._retire(conn, torn=True)
                return
            kind, payload = got
            if kind != F_RREQ:
                # Reply kinds only flow shard → client: stream corruption,
                # connection-level recovery.
                self._retire(conn, torn=True)
                return
            self._handle(conn, payload)

    # -- request execution -------------------------------------------------

    def _handle(self, conn: _RConn, payload: bytes) -> None:
        t_req = time.monotonic()
        trace_id = 0
        if conn.flags & HELLO_FLAG_TRACE:
            # Trace-negotiated connection: every request leads with its
            # i64 trace id (0 = unsampled) — the version-gated envelope.
            try:
                trace_id, payload = split_trace(payload)
            except ValueError as e:
                self.errors += 1
                self._reply_err(conn, 0, RE_BAD_REQUEST, str(e))
                return
        if len(payload) < _RPC.size:
            self.errors += 1
            self._reply_err(conn, 0, RE_BAD_REQUEST, "short rpc head")
            return
        req_id, op = _RPC.unpack_from(payload, 0)
        body = memoryview(payload)[_RPC.size:]
        self.requests += 1
        if self._chaos is not None:
            d = self._chaos.delay_s()
            if d > 0:
                # Injected service latency: sleeping the pump thread IS
                # the fault (every queued request behind it waits too).
                self.chaos_delay_s += d
                time.sleep(d)
            if self._chaos.drop():
                # Silently dropped request: the lost-reply shape.  The
                # client's deadline expires and it retries whole.
                self.chaos_dropped += 1
                return
        try:
            if op == OP_ADD:
                self._op_add(conn, req_id, body)
            elif op == OP_SAMPLE:
                self._op_sample(conn, req_id, body)
            elif op == OP_UPDATE:
                self._op_update(conn, req_id, body)
            elif op == OP_DIGEST:
                self._op_digest(conn, req_id, body)
            elif op == OP_STATS:
                self.ops["stats"] += 1
                self._reply(conn, req_id, op,
                            json.dumps(self.stats()).encode())
            else:
                self.errors += 1
                self._reply_err(conn, req_id, RE_BAD_REQUEST,
                                f"unknown op {op}")
        except ValueError as e:
            # Well-framed but undecodable/ill-shaped body (the crc already
            # verified these bytes arrived intact): typed, not torn.
            self.errors += 1
            self._reply_err(conn, req_id, RE_BAD_REQUEST, str(e))
        except Exception as e:  # noqa: BLE001 — op raised: typed internal
            self.errors += 1
            self._reply_err(conn, req_id, RE_INTERNAL,
                            f"{type(e).__name__}: {e}")
        # Service latency (request verified → reply enqueued) always;
        # the cross-tier span only when the request carried a trace id.
        op_s = time.monotonic() - t_req
        self.op_ms.record(op_s)
        self.op_exemplars.record(op_s, trace_id)
        self.spans.record(trace_id, f"rsvc.{_OP_NAMES.get(op, str(op))}",
                          t_req, shard=self.shard_id, op=int(op))

    def _op_add(self, conn: _RConn, req_id: int, body) -> None:
        self.ops["add"] += 1
        last = self._last_add.get(conn.client_id)
        if last is not None and req_id <= last[0]:
            # Duplicate of an ALREADY-APPLIED add (the reply was lost):
            # at-most-once per req_id — answer from cache, never re-apply.
            self.add_dups += 1
            if req_id == last[0]:
                self._reply(conn, req_id, OP_ADD, last[1], flags=FLAG_DUP)
            else:
                self._reply_err(conn, req_id, RE_BAD_REQUEST,
                                "stale add req_id")
            return
        arrays = decode_body(body, allow_zlib=conn.codec != CODEC_OFF,
                             max_bytes=self._max_frame)
        self.logical_bytes_in += sum(a.nbytes for a in arrays.values())
        prio = np.asarray(arrays.pop("prio"), np.float64)
        idx = self.replay.add(prio, _Transition(arrays))
        rep = encode_body({"idx": np.asarray(idx, np.int64)},
                          codec=CODEC_OFF, dedup=False)
        self._last_add[conn.client_id] = (int(req_id), rep)
        self._reply(conn, req_id, OP_ADD, rep)

    def _op_sample(self, conn: _RConn, req_id: int, body) -> None:
        self.ops["sample"] += 1
        if len(body) < _SAMPLE_REQ.size:
            raise ValueError("short sample request")
        batch, _beta, seed = _SAMPLE_REQ.unpack_from(body, 0)
        if not 0 < batch <= 1 << 16:
            raise ValueError(f"absurd sample batch {batch}")
        if self.replay.size() == 0:
            self.errors += 1
            self._reply_err(conn, req_id, RE_EMPTY, "empty shard")
            return
        rng = np.random.default_rng(int(seed))
        transition, idx, mass, total, size = self.replay.sample_with_mass(
            int(batch), rng
        )
        rep_body = encode_body(
            {
                "obs": np.asarray(transition.obs),
                "action": np.asarray(transition.action),
                "reward": np.asarray(transition.reward),
                "discount": np.asarray(transition.discount),
                "next_obs": np.asarray(transition.next_obs),
                "idx": np.asarray(idx, np.int64),
                "mass": np.asarray(mass, np.float64),
            },
            codec=self._reply_codec()
            if conn.codec != CODEC_OFF else CODEC_OFF,
            dedup=True,
        )
        if rep_body[:1] == b"\x01":
            self.reply_zlib += 1
        else:
            self.reply_raw += 1
        self._reply(conn, req_id, OP_SAMPLE,
                    _SAMPLE_REP.pack(float(total), int(size)) + rep_body)

    def _op_update(self, conn: _RConn, req_id: int, body) -> None:
        self.ops["update"] += 1
        arrays = decode_body(body, allow_zlib=conn.codec != CODEC_OFF,
                             max_bytes=self._max_frame)
        self.logical_bytes_in += sum(a.nbytes for a in arrays.values())
        idx = np.asarray(arrays["idx"], np.int64)
        prio = np.asarray(arrays["prio"], np.float64)
        if idx.shape != prio.shape:
            raise ValueError("update idx/prio shape mismatch")
        if idx.size and (idx.min() < 0 or idx.max() >= self.replay.capacity):
            raise ValueError("update index outside the shard's slot range")
        self.replay.update_priorities(idx, prio)
        self._reply(conn, req_id, OP_UPDATE, b"")

    def _op_digest(self, conn: _RConn, req_id: int, body) -> None:
        self.ops["digest"] += 1
        with_crc = bool(len(body) >= _DIGEST_REQ.size
                        and _DIGEST_REQ.unpack_from(body, 0)[0])
        d = self.replay.digest(with_crc=with_crc)
        self._reply(conn, req_id, OP_DIGEST, _DIGEST_REP.pack(
            d["count"], d["cursor"], d["size"], self.incarnation,
            int(self.replay.capacity), d["total_mass"], d["crc"],
        ))

    # -- reply path --------------------------------------------------------

    def _reply_codec(self) -> int:
        """Effective SAMPLE-reply codec under the shard's policy.  "auto"
        mirrors NetWriter's control loop: zlib turns on when a reply send
        blocked since the last check (the wire is the bottleneck — codec
        CPU now buys throughput) and reverts after _AUTO_OFF_REPLIES
        backpressure-free replies (a fast link stops paying for bytes it
        doesn't need)."""
        if self._codec_policy == "zlib":
            return CODEC_ZLIB
        if self._codec_policy != "auto":
            return CODEC_OFF
        if self.reply_full_waits > self._auto_fw_mark:
            self._auto_fw_mark = self.reply_full_waits
            self._auto_on = True
            self._auto_idle = 0
        elif self._auto_on:
            self._auto_idle += 1
            if self._auto_idle >= _AUTO_OFF_REPLIES:
                self._auto_on = False
        return CODEC_ZLIB if self._auto_on else CODEC_OFF

    def _reply(self, conn: _RConn, req_id: int, op: int, body,
               flags: int = 0) -> None:
        self.replies += 1
        self._enqueue(conn, F_RREP, _RREP.pack(int(req_id), int(op),
                                               int(flags)) + bytes(body))

    def _reply_err(self, conn: _RConn, req_id: int, code: int,
                   message: str) -> None:
        self._enqueue(conn, F_RERR,
                      _RERR.pack(int(req_id), int(code))
                      + message.encode()[:512])

    def _enqueue(self, conn: _RConn, kind: int, body: bytes) -> None:
        with self._lock:
            if self._conns.get(conn.sock.fileno()) is not conn:
                return
            conn.out_seq += 1
            conn.outbox.append(frame_bytes(kind, conn.out_seq, [body]))
        self._flush(conn)

    def _flush(self, conn: _RConn) -> None:
        while True:
            with self._lock:
                if not conn.outbox:
                    return
                buf = conn.outbox[0]
            try:
                n = conn.sock.send(memoryview(buf)[conn.out_off:])
            except (BlockingIOError, InterruptedError):
                # Kernel send buffer full: the reply path is wire-bound —
                # the signal the auto codec gate compresses on.
                self.reply_full_waits += 1
                return
            except OSError:
                self._retire(conn)
                return
            conn.bytes_out += n
            conn.out_off += n
            if conn.out_off >= len(buf):
                conn.out_off = 0
                with self._lock:
                    if conn.outbox:
                        conn.outbox.popleft()

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            conns = [c for c in self._conns.values()
                     if c.client_id is not None]
            bytes_in = self.bytes_in + sum(
                c.bytes_in for c in self._conns.values()
            )
            bytes_out = self.bytes_out + sum(
                c.bytes_out for c in self._conns.values()
            )
        out = {
            "shard": self.shard_id,
            "incarnation": self.incarnation,
            "port": self.port,
            "connections": len(conns),
            "accepted": self.accepted,
            "requests": self.requests,
            "replies": self.replies,
            "errors": self.errors,
            "torn_frames": self.torn_frames,
            "bad_hellos": self.bad_hellos,
            "stale_rejects": self.stale_rejects,
            "add_dups": self.add_dups,
            "ops": dict(self.ops),
            "chaos_dropped": self.chaos_dropped,
            "bytes_in": bytes_in,
            "bytes_out": bytes_out,
            "logical_bytes_in": self.logical_bytes_in,
            "codec_policy": self._codec_policy,
            "reply_full_waits": self.reply_full_waits,
            "reply_zlib": self.reply_zlib,
            "reply_raw": self.reply_raw,
            "auto_codec_on": self._auto_on,
            "size": int(self.replay.size()),
            "capacity": int(self.replay.capacity),
            "total_added": int(self.replay.total_added),
            "saves": self.saves,
            "spill_spans": self.spill_spans,
            "spill_bytes": self.spill_bytes,
            # Fleet-rollup surfaces (obs/fleet.py): the service-latency
            # histogram ships summary + raw buckets so the aggregator can
            # merge shards bucket-wise; recent cross-tier spans ride the
            # same stats RPC (the shard's half of an end-to-end trace).
            "op_ms": {**self.op_ms.summary(),
                      "buckets": self.op_ms.buckets(),
                      "exemplars": self.op_exemplars.snapshot()},
            "trace_spans": self.spans.snapshot(),
        }
        if self._ckpt is not None:
            out["ckpt"] = self._ckpt.stats()
        return out


# ---------------------------------------------------------------------------
# Client side: one retrying shard client + the fleet-wide facade.
# ---------------------------------------------------------------------------


class ShardClient:
    """Blocking retrying RPC client against one shard — the ServingClient
    discipline on the replay plane: per-request deadline, jittered
    exponential reconnect backoff, WHOLE-request retry across reconnects
    (same req_id for the request's whole retry span — the shard's
    at-most-once add dedup keys on it), and a backoff that resets ONLY on
    a verified reply, so a dead shard is probed at backoff pace, never
    hammered.

    The endpoint (host/port/incarnation) is a mutable registry view the
    owner updates after a re-resolve; the hello pins the registry's
    incarnation when known, so a stale view is rejected at the handshake
    instead of talking to the wrong process generation.
    """

    def __init__(self, shard_id: int, host: str, port: int, *, token: int,
                 client_id: int, incarnation: int = -1, codec: str = "zlib",
                 trace: bool = False,
                 connect_timeout_s: float = 1.0, io_timeout_s: float = 5.0,
                 max_frame: int = _DEFAULT_MAX_FRAME, seed: int = 0,
                 on_incarnation: Optional[Callable[[int, int], None]] = None):
        if codec not in _CODEC_IDS:
            raise ValueError(f"unknown replay service codec: {codec}")
        self.shard_id = int(shard_id)
        self.host = host
        self.port = int(port)
        self.token = int(token)
        self.client_id = int(client_id)
        self.incarnation = int(incarnation)   # registry view; -1 = unknown
        self.codec = codec
        self._codec_id = _CODEC_IDS[codec]
        # Cross-tier tracing: negotiated at the hello (flags bit); with it
        # every request leads with an i64 trace id.  Off = the pre-flags
        # wire, byte for byte.
        self.trace = bool(trace)
        self._connect_timeout = float(connect_timeout_s)
        self._io_timeout = float(io_timeout_s)
        self._max_frame = int(max_frame)
        self._on_incarnation = on_incarnation
        self._sock: Optional[socket.socket] = None
        self._parser = FrameParser(max_frame=max_frame)
        self._backoff = Backoff(base_s=0.05, max_s=1.0,
                                seed=seed ^ (shard_id << 4))
        self._req_id = 0
        self._out_seq = 0
        self.capacity = 0             # learned from the ack
        self.reconnects = 0
        self.retries = 0
        self.torn = 0                 # parser faults / protocol violations
        self.hello_rejects = 0        # closed before the ack (stale/token)
        self._ever_connected = False

    # -- connection --------------------------------------------------------

    def set_endpoint(self, host: str, port: int, incarnation: int) -> None:
        """Adopt a re-resolved endpoint (the fleet moved the shard).  An
        open connection to the OLD endpoint is dropped."""
        if (host, int(port)) != (self.host, self.port) \
                or int(incarnation) != self.incarnation:
            self.host, self.port = host, int(port)
            self.incarnation = int(incarnation)
            self._drop()
            self._backoff.reset()

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _ensure_connected(self, deadline: float) -> bool:
        if self._sock is not None:
            return True
        if not self._backoff.ready():
            return False
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self._connect_timeout
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(RSVC_HELLO.pack(
                RSVC_MAGIC, RSVC_VERSION, self.client_id, self.shard_id,
                self.incarnation, self.token, self._codec_id,
                HELLO_FLAG_TRACE if self.trace else 0,
            ))
            sock.settimeout(
                max(0.05, min(self._io_timeout,
                              deadline - time.monotonic()))
            )
            ack = b""
            while len(ack) < RSVC_ACK.size:
                got = sock.recv(RSVC_ACK.size - len(ack))
                if not got:
                    raise OSError("closed before ack (stale/rejected hello)")
                ack += got
            magic, version, shard_id, incarnation, capacity, _count = \
                RSVC_ACK.unpack(ack)
            if magic != RSVC_ACK_MAGIC or version != RSVC_VERSION \
                    or shard_id != self.shard_id:
                raise OSError("bad ack")
        except (OSError, socket.timeout) as e:
            if "rejected" in str(e):
                self.hello_rejects += 1
            self._backoff.fail()
            return False
        self._sock = sock
        self._parser = FrameParser(max_frame=self._max_frame)
        self._out_seq = 0
        self.capacity = int(capacity)
        if incarnation != self.incarnation:
            self.incarnation = int(incarnation)
            if self._on_incarnation is not None:
                self._on_incarnation(self.shard_id, int(incarnation))
        # NB: the backoff resets on a verified REPLY, not here — an
        # accept-then-die shard must not turn the client into a tight
        # connect loop (the ServingClient discipline, pinned by tests).
        self.reconnects += int(self._ever_connected)
        self._ever_connected = True
        return True

    # -- request path ------------------------------------------------------

    def next_req_id(self) -> int:
        self._req_id += 1
        return self._req_id

    def request(self, op: int, body: bytes = b"",
                timeout: float = 10.0,
                req_id: Optional[int] = None,
                trace_id: int = 0) -> Tuple[int, bytes]:
        """(flags, reply payload past the head) for one RPC, across
        reconnects and whole-request retries.  Raises
        :class:`ReplayRpcError` on a typed refusal (the request WAS
        answered) and :class:`ReplayShardUnavailable` when the deadline
        expires unanswered.  ``trace_id`` rides the trace prefix on a
        trace-negotiated connection (retries re-send it unchanged — the
        whole retry span is one logical traced request)."""
        deadline = time.monotonic() + timeout
        rid = self.next_req_id() if req_id is None else int(req_id)
        payload = _RPC.pack(rid, int(op)) + body
        if self.trace:
            payload = wrap_trace(trace_id, payload)
        first = True
        while time.monotonic() < deadline:
            if not self._ensure_connected(deadline):
                time.sleep(0.005)
                continue
            if not first:
                self.retries += 1
            first = False
            try:
                self._out_seq += 1
                self._sock.sendall(
                    frame_bytes(F_RREQ, self._out_seq, [payload])
                )
                got = self._await(rid, deadline)
            except (OSError, socket.timeout):
                self._drop()
                self._backoff.fail()
                continue
            if got is None:          # torn stream / stale reply: retry
                continue
            kind, reply = got
            if kind == F_RREP:
                self._backoff.reset()
                _rid, _rop, flags = _RREP.unpack_from(reply, 0)
                return int(flags), bytes(reply[_RREP.size:])
            _rid, code = _RERR.unpack_from(reply, 0)
            msg = bytes(reply[_RERR.size:]).decode(errors="replace")
            if code == RE_CLOSED:
                # Shard draining: reconnect (the respawn will re-admit).
                self._drop()
                self._backoff.fail()
                continue
            self._backoff.reset()    # transport verified; typed refusal
            raise ReplayRpcError(int(code), msg)
        raise ReplayShardUnavailable(
            f"shard {self.shard_id} ({self.host}:{self.port}) gave no "
            f"reply within {timeout:.1f}s (retries={self.retries}, "
            f"reconnects={self.reconnects})",
            shard_id=self.shard_id, op=_OP_NAMES.get(op, str(op)),
        )

    def _await(self, rid: int, deadline: float):
        while True:
            got = self._parser.next()
            if got is not None:
                kind, payload = got
                if kind == F_RREP:
                    if len(payload) >= _RREP.size \
                            and _RREP.unpack_from(payload, 0)[0] == rid:
                        return kind, payload
                    continue          # stale reply from a retried request
                if kind == F_RERR:
                    if len(payload) >= _RERR.size \
                            and _RERR.unpack_from(payload, 0)[0] in (rid, 0):
                        return kind, payload
                    continue
                # Unknown kind: protocol violation — torn.
                self.torn += 1
                self._drop()
                self._backoff.fail()
                return None
            if self._parser.error is not None:
                self.torn += 1
                self._drop()
                self._backoff.fail()
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("deadline")
            self._sock.settimeout(min(self._io_timeout, remaining))
            data = self._sock.recv(_RECV_CHUNK)
            if not data:
                raise OSError("connection closed by peer")
            self._parser.feed(data)

    # -- typed ops ---------------------------------------------------------

    def digest(self, with_crc: bool = False, timeout: float = 2.0) -> dict:
        _flags, body = self.request(
            OP_DIGEST, _DIGEST_REQ.pack(int(with_crc)), timeout=timeout
        )
        count, cursor, size, incarnation, capacity, total_mass, crc = \
            _DIGEST_REP.unpack_from(body, 0)
        return {"count": count, "cursor": cursor, "size": size,
                "incarnation": incarnation, "capacity": capacity,
                "total_mass": total_mass, "crc": crc}

    def shard_stats(self, timeout: float = 2.0) -> dict:
        _flags, body = self.request(OP_STATS, timeout=timeout)
        return json.loads(body.decode())

    def close(self) -> None:
        self._drop()


def _membership_shards(snapshot: dict) -> List[dict]:
    """Endpoint-file-shaped shard dicts from a fleet-registry snapshot:
    the ``replay_shard`` members with live ports, sid recovered from the
    slot-range base (``base // capacity`` — the fleet keeps shards
    uniform and contiguous, so the mapping is exact)."""
    out = []
    for m in snapshot.get("members", {}).values():
        if m.get("kind") != "replay_shard":
            continue
        port = int(m.get("port", 0))
        cap = int(m.get("capacity", 0))
        if port <= 0 or cap <= 0:
            continue
        out.append({
            "id": int(m.get("base", 0)) // cap,
            "host": str(m.get("host", "127.0.0.1")),
            "port": port,
            "base": int(m.get("base", 0)),
            "capacity": cap,
            "incarnation": int(m.get("incarnation", -1)),
            "draining": bool(m.get("draining", False)),
        })
    return sorted(out, key=lambda s: s["id"])


class ShardedReplayClient:
    """The learner-facing replay: a PrioritizedReplay-shaped facade
    (``add`` / ``sample`` / ``update_priorities`` / ``size``) over the
    shard fleet, fault-tolerant by construction.

    Degradation contract — a shard dying costs the learner THROUGHPUT,
    never correctness and never a wedge:

      * ``sample`` draws the whole batch from one shard chosen by p^α
        mass among the HEALTHY shards (mass-weighted shard choice ×
        in-shard proportional sampling = the global sampling law, modulo
        the staleness of cached shard totals — the same order the async
        Ape-X loop already tolerates); IS weights are normalized against
        the GLOBAL (all-shard) total and size.
      * ``add`` routes round-robin over healthy shards; a shard going
        down mid-add re-routes to a survivor (at-least-once across the
        fleet; at-most-once per shard via the req_id dedup).
      * ``update_priorities`` routes by slot range; write-backs to a
        down shard buffer LAST-WRITE-WINS client-side and flush as one
        batched update when the background probe sees the shard return.
      * Only when EVERY shard is unreachable does an op raise the typed
        :class:`ReplayShardUnavailable`; ``age_s`` (the ``replay_svc``
        health component) reports how long the fleet has been degraded.

    The routing set is ELASTIC: shard clients live in sid-keyed maps, so
    :meth:`adopt_membership` (fed by the fleet registry's snapshots —
    :meth:`from_registry`) can admit a grown shard, stop routing adds at
    a draining one, and retire a removed one without rebuilding the
    facade.  Priority write-backs routed at a since-retired slot range
    are counted (``updates_dropped``), never raised — the transitions
    themselves were handed off server-side.
    """

    remote = True

    def __init__(self, shards: Sequence[dict], *, token: int,
                 codec: str = "zlib", dedup: bool = True,
                 trace: bool = False,
                 request_timeout_s: float = 10.0,
                 probe_interval_s: float = 0.5,
                 client_id: Optional[int] = None,
                 endpoints_path: Optional[str] = None,
                 seed: int = 0, on_event=None):
        shards = sorted(shards, key=lambda s: int(s["id"]))
        if not shards:
            raise ValueError("replay service needs >= 1 shard")
        caps = {int(s["capacity"]) for s in shards}
        if len(caps) != 1:
            raise ValueError("shards must have uniform capacity "
                             f"(got {sorted(caps)})")
        self.shard_capacity = caps.pop()
        self.num_shards = len(shards)
        self.capacity = self.shard_capacity * self.num_shards
        for k, s in enumerate(shards):
            if int(s["id"]) != k or int(s["base"]) != k * self.shard_capacity:
                raise ValueError("shard ids/bases must tile [0, capacity)")
        self._dedup = bool(dedup)
        self._token = int(token)
        self._codec_name = codec
        self._codec_id = _CODEC_IDS[codec]
        self._timeout = float(request_timeout_s)
        self._probe_interval = float(probe_interval_s)
        self._endpoints_path = endpoints_path
        self._endpoints_digest: Optional[int] = None
        self._seed = int(seed)
        self._on_event = on_event
        if client_id is None:
            client_id = (os.getpid() << 16) ^ secrets.randbits(16)
        self.client_id = int(client_id)
        # Elastic routing set: sid-keyed, mutated only under _state by
        # adopt_membership; readers take point-in-time copies.
        self._clients: Dict[int, ShardClient] = {}
        self._locks: Dict[int, threading.Lock] = {}
        # Cross-tier tracing (negotiated per connection): the learner's
        # RPC hops join the experience lineage — client-side spans land
        # here, the shard-side halves ride each shard's stats RPC.
        self.trace = bool(trace)
        self.spans = TraceSpanLog(depth=128)
        self._last_sample: Optional[Tuple[int, float, float]] = None
        for s in shards:
            sid = int(s["id"])
            self._clients[sid] = self._make_shard_client(
                sid, s["host"], int(s["port"]),
                int(s.get("incarnation", -1)),
            )
            self._locks[sid] = threading.Lock()
        self._state = threading.Lock()
        self._down: Dict[int, float] = {}        # sid -> down_since
        self._draining: set = set()              # sids leaving the add path
        self._pending: Dict[int, Dict[int, float]] = {}  # sid -> idx->prio
        self._totals: Dict[int, float] = {       # cached p^α mass per shard
            sid: 0.0 for sid in self._clients
        }
        self._sizes: Dict[int, int] = {sid: 0 for sid in self._clients}
        self._size_t = 0.0
        self._add_rr = 0
        self._degraded_since: Optional[float] = None
        # Counters (the client half of docs/METRICS.md "Replay service
        # schema" — key set pinned by tests/test_torch_replay_svc.py).
        self.samples = 0
        self.adds = 0
        self.updates = 0
        self.add_rerouted = 0
        self.sample_rerouted = 0
        self.shard_unavailable = 0     # per-shard deadline expiries seen
        self.writeback_buffered = 0    # slots ever parked for a down shard
        self.writeback_flushed = 0     # slots flushed on recovery
        self.updates_dropped = 0       # slots routed at a retired shard
        self.probes = 0
        self.recoveries = 0
        self.membership_adopts = 0
        self.membership_version = -1
        # rpc_* accumulators of since-retired shard clients, so the
        # stats sums stay monotone across membership churn.
        self._retired_rpc = {"retries": 0, "reconnects": 0, "torn": 0,
                             "hello_rejects": 0}
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._watcher: Optional[FleetAnnouncer] = None

    def _make_shard_client(self, sid: int, host: str, port: int,
                           incarnation: int) -> ShardClient:
        return ShardClient(
            sid, host, int(port), token=self._token,
            client_id=self.client_id, incarnation=int(incarnation),
            codec=self._codec_name, trace=self.trace,
            io_timeout_s=min(5.0, self._timeout),
            seed=self._seed ^ self.client_id,
        )

    @classmethod
    def from_endpoints_file(cls, path: str, **kwargs) -> "ShardedReplayClient":
        with open(path) as f:
            doc = json.load(f)
        kwargs.setdefault("codec", doc.get("codec", "zlib"))
        return cls(doc["shards"], token=int(doc["token"]),
                   endpoints_path=path, **kwargs)

    @classmethod
    def from_registry(cls, host: str, port: int, *, token: int,
                      wait_timeout_s: float = 30.0,
                      **kwargs) -> "ShardedReplayClient":
        """Build a client whose routing set is DRIVEN by the fleet
        registry (``fleet.discovery=registry`` — no endpoints file):
        blocks until at least one ``replay_shard`` member is announced,
        then keeps adopting membership snapshots over a watcher
        heartbeat, so grow/drain/retire propagate without any file
        polling."""
        probe = FleetClient(
            host, int(port), token=int(token),
            member_id=member_id_for(f"replay-client-{os.getpid()}"),
        )
        deadline = time.monotonic() + float(wait_timeout_s)
        shards: List[dict] = []
        try:
            while time.monotonic() < deadline:
                try:
                    snap = probe.sync()
                except ConnectionError:
                    time.sleep(0.05)
                    continue
                shards = _membership_shards(snap)
                if shards:
                    break
                time.sleep(0.05)
        finally:
            probe.close()
        if not shards:
            raise ReplayShardUnavailable(
                f"no replay_shard member announced within "
                f"{wait_timeout_s:.1f}s", op="discover",
            )
        client = cls(shards, token=int(token), **kwargs)
        client._watch_registry(host, int(port))
        return client

    def _watch_registry(self, host: str, port: int) -> None:
        self._watcher = FleetAnnouncer(
            host, int(port), token=self._token,
            member_id=member_id_for(f"replay-client-{self.client_id}"),
            heartbeat_s=self._probe_interval,
            on_membership=self.adopt_membership,
            seed=self._seed ^ self.client_id,
        )
        self._watcher.start()

    # -- membership (the fleet registry's routing feed) --------------------

    def adopt_membership(self, snapshot: dict) -> None:
        """Adopt one registry snapshot as the routing set: new
        ``replay_shard`` members get clients, moved ones re-resolve,
        draining ones leave the add path, removed ones retire (their
        parked write-backs are DROPPED and counted — the slot range no
        longer exists).  An empty shard list never wipes the routing set
        (a registry cold start must not strand the learner)."""
        shards = _membership_shards(snapshot)
        specs = {int(s["id"]): s for s in shards
                 if int(s["capacity"]) == self.shard_capacity}
        if not specs:
            return
        removed: List[ShardClient] = []
        moved: List[Tuple[ShardClient, dict]] = []
        with self._state:
            current = set(self._clients)
            want = set(specs)
            for sid in sorted(want - current):
                m = specs[sid]
                self._clients[sid] = self._make_shard_client(
                    sid, m["host"], int(m["port"]),
                    int(m.get("incarnation", -1)),
                )
                self._locks[sid] = threading.Lock()
                self._totals.setdefault(sid, 0.0)
                self._sizes.setdefault(sid, 0)
            for sid in sorted(current - want):
                removed.append(self._clients.pop(sid))
                self._locks.pop(sid, None)
                self._totals.pop(sid, None)
                self._sizes.pop(sid, None)
                self._down.pop(sid, None)
                dropped = self._pending.pop(sid, None)
                if dropped:
                    self.updates_dropped += len(dropped)
            for sid in sorted(want & current):
                moved.append((self._clients[sid], specs[sid]))
            self._draining = {sid for sid, m in specs.items()
                              if m.get("draining")}
            self.num_shards = len(self._clients)
            self.capacity = self.shard_capacity * self.num_shards
            if not self._down:
                self._degraded_since = None
            for c in removed:
                self._retired_rpc["retries"] += c.retries
                self._retired_rpc["reconnects"] += c.reconnects
                self._retired_rpc["torn"] += c.torn
                self._retired_rpc["hello_rejects"] += c.hello_rejects
            self.membership_version = int(snapshot.get("version", -1))
            self.membership_adopts += 1
        for cli, m in moved:
            cli.set_endpoint(m["host"], int(m["port"]),
                             int(m.get("incarnation", -1)))
        for c in removed:
            c.close()
        if removed or (want - current):
            self._event("replay_routing_changed",
                        shards=sorted(specs),
                        version=self.membership_version)

    # -- health ------------------------------------------------------------

    def _healthy(self) -> List[int]:
        with self._state:
            return [k for k in sorted(self._clients) if k not in self._down]

    def _addable(self) -> List[int]:
        """Shards eligible for NEW experience: healthy and not draining
        (a draining shard still answers sample/update — its range is
        mid-handoff — but must stop accumulating)."""
        with self._state:
            return [k for k in sorted(self._clients)
                    if k not in self._down and k not in self._draining]

    @property
    def degraded(self) -> bool:
        with self._state:
            return bool(self._down)

    def age_s(self) -> float:
        """The ``replay_svc`` /healthz component: 0 while every shard
        answers; otherwise seconds since the fleet degraded."""
        with self._state:
            if not self._down:
                return 0.0
            return time.monotonic() - min(self._down.values())

    def _mark_down(self, sid: int, reason: str) -> None:
        start_probe = False
        with self._state:
            if sid not in self._down:
                self._down[sid] = time.monotonic()
                if self._degraded_since is None:
                    self._degraded_since = self._down[sid]
                start_probe = True
        self.shard_unavailable += 1
        if start_probe:
            self._event("replay_shard_down", shard=sid, reason=reason)
            self._ensure_probe_thread()

    def _mark_up(self, sid: int) -> None:
        with self._state:
            self._down.pop(sid, None)
            if not self._down:
                self._degraded_since = None
        self.recoveries += 1
        self._event("replay_shard_recovered_client", shard=sid)

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, **fields)
            except Exception:  # noqa: BLE001 — observer callback must never break the fleet/client
                pass

    # -- the probe/recovery loop -------------------------------------------

    def _ensure_probe_thread(self) -> None:
        if self._probe_thread is None or not self._probe_thread.is_alive():
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="replay-svc-probe", daemon=True
            )
            self._probe_thread.start()

    def _refresh_endpoints(self) -> None:
        path = self._endpoints_path
        if not path:
            return
        try:
            # Change detection by CONTENT digest, never mtime equality:
            # two atomic rewrites can land inside one filesystem
            # timestamp granule, and an mtime early-out would skip the
            # second forever — the respawned shard's new port unseen,
            # the probe loop stuck dialing the old incarnation.
            with open(path, "rb") as f:
                raw = f.read()
            digest = zlib.crc32(raw)
            if digest == self._endpoints_digest:
                return
            doc = json.loads(raw.decode("utf-8"))
            self._endpoints_digest = digest
        except (OSError, ValueError):
            return
        for s in doc.get("shards", []):
            cli = self._clients.get(int(s["id"]))
            if cli is not None:
                cli.set_endpoint(
                    s["host"], int(s["port"]), int(s.get("incarnation", -1))
                )

    def _probe_loop(self) -> None:
        while not self._stop.wait(self._probe_interval):
            with self._state:
                down = list(self._down)
            if not down:
                continue
            self._refresh_endpoints()
            for sid in down:
                lock, cli = self._locks.get(sid), self._clients.get(sid)
                if lock is None or cli is None:
                    continue          # retired while parked on the down list
                self.probes += 1
                try:
                    with lock:
                        cli.digest(
                            with_crc=False,
                            timeout=max(0.25, self._probe_interval),
                        )
                        # Reachable again: flush the parked write-backs
                        # BEFORE re-admitting it to the routing set, so a
                        # sampler never races ahead of its own priorities.
                        self._flush_pending_locked(sid)
                except (ReplayShardUnavailable, ReplayRpcError):
                    continue
                self._mark_up(sid)

    def _flush_pending_locked(self, sid: int) -> None:
        """One batched last-write-wins update of everything parked for
        ``sid`` (caller holds the shard lock)."""
        with self._state:
            pending = self._pending.pop(sid, None)
        if not pending:
            return
        cli = self._clients.get(sid)
        if cli is None:
            # Retired mid-park: the slot range was handed off — the
            # priorities have nowhere valid to land.
            self.updates_dropped += len(pending)
            return
        idx = np.fromiter(pending.keys(), np.int64, len(pending))
        prio = np.fromiter(pending.values(), np.float64, len(pending))
        try:
            cli.request(
                OP_UPDATE,
                encode_body({"idx": idx, "prio": prio},
                            codec=self._codec_id, dedup=False),
                timeout=self._timeout,
            )
            self.writeback_flushed += len(pending)
            self._event("replay_writeback_flushed", shard=sid,
                        slots=len(pending))
        except (ReplayShardUnavailable, ReplayRpcError):
            # Still (or newly) unreachable: park them again — later
            # updates still win (dict.update order).
            with self._state:
                merged = self._pending.setdefault(sid, {})
                for k, v in pending.items():
                    merged.setdefault(k, v)
            raise ReplayShardUnavailable(
                f"shard {sid} reappeared but the write-back flush failed",
                shard_id=sid, op="update",
            )

    # -- replay surface ----------------------------------------------------

    def add(self, priorities: np.ndarray, batch,
            trace_id: int = 0) -> np.ndarray:
        """Route one chunk to a healthy shard; returns GLOBAL slot
        indices.  Re-routes to a survivor when the chosen shard dies
        mid-request.  ``trace_id`` (a traced chunk's lineage id) rides
        the RPC's trace prefix and stamps the client-side hop span."""
        arrays = {
            "prio": np.asarray(priorities, np.float64),
            "obs": np.asarray(batch.obs),
            "action": np.asarray(batch.action),
            "reward": np.asarray(batch.reward),
            "discount": np.asarray(batch.discount),
            "next_obs": np.asarray(batch.next_obs),
        }
        trace_id = trace_id if self.trace else 0
        body = encode_body(arrays, codec=self._codec_id, dedup=self._dedup)
        candidates = (self._addable() or self._healthy()
                      or sorted(self._clients))
        self._add_rr += 1
        order = candidates[self._add_rr % len(candidates):] \
            + candidates[:self._add_rr % len(candidates)]
        last_err: Optional[ReplayShardUnavailable] = None
        for pos, sid in enumerate(order):
            lock, cli = self._locks.get(sid), self._clients.get(sid)
            if lock is None or cli is None:
                continue              # retired between choice and dispatch
            try:
                t0 = time.monotonic()
                with lock:
                    _flags, rep = cli.request(
                        OP_ADD, body, timeout=self._timeout,
                        trace_id=trace_id,
                    )
                self.spans.record(trace_id, "rsvc.add.client", t0, shard=sid)
                idx = decode_body(rep)["idx"]
                self.adds += 1
                if pos:
                    self.add_rerouted += 1
                with self._state:
                    if sid in self._sizes:
                        self._sizes[sid] = min(
                            self._sizes[sid] + len(idx), self.shard_capacity
                        )
                return np.asarray(idx, np.int64) \
                    + sid * self.shard_capacity
            except ReplayShardUnavailable as e:
                last_err = e
                self._mark_down(sid, f"add: {e}")
        raise last_err if last_err is not None else ReplayShardUnavailable(
            "no healthy replay shard", op="add"
        )

    def sample(self, batch_size: int, beta: float = 0.4,
               rng: Optional[np.random.Generator] = None):
        """PrioritizedBatch with GLOBAL indices and globally-normalized
        IS weights — the drop-in for PrioritizedReplay.sample."""
        from ape_x_dqn_tpu_torch.types import NStepTransition, PrioritizedBatch

        rng = rng or np.random.default_rng()
        candidates = self._healthy()
        if not candidates:
            candidates = sorted(self._clients)
        with self._state:
            totals = {k: max(0.0, self._totals.get(k, 0.0))
                      for k in candidates}
        # Mass-weighted shard order: positive-mass shards first (drawn
        # without replacement ∝ their cached p^α totals — shard choice ×
        # in-shard proportional = the global law), zero/unknown-mass
        # shards shuffled behind them as fallbacks.
        pos = [k for k in candidates if totals[k] > 0]
        zero = [k for k in candidates if totals[k] <= 0]
        order: List[int] = []
        if pos:
            p = np.asarray([totals[k] for k in pos])
            order += list(rng.choice(pos, size=len(pos), replace=False,
                                     p=p / p.sum()))
        rng.shuffle(zero)
        order += zero
        last_err: Optional[BaseException] = None
        for pos, sid in enumerate(map(int, order)):
            seed = int(rng.integers(0, 2 ** 63 - 1))
            lock, cli = self._locks.get(sid), self._clients.get(sid)
            if lock is None or cli is None:
                continue              # retired between choice and dispatch
            try:
                t0 = time.monotonic()
                with lock:
                    _flags, rep = cli.request(
                        OP_SAMPLE,
                        _SAMPLE_REQ.pack(int(batch_size), float(beta), seed),
                        timeout=self._timeout,
                    )
                # Whether this sample touched a traced experience is only
                # knowable AFTER lineage sees the slot indices — park the
                # hop and let tag_sample_span stamp it post-hoc.
                self._last_sample = (sid, t0, time.monotonic())
            except ReplayShardUnavailable as e:
                last_err = e
                self._mark_down(sid, f"sample: {e}")
                continue
            except ReplayRpcError as e:
                if e.code == RE_EMPTY:       # fresh shard: try another
                    last_err = e
                    continue
                raise
            if pos:
                self.sample_rerouted += 1
            total, size = _SAMPLE_REP.unpack_from(rep, 0)
            arrays = decode_body(rep[_SAMPLE_REP.size:])
            with self._state:
                if sid in self._clients:
                    self._totals[sid] = float(total)
                    self._sizes[sid] = int(size)
                g_total = sum(self._totals.values())
                g_size = sum(self._sizes.values())
            self.samples += 1
            mass = np.asarray(arrays["mass"], np.float64)
            probs = mass / max(g_total, 1e-12)
            w = np.power(
                max(g_size, 1) * np.maximum(probs, 1e-12), -float(beta)
            )
            return PrioritizedBatch(
                transition=NStepTransition(
                    obs=arrays["obs"], action=arrays["action"],
                    reward=arrays["reward"], discount=arrays["discount"],
                    next_obs=arrays["next_obs"],
                ),
                indices=(np.asarray(arrays["idx"], np.int64)
                         + sid * self.shard_capacity).astype(np.int32),
                is_weights=(w / w.max()).astype(np.float32),
            )
        if isinstance(last_err, ReplayRpcError):
            raise ValueError("cannot sample from an empty replay service")
        raise last_err if last_err is not None else ReplayShardUnavailable(
            "no healthy replay shard", op="sample"
        )

    def tag_sample_span(self, trace_id: int) -> None:
        """Stamp the newest sample RPC's client hop with a trace id (the
        learner calls this after lineage identifies a traced slot in the
        returned batch) — closing the sample leg of the e2e timeline."""
        parked, self._last_sample = self._last_sample, None
        if parked is not None and self.trace:
            sid, t0, t1 = parked
            self.spans.record(trace_id, "rsvc.sample.client", t0, t1,
                              shard=sid)

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray,
                          trace_id: int = 0) -> None:
        """Split by slot range; a down shard's slice buffers
        last-write-wins and flushes on recovery — the learner never
        blocks on a dead shard's priorities.  ``trace_id`` marks the
        write-back of a traced experience (the timeline's final RPC
        hop)."""
        trace_id = trace_id if self.trace else 0
        indices = np.asarray(indices, np.int64)
        priorities = np.asarray(priorities, np.float64)
        if indices.size == 0:
            return
        sids = indices // self.shard_capacity
        for sid in map(int, np.unique(sids)):
            m = sids == sid
            idx = indices[m] - sid * self.shard_capacity
            prio = priorities[m]
            lock, cli = self._locks.get(sid), self._clients.get(sid)
            if lock is None or cli is None:
                # The slot range was retired (resharded away): the
                # transitions live on under NEW global indices on the
                # survivors — this stale write-back has no target.
                self.updates_dropped += int(idx.size)
                continue
            with self._state:
                down = sid in self._down
            if down:
                self._buffer_writeback(sid, idx, prio)
                continue
            try:
                t0 = time.monotonic()
                with lock:
                    cli.request(
                        OP_UPDATE,
                        encode_body({"idx": idx, "prio": prio},
                                    codec=self._codec_id, dedup=False),
                        timeout=self._timeout,
                        trace_id=trace_id,
                    )
                self.spans.record(trace_id, "rsvc.update.client", t0,
                                  shard=sid)
                self.updates += 1
            except ReplayShardUnavailable as e:
                self._buffer_writeback(sid, idx, prio)
                self._mark_down(sid, f"update: {e}")

    def _buffer_writeback(self, sid: int, idx: np.ndarray,
                          prio: np.ndarray) -> None:
        with self._state:
            # Last write wins per slot, so the parked set never exceeds the
            # shard's slot count: no cap needed.
            self._pending.setdefault(sid, {}).update(zip(idx.tolist(), prio.tolist()))
            self.writeback_buffered += len(idx)

    # -- size/meta ---------------------------------------------------------

    def size(self) -> int:
        now = time.monotonic()
        with self._state:
            stale = now - self._size_t > 0.25
            if stale:
                self._size_t = now
        if stale:
            for sid in self._healthy():
                lock, cli = self._locks.get(sid), self._clients.get(sid)
                if lock is None or cli is None:
                    continue
                try:
                    with lock:
                        d = cli.digest(
                            with_crc=False, timeout=min(2.0, self._timeout)
                        )
                    with self._state:
                        if sid in self._clients:
                            self._sizes[sid] = int(d["size"])
                            self._totals[sid] = float(d["total_mass"])
                except (ReplayShardUnavailable, ReplayRpcError) as e:
                    self._mark_down(sid, f"digest: {e}")
        with self._state:
            return int(sum(self._sizes.values()))

    @property
    def total_added(self) -> int:
        return self.adds

    def frames_nbytes(self) -> int:
        return 0   # remote: the shards own the bytes

    def max_priority(self) -> float:
        return 1.0

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The ``replay_svc`` JSONL / /varz section (docs/METRICS.md
        "Replay service schema" — key set pinned by
        tests/test_torch_replay_svc.py)."""
        with self._state:
            down = sorted(self._down)
            draining = sorted(self._draining)
            pending = sum(len(d) for d in self._pending.values())
            sizes = list(self._sizes.values())
            totals = list(self._totals.values())
            clients = list(self._clients.values())
            retired = dict(self._retired_rpc)
        return {
            "shards": self.num_shards,
            "shards_down": len(down),
            "down": down,
            "shards_draining": draining,
            "degraded": bool(down),
            "degraded_age_s": round(self.age_s(), 3),
            "size": int(sum(sizes)),
            "total_mass": round(float(sum(totals)), 3),
            "samples": self.samples,
            "adds": self.adds,
            "updates": self.updates,
            "add_rerouted": self.add_rerouted,
            "sample_rerouted": self.sample_rerouted,
            "shard_unavailable": self.shard_unavailable,
            "writeback_buffered": self.writeback_buffered,
            "writeback_flushed": self.writeback_flushed,
            "writeback_pending": pending,
            "updates_dropped": self.updates_dropped,
            "probes": self.probes,
            "recoveries": self.recoveries,
            "membership_version": self.membership_version,
            "membership_adopts": self.membership_adopts,
            "rpc_retries": retired["retries"]
            + sum(c.retries for c in clients),
            "rpc_reconnects": retired["reconnects"]
            + sum(c.reconnects for c in clients),
            "rpc_torn": retired["torn"] + sum(c.torn for c in clients),
            "hello_rejects": retired["hello_rejects"]
            + sum(c.hello_rejects for c in clients),
        }

    def close(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.close(leave=False)
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
        with self._state:
            pairs = [(self._locks[sid], self._clients[sid])
                     for sid in sorted(self._clients)]
        for lock, c in pairs:
            with lock:
                c.close()


# ---------------------------------------------------------------------------
# Fleet: shard subprocesses + supervision + the endpoints file.
# ---------------------------------------------------------------------------


class ReplayShardProcess:
    """One shard subprocess: ``python -m ape_x_dqn_tpu_torch.replay.service``
    with its announce line parsed off stdout (the ReplicaProcess
    discipline — ephemeral ports are fine because the fleet republishes
    the endpoints file on every spawn)."""

    def __init__(self, shard_id: int, capacity: int, obs_shape, *,
                 token: int, root_dir: str, priority_exponent: float = 0.6,
                 codec: str = "zlib", save_every_s: float = 2.0,
                 base_every: int = 16, host: str = "127.0.0.1",
                 hot_frame_budget_bytes: int = 0,
                 rpc_delay_ms: float = 0.0, rpc_drop_rate: float = 0.0,
                 chaos_seed: int = 0):
        self.shard_id = int(shard_id)
        self.capacity = int(capacity)
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.token = int(token)
        self.hot_frame_budget_bytes = int(hot_frame_budget_bytes)
        # Absolute by contract: the shard subprocess runs with the REPO
        # as its cwd (for the -m import), so a relative dir would land
        # its chain inside the source tree.
        self.root_dir = os.path.abspath(root_dir)
        self.alpha = float(priority_exponent)
        self.codec = codec
        self.save_every_s = float(save_every_s)
        self.base_every = int(base_every)
        self.host = host
        self.rpc_delay_ms = float(rpc_delay_ms)
        self.rpc_drop_rate = float(rpc_drop_rate)
        self.chaos_seed = int(chaos_seed)
        self.incarnation = -1
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        self.proc: Optional[subprocess.Popen] = None
        self.events: List[dict] = []
        # Seconds from Popen to the listen line of the newest incarnation.
        self.spawn_s: Optional[float] = None
        self._t_spawn = 0.0
        self._announce = threading.Event()
        self._reader: Optional[threading.Thread] = None

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.root_dir, f"shard{self.shard_id}")

    def spawn(self) -> "ReplayShardProcess":
        self.incarnation += 1
        self.port = None
        self._announce.clear()
        os.makedirs(self.ckpt_dir, exist_ok=True)
        args = [
            sys.executable, "-m", "ape_x_dqn_tpu_torch.replay.service",
            "--shard-id", str(self.shard_id),
            "--capacity", str(self.capacity),
            "--obs-shape", ",".join(map(str, self.obs_shape)),
            "--alpha", str(self.alpha),
            "--token", str(self.token),
            "--incarnation", str(self.incarnation),
            "--host", self.host, "--port", "0",
            "--codec", self.codec,
            "--ckpt-dir", self.ckpt_dir,
            "--save-every-s", str(self.save_every_s),
            "--base-every", str(self.base_every),
        ]
        if self.hot_frame_budget_bytes > 0:
            args += ["--hot-frame-budget-bytes",
                     str(self.hot_frame_budget_bytes)]
        if self.rpc_delay_ms or self.rpc_drop_rate:
            args += ["--rpc-delay-ms", str(self.rpc_delay_ms),
                     "--rpc-drop-rate", str(self.rpc_drop_rate),
                     "--chaos-seed", str(self.chaos_seed)]
        stderr_log = open(   # noqa: SIM115 — lives as long as the child
            os.path.join(self.ckpt_dir,
                         f"shard{self.shard_id}.{self.incarnation}.log"),
            "ab",
        )
        # A shard is a CPU process: no card is visible to it, so no CUDA
        # context can exist in it whatever it imports.
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self._t_spawn = time.monotonic()
        self.proc = subprocess.Popen(
            args, stdout=subprocess.PIPE, stderr=stderr_log, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
        stderr_log.close()
        self.pid = self.proc.pid
        self._reader = threading.Thread(
            target=self._read_stdout, args=(self.proc,),
            name=f"shard{self.shard_id}-stdout", daemon=True,
        )
        self._reader.start()
        return self

    def _read_stdout(self, proc: subprocess.Popen) -> None:
        for raw in iter(proc.stdout.readline, b""):
            try:
                ev = json.loads(raw.decode(errors="replace"))
            except ValueError:
                continue
            self.events.append(ev)
            if len(self.events) > 512:
                del self.events[:128]
            if ev.get("event") == "replay_shard_listen" \
                    and ev.get("incarnation") == self.incarnation:
                self.port = int(ev["port"])
                self.spawn_s = time.monotonic() - self._t_spawn
                self._announce.set()

    def wait_announce(self, timeout: float = 30.0) -> bool:
        return self._announce.wait(timeout)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _reap_pipe(self) -> None:
        # The stdout reader thread exits at EOF once the child is dead;
        # close the pipe fd explicitly (the conftest fd-leak guard's
        # discipline — teardown must not lean on GC).
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        if self.proc is not None and self.proc.stdout is not None:
            try:
                self.proc.stdout.close()
            except OSError:
                pass

    def kill(self) -> None:
        if self.alive():
            os.kill(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=10.0)
        self._reap_pipe()

    def stop(self, timeout: float = 10.0) -> None:
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5.0)
        self._reap_pipe()


class ReplayServiceFleet:
    """Owner of the shard fleet: spawn, supervise (RespawnPolicy backoff
    + crash-loop quarantine), endpoints publication, and the chaos
    kill-shard hooks.  ``auto_respawn=False`` hands respawn timing to the
    caller (the smoke's deterministic mid-kill chain inspection).

    The fleet is ELASTIC: :meth:`grow` appends a fresh empty shard at
    the next slot range, :meth:`retire` removes the HIGHEST shard after
    a digest-proven handoff — drain, final committed chain, bit-exact
    restore proof, re-add into the survivors — so only uniform
    contiguous geometries ever exist and the client's ``index //
    shard_capacity`` routing stays exact through every resize.  Both are
    the autopilot's replay actuator surface.  With ``registry_addr`` set,
    every shard is announced to the fleet registry (kind
    ``replay_shard``) and membership — not the
    endpoints file — drives client/aggregator routing; the file is still
    written as the compat fallback.
    """

    def __init__(self, num_shards: int, capacity: int, obs_shape, *,
                 root_dir: str, priority_exponent: float = 0.6,
                 codec: str = "zlib", save_every_s: float = 2.0,
                 base_every: int = 16, endpoints_path: Optional[str] = None,
                 token: Optional[int] = None,
                 hot_frame_budget_bytes: int = 0,
                 registry_addr: Optional[Tuple[str, int]] = None,
                 heartbeat_s: float = 1.0,
                 auto_respawn: bool = True, respawn_base_s: float = 0.25,
                 respawn_max_s: float = 5.0, crash_loop_budget: int = 6,
                 rpc_delay_ms: float = 0.0, rpc_drop_rate: float = 0.0,
                 kill_shard_at_step: int = 0, chaos_seed: int = 0,
                 seed: int = 0, on_event=None):
        if num_shards < 1:
            raise ValueError("replay fleet needs >= 1 shard")
        if capacity % num_shards:
            raise ValueError(
                f"capacity {capacity} must divide evenly into "
                f"{num_shards} shards"
            )
        from ape_x_dqn_tpu_torch.runtime.supervisor import RespawnPolicy

        # With a registry the fleet authenticates shards under the RUN
        # token (the registry's), so one credential covers discovery and
        # the replay RPC hello; standalone keeps the private random one.
        self.token = int(token) if token else (secrets.randbits(63) or 1)
        self.num_shards = int(num_shards)
        self.capacity = int(capacity)
        self.shard_capacity = self.capacity // self.num_shards
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.alpha = float(priority_exponent)
        self.save_every_s = float(save_every_s)
        self.base_every = int(base_every)
        self.hot_frame_budget_bytes = int(hot_frame_budget_bytes)
        self.rpc_delay_ms = float(rpc_delay_ms)
        self.rpc_drop_rate = float(rpc_drop_rate)
        self.chaos_seed = int(chaos_seed)
        self.root_dir = os.path.abspath(root_dir)
        root_dir = self.root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.endpoints_path = endpoints_path or os.path.join(
            root_dir, "endpoints.json"
        )
        self.codec = codec
        self._on_event = on_event
        self._auto_respawn = bool(auto_respawn)
        self._respawn_policy = RespawnPolicy(
            base_s=respawn_base_s, max_s=respawn_max_s,
            budget=crash_loop_budget, seed=seed,
        )
        self._kill_at_step = int(kill_shard_at_step)
        self._kill_fired = False
        import random as _random

        self._chaos_rng = _random.Random(chaos_seed ^ 0x5A4D)
        self.shards = [self._make_shard(k) for k in range(self.num_shards)]
        self.respawns = 0
        self.kills = 0
        self.grows = 0
        self.retires = 0
        self.quarantined: set = set()
        self._registry_addr = registry_addr
        self._heartbeat_s = float(heartbeat_s)
        self._announcer: Optional[FleetAnnouncer] = None
        self._reshard_lock = threading.Lock()
        self._resharding = False
        self._retiring: Optional[int] = None   # supervisor must not respawn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _make_shard(self, sid: int) -> ReplayShardProcess:
        return ReplayShardProcess(
            sid, self.shard_capacity, self.obs_shape, token=self.token,
            root_dir=self.root_dir, priority_exponent=self.alpha,
            codec=self.codec, save_every_s=self.save_every_s,
            base_every=self.base_every,
            hot_frame_budget_bytes=self.hot_frame_budget_bytes,
            rpc_delay_ms=self.rpc_delay_ms,
            rpc_drop_rate=self.rpc_drop_rate,
            chaos_seed=self.chaos_seed + sid,
        )

    def _event(self, name: str, **fields) -> None:
        # Positional param deliberately NOT named ``kind``: the reshard
        # events carry a ``kind="grow"/"retire"`` field of their own.
        if self._on_event is not None:
            try:
                self._on_event(name, **fields)
            except Exception:  # noqa: BLE001 — observer callback must never break the fleet/client
                pass

    # -- endpoints ---------------------------------------------------------

    def write_endpoints(self) -> None:
        """Atomic publish (tmp + rename — the manifest discipline): the
        client's probe loop re-reads on mtime change."""
        doc = {
            "token": self.token,
            "codec": self.codec,
            "total_capacity": self.capacity,
            "shards": [
                {
                    "id": s.shard_id, "host": s.host,
                    "port": s.port if s.port is not None else -1,
                    "base": s.shard_id * self.shard_capacity,
                    "capacity": s.capacity,
                    "incarnation": s.incarnation,
                }
                for s in self.shards
            ],
        }
        tmp = self.endpoints_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.endpoints_path)

    # -- lifecycle ---------------------------------------------------------

    def _shard_doc(self, s: ReplayShardProcess,
                   draining: bool = False) -> dict:
        return member_doc(
            f"replay/shard{s.shard_id}", "replay_shard",
            host=s.host, port=s.port or 0,
            incarnation=s.incarnation,
            base=s.shard_id * self.shard_capacity,
            capacity=s.capacity, draining=draining,
        )

    def _announce_shard(self, s: ReplayShardProcess,
                        draining: bool = False) -> None:
        if self._announcer is not None:
            self._announcer.set_member(self._shard_doc(s, draining))
            self._announcer.poke()

    def start(self, timeout: float = 60.0) -> "ReplayServiceFleet":
        deadline = time.monotonic() + timeout
        for s in self.shards:
            s.spawn()
        for s in self.shards:
            if not s.wait_announce(max(1.0, deadline - time.monotonic())):
                raise TimeoutError(
                    f"replay shard {s.shard_id} never announced its port "
                    f"(see {s.ckpt_dir}/shard{s.shard_id}."
                    f"{s.incarnation}.log)"
                )
        self.write_endpoints()
        if self._registry_addr is not None:
            host, port = self._registry_addr
            self._announcer = FleetAnnouncer(
                host, int(port), token=self.token,
                member_id=member_id_for(f"replay-fleet-{os.getpid()}"),
                heartbeat_s=self._heartbeat_s, on_event=self._on_event,
            )
            for s in self.shards:
                self._announcer.set_member(self._shard_doc(s))
            self._announcer.start()
        if self._auto_respawn:
            self._thread = threading.Thread(
                target=self._supervise_loop, name="replay-fleet", daemon=True
            )
            self._thread.start()
        return self

    def respawn(self, shard_id: int, timeout: float = 60.0) -> None:
        """Respawn one shard now (fresh incarnation; recovers from its
        checkpoint chain) and republish endpoints + membership."""
        s = self.shards[shard_id]
        s.spawn()
        if not s.wait_announce(timeout):
            raise TimeoutError(
                f"respawned shard {shard_id} never announced"
            )
        self.respawns += 1
        self.write_endpoints()
        self._announce_shard(s)
        self._event("replay_shard_respawned", shard=shard_id,
                    incarnation=s.incarnation, port=s.port)

    # -- elastic resharding (the autopilot's replay actuator surface) ------

    def resharding(self) -> bool:
        with self._reshard_lock:
            return self._resharding

    def _begin_reshard(self) -> bool:
        with self._reshard_lock:
            if self._resharding:
                return False
            self._resharding = True
            return True

    def _end_reshard(self) -> None:
        with self._reshard_lock:
            self._resharding = False

    def grow(self, timeout: float = 60.0) -> Optional[int]:
        """Split: append one fresh EMPTY shard at the next slot range
        (sid = current count — geometries stay uniform and contiguous,
        so client routing math survives).  Returns the new sid, or None
        when a reshard is already in flight or the spawn failed."""
        if not self._begin_reshard():
            return None
        sid = self.num_shards
        try:
            self._event("reshard_started", kind="grow", shard=sid,
                        shards_from=self.num_shards,
                        shards_to=self.num_shards + 1)
            s = self._make_shard(sid)
            # A retired shard's old chain must not resurrect into the
            # NEW (empty) slot range: the handoff already moved that
            # data to the survivors.
            if os.path.isdir(s.ckpt_dir):
                shutil.rmtree(s.ckpt_dir, ignore_errors=True)
            s.spawn()
            if not s.wait_announce(timeout):
                s.stop()
                self._event("reshard_failed", kind="grow", shard=sid,
                            error="spawn timeout")
                return None
            self.shards.append(s)
            self.num_shards += 1
            self.capacity += self.shard_capacity
            self.grows += 1
            self.write_endpoints()
            self._announce_shard(s)
            self._event("reshard_done", kind="grow", shard=sid,
                        shards=self.num_shards, transferred=0,
                        lost=0, digest_ok=True)
            return sid
        finally:
            self._end_reshard()

    def retire(self, drain_grace_s: float = 0.5,
               timeout: float = 60.0) -> Optional[int]:
        """Merge: remove the HIGHEST shard via a digest-proven handoff —
        announce it draining (clients stop routing adds), let in-flight
        adds settle, fingerprint the live state (content crc), SIGTERM
        (the clean-stop path commits a final chain), restore the chain
        and PROVE it bit-exact against the live fingerprint, then re-add
        every held transition (priorities recovered from the p^α masses)
        into the survivors oldest-first.  Returns the retired sid, or
        None when the fleet is at one shard / a reshard is in flight /
        the proof failed (the shard respawns and the fleet stays put —
        an unproven handoff never discards data)."""
        if not self._begin_reshard():
            return None
        if self.num_shards <= 1:
            self._end_reshard()
            return None
        s = self.shards[-1]
        sid = s.shard_id
        try:
            if not s.alive() or sid in self.quarantined:
                self._event("reshard_failed", kind="retire", shard=sid,
                            error="shard not serving")
                return None
            self._event("reshard_started", kind="retire", shard=sid,
                        shards_from=self.num_shards,
                        shards_to=self.num_shards - 1)
            self._announce_shard(s, draining=True)
            time.sleep(max(0.0, drain_grace_s))
            # Live fingerprint — the proof anchor the restored chain
            # must reproduce bit for bit.
            src = ShardClient(
                sid, s.host, s.port, token=self.token,
                client_id=(os.getpid() << 16) ^ secrets.randbits(16),
                incarnation=s.incarnation, codec=self.codec,
            )
            try:
                src_digest = src.digest(with_crc=True,
                                        timeout=min(30.0, timeout))
            finally:
                src.close()
            # Clean stop: SIGTERM → server.close() → final committed
            # chain save (the shard CLI's teardown contract).
            self._retiring = sid
            s.stop(timeout=timeout)
            restored = self._restore_shard_state(s)
            d = restored.digest(with_crc=True)
            digest_ok = all(
                int(d[k]) == int(src_digest[k])
                for k in ("count", "cursor", "size", "crc")
            ) and abs(d["total_mass"] - src_digest["total_mass"]) <= 1e-6
            if not digest_ok:
                # Unproven chain: put the shard BACK (its chain is still
                # the newest committed state) and abort the merge.
                self._event("reshard_failed", kind="retire", shard=sid,
                            error="handoff digest mismatch",
                            src=src_digest, restored=d)
                self.respawn(sid, timeout=timeout)
                self._announce_shard(s, draining=False)
                return None
            # Geometry shrinks BEFORE the transfer: clients must never
            # route new work at the vacated range while its transitions
            # re-enter under survivor indices.
            self.shards.pop()
            self.num_shards -= 1
            self.capacity -= self.shard_capacity
            self.write_endpoints()
            if self._announcer is not None:
                self._announcer.remove_member(f"replay/shard{sid}")
                self._announcer.poke()
            transferred, lost = self._transfer_out(restored, timeout)
            self.retires += 1
            # Park the consumed chain: a later grow() of this sid must
            # start EMPTY, not resurrect handed-off data.
            parked = s.ckpt_dir + ".retired"
            shutil.rmtree(parked, ignore_errors=True)
            try:
                os.rename(s.ckpt_dir, parked)
            except OSError:
                shutil.rmtree(s.ckpt_dir, ignore_errors=True)
            self._event("reshard_done", kind="retire", shard=sid,
                        shards=self.num_shards, transferred=transferred,
                        lost=lost, digest_ok=True,
                        crc=int(src_digest["crc"]),
                        count=int(src_digest["count"]))
            return sid
        except Exception as e:  # noqa: BLE001 — a failed handoff is a typed event; the fleet must survive it
            self._event("reshard_failed", kind="retire", shard=sid,
                        error=f"{type(e).__name__}: {e}")
            return None
        finally:
            self._retiring = None
            self._end_reshard()

    def _restore_shard_state(self, s: ReplayShardProcess):
        """The retired shard's committed chain, restored in-process (a
        plain dense replay — the tiered store materializes identically
        through ``get``, so digests stay comparable)."""
        from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
            load_incremental_replay,
        )

        replay = PrioritizedReplay(self.shard_capacity, self.obs_shape,
                                   priority_exponent=self.alpha)
        load_incremental_replay(s.ckpt_dir, replay, fallback=False)
        return replay

    def _transfer_out(self, replay, timeout: float) -> Tuple[int, int]:
        """Re-add every transition of a restored (already-removed) shard
        into the survivors, oldest-first so survivor ring evictions —
        if any — fall on the oldest data, the loss order replay already
        lives with.  Returns (transferred, lost)."""
        size = int(replay.size())
        if size == 0:
            return 0, 0
        state = replay.state_dict()
        count, cursor = int(state["count"]), int(state["cursor"])
        if count > replay.capacity:      # wrapped ring: oldest at cursor
            order = (cursor + np.arange(size)) % size
        else:
            order = np.arange(size)
        mass = np.asarray(state["tree_priorities"], np.float64)
        if self.alpha > 0:
            prio = np.power(np.maximum(mass, 1e-12), 1.0 / self.alpha)
        else:
            prio = np.ones_like(mass)
        clients = [
            ShardClient(
                p.shard_id, p.host, p.port, token=self.token,
                client_id=(os.getpid() << 16) ^ secrets.randbits(16),
                incarnation=p.incarnation, codec=self.codec,
            )
            for p in self.shards
        ]
        transferred = lost = 0
        try:
            batch = 256
            for pos, off in enumerate(range(0, size, batch)):
                rows = order[off:off + batch]
                body = encode_body(
                    {
                        "prio": prio[rows],
                        "obs": np.asarray(state["obs"])[rows],
                        "action": np.asarray(state["action"])[rows],
                        "reward": np.asarray(state["reward"])[rows],
                        "discount": np.asarray(state["discount"])[rows],
                        "next_obs": np.asarray(state["next_obs"])[rows],
                    },
                    codec=_CODEC_IDS[self.codec], dedup=True,
                )
                sent = False
                for attempt in range(len(clients)):
                    c = clients[(pos + attempt) % len(clients)]
                    try:
                        c.request(OP_ADD, body, timeout=timeout)
                        sent = True
                        break
                    except (ReplayShardUnavailable, ReplayRpcError):
                        continue
                if sent:
                    transferred += len(rows)
                else:
                    lost += len(rows)
        finally:
            for c in clients:
                c.close()
        return transferred, lost

    def kill(self, shard_id: int) -> dict:
        s = self.shards[shard_id]
        pid = s.pid
        s.kill()
        self.kills += 1
        rec = {"fault": "kill_shard", "shard": shard_id, "pid": pid}
        self._event("replay_shard_killed", **rec)
        return rec

    def kill_random(self, rng=None) -> dict:
        rng = rng or self._chaos_rng
        live = [s.shard_id for s in self.shards if s.alive()]
        if not live:
            return {"fault": "kill_shard", "skipped": "no live shards"}
        return self.kill(live[rng.randrange(len(live))])

    def maybe_kill_at_step(self, step: int) -> Optional[dict]:
        """The ``chaos.kill_shard_at_step`` drill: fire once, seeded
        victim, when the learner's step counter first crosses the mark."""
        if not self._kill_at_step or self._kill_fired \
                or step < self._kill_at_step:
            return None
        self._kill_fired = True
        return self.kill_random()

    def _supervise_loop(self) -> None:
        from ape_x_dqn_tpu_torch.runtime.supervisor import QUARANTINE, RESPAWN

        reported: set = set()
        while not self._stop.wait(0.1):
            for s in list(self.shards):
                sid = s.shard_id
                if sid == self._retiring:
                    # Mid-handoff: the retire path owns this shard's
                    # lifecycle — a supervisor respawn here would fork
                    # the slot range's history.
                    continue
                if s.alive() or sid in self.quarantined:
                    reported.discard(sid)
                    continue
                if sid not in reported:
                    reported.add(sid)
                    if self._respawn_policy.on_death(sid) == QUARANTINE:
                        self.quarantined.add(sid)
                        self._event("replay_shard_quarantined", shard=sid)
                        continue
                if self._respawn_policy.decide(sid) == RESPAWN:
                    try:
                        self.respawn(sid)
                        reported.discard(sid)
                    except (TimeoutError, OSError) as e:
                        self._event("replay_shard_respawn_failed",
                                    shard=sid, error=str(e))
                        self._respawn_policy.on_death(sid)

    def stats(self) -> dict:
        shards = list(self.shards)
        return {
            "shards": self.num_shards,
            "alive": sum(1 for s in shards if s.alive()),
            "respawns": self.respawns,
            "kills": self.kills,
            "grows": self.grows,
            "retires": self.retires,
            "resharding": self.resharding(),
            "quarantined": sorted(self.quarantined),
            "incarnations": {
                str(s.shard_id): s.incarnation for s in shards
            },
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._announcer is not None:
            self._announcer.close(leave=True)
            self._announcer = None
        for s in list(self.shards):
            s.stop()


# ---------------------------------------------------------------------------
# Shard CLI: `python -m ape_x_dqn_tpu_torch.replay.service --shard-id K ...`
# ---------------------------------------------------------------------------


def _emit_line(**fields) -> None:
    sys.stdout.write(json.dumps(fields) + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="replay-shard", description=__doc__)
    ap.add_argument("--shard-id", type=int, required=True)
    ap.add_argument("--capacity", type=int, required=True)
    ap.add_argument("--obs-shape", required=True,
                    help="comma-separated, e.g. 84,84,1")
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--token", type=int, default=0)
    ap.add_argument("--incarnation", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--codec", default="zlib",
                    choices=("off", "zlib", "auto"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every-s", type=float, default=2.0)
    ap.add_argument("--base-every", type=int, default=16)
    ap.add_argument("--hot-frame-budget-bytes", type=int, default=0,
                    help="replay.service_hot_frame_budget_bytes: >0 hosts "
                    "the shard's replay on the tiered (spill-backed) "
                    "store, capping hot frame DRAM at this many bytes")
    ap.add_argument("--max-request-bytes", type=int,
                    default=_DEFAULT_MAX_FRAME)
    ap.add_argument("--rpc-delay-ms", type=float, default=0.0)
    ap.add_argument("--rpc-drop-rate", type=float, default=0.0)
    ap.add_argument("--chaos-seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay

    obs_shape = tuple(int(d) for d in args.obs_shape.split(","))
    tier_kw = {}
    if args.hot_frame_budget_bytes > 0:
        # Spill-backed shard: the cold files live beside the chain (one
        # spill dir per incarnation-independent shard home).
        spill_dir = os.path.join(args.ckpt_dir or ".", "spill")
        os.makedirs(spill_dir, exist_ok=True)
        tier_kw = dict(hot_frame_budget_bytes=args.hot_frame_budget_bytes,
                       spill_dir=spill_dir)
    replay = PrioritizedReplay(args.capacity, obs_shape,
                               priority_exponent=args.alpha, **tier_kw)
    # Recovery: a respawned incarnation walks its own chain back to the
    # newest committed state — bit-exact (digest announced below) or a
    # typed degraded_restore from the fallback rungs, never silent.
    restored_step = None
    if args.ckpt_dir:
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
            load_incremental_replay,
        )

        try:
            restored_step = load_incremental_replay(
                args.ckpt_dir, replay, fallback=True,
                on_event=lambda ev: _emit_line(**ev),
            )
        except Exception as e:  # noqa: BLE001 — typed failure, never silent
            _emit_line(event="replay_shard_restore_failed",
                       shard=args.shard_id,
                       error=f"{type(e).__name__}: {e}")
            return 2
        if restored_step is not None:
            d = replay.digest(with_crc=True)
            _emit_line(event="replay_shard_recovered", shard=args.shard_id,
                       incarnation=args.incarnation, step=restored_step,
                       **d)
    chaos = None
    if args.rpc_delay_ms or args.rpc_drop_rate:
        from ape_x_dqn_tpu_torch.obs.chaos import RpcChaos

        chaos = RpcChaos(delay_ms=args.rpc_delay_ms,
                         drop_rate=args.rpc_drop_rate,
                         seed=args.chaos_seed)
    server = ReplayShardServer(
        replay, args.shard_id, incarnation=args.incarnation,
        token=args.token, host=args.host, port=args.port, codec=args.codec,
        max_request_bytes=args.max_request_bytes,
        ckpt_dir=args.ckpt_dir or None, save_every_s=args.save_every_s,
        base_every=args.base_every, chaos=chaos,
        on_event=lambda kind, **f: _emit_line(event=kind, **f),
    )
    server.start()
    _emit_line(event="replay_shard_listen", shard=args.shard_id,
               incarnation=args.incarnation, port=server.port,
               pid=os.getpid(), capacity=args.capacity,
               restored_step=restored_step)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.wait(0.25):
        pass
    server.close()
    _emit_line(event="replay_shard_stopped", shard=args.shard_id,
               **{k: v for k, v in server.stats().items()
                  if k in ("requests", "torn_frames", "add_dups")})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
