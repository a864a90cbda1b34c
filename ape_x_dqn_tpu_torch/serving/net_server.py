"""Socket front end for the policy tier: framed request/reply serving.

Port of ``ape_x_dqn_tpu/serving/net_server.py`` (:96-821), speaking the
same bytes (``runtime/net.py``): a nonblocking acceptor/pump thread reads
the length-prefixed CRC-framed protocol and feeds every verified request
into ``PolicyServer.submit``; replies ride back on the batcher thread's
future callbacks into per-connection outboxes that the select loop
flushes, so the loop never blocks on compute and the batcher never blocks
on a slow client.

  * **Hellos.**  v1 (anonymous, single requests) and v2 (fleet workers:
    worker id, attempt, run token, codec, flags).  A server started with a
    run token rejects a v2 hello carrying another before any framing.
  * **Torn frames are counted, never decoded.**  Truncation, a crc bit
    flip, a seq skip, a length prefix over ``max_request_bytes`` or a
    reply kind from a client retires the CONNECTION; nothing from the bad
    stream reaches the batcher.
  * **Typed refusals.**  Load shed (``ServerOverloaded``), shutdown
    (``ServerClosed``), an undecodable request and a failed batch go back
    as ``F_SERR`` frames with typed codes.
  * **Batched inference** (``F_IREQ``): each row of a worker's request
    goes into the batcher on its own, and the ``F_IREP`` leaves when the
    last row is done, carrying the oldest param version of its rows.
  * Every reply carries ``param_version``; per-request latency, per-source
    (worker id) counts, and trace spans when the hello sets
    ``HELLO_FLAG_TRACE``.

``ServingClient`` is the reference single-request client: blocking calls
with reconnect-with-backoff and whole-request retry.
"""

from __future__ import annotations

import collections
import select
import socket
import threading
import time
from typing import Optional

from ape_x_dqn_tpu_torch.obs.lineage import BucketExemplars, TraceSpanLog
from ape_x_dqn_tpu_torch.runtime.net import (
    CODEC_OFF,
    E_BAD_REQUEST,
    E_CLOSED,
    E_INTERNAL,
    E_OVERLOADED,
    F_IREP,
    F_IREQ,
    F_SERR,
    F_SREP,
    F_SREQ,
    HELLO_FLAG_TRACE,
    SERVE_HELLO,
    SERVE_HELLO_EXT,
    SERVE_MAGIC,
    SERVE_VERSION_EXT,
    Backoff,
    FrameParser,
    decode_error,
    decode_inference_request,
    decode_reply,
    decode_request,
    encode_error,
    encode_inference_reply,
    encode_reply,
    encode_request,
    frame_bytes,
    parse_serve_hello,
    parse_serve_hello_ext,
    serve_hello_bytes,
    serve_hello_ext_bytes,
    split_trace,
    wrap_trace,
)
from ape_x_dqn_tpu_torch.serving.batcher import (
    ServedAction,
    ServerClosed,
    ServerOverloaded,
    ServingError,
)
from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

_RECV_CHUNK = 1 << 16
_HELLO_SIZE = len(serve_hello_bytes())
_MAX_VERSIONS = 4   # per-version latency splits kept (newest versions)


class _NetConn:
    """One client connection's state, owned by the pump thread (outbox
    appends come from batcher callbacks under the server lock)."""

    __slots__ = ("sock", "parser", "hello", "hello_need", "hello_done",
                 "wid", "codec", "flags", "outbox", "out_off", "out_seq",
                 "bytes_in", "bytes_out", "inflight")

    def __init__(self, sock: socket.socket, max_frame: int):
        self.sock = sock
        self.parser = FrameParser(max_frame=max_frame)
        self.hello = bytearray()          # hello bytes gathered so far
        self.hello_need = _HELLO_SIZE     # grows for a v2 hello
        self.hello_done = False
        self.wid: Optional[int] = None    # v2 hellos: the fleet worker id
        self.codec = CODEC_OFF            # negotiated obs-payload codec
        self.flags = 0                    # v2 hello feature flags (trace)
        self.outbox: collections.deque = collections.deque()
        self.out_off = 0                  # send offset into outbox[0]
        self.out_seq = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.inflight = 0                 # submitted, reply not yet queued


class ServingNetServer:
    """Multi-client socket acceptor over one PolicyServer.

    One daemon thread runs accept + recv + parse + submit + flush in a
    select loop; batcher-thread future callbacks enqueue replies and wake
    it through a socketpair.  ``stats()`` is the ``serving_net`` JSONL
    section, with the JAX package's keys.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0, *,
                 max_request_bytes: int = 8 << 20,
                 run_token: int = 0, name: str = "serving-net"):
        self._server = server
        self._max_frame = int(max_request_bytes)
        # Fleet-internal hello discipline (central inference): a nonzero
        # run_token makes every v2 hello prove it belongs to THIS run —
        # a stale worker from another run (or a guessing client) is
        # rejected before any framing state.  v1 anonymous hellos stay
        # accepted either way: the single-request front door is public.
        self._run_token = int(run_token)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(256)
        self._lsock.setblocking(False)
        self.host = host
        self.port = self._lsock.getsockname()[1]
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._lock = threading.Lock()     # conn registry + outboxes
        self._conns: dict = {}            # fileno -> _NetConn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._started = False
        # Counters (the serving_net schema).
        self.latency = LatencyHistogram()
        # Trace exemplars: the newest sampled trace id per latency
        # bucket, so a p99 spike on the fleet rollup links to an
        # assembled cross-tier timeline instead of a bare number.
        self.exemplars = BucketExemplars(self.latency)
        # Per-param_version split of the reply latency (the canary
        # sensor): newest _MAX_VERSIONS versions only — a long run
        # reloads thousands of times, the comparison needs two or three.
        self._by_version: dict = {}   # version -> {replies, hist}
        self.accepted = 0
        self.requests = 0
        self.replies = 0
        self.shed = 0
        self.errors = 0          # bad requests + batch exceptions replied
        self.torn_frames = 0
        self.bad_hellos = 0
        self.token_rejects = 0   # v2 hellos with the wrong run token
        self.orphaned = 0        # replies whose connection was already gone
        # Fleet-internal inference traffic (F_IREQ/F_IREP): batched
        # requests and the rows they carried, plus per-source accounting
        # keyed by the hello's worker id (the obs `sources` sub-dict).
        self.inference_requests = 0
        self.inference_rows = 0
        self.inference_replies = 0
        self._sources: dict = {}
        # Cross-tier trace spans: a trace-negotiated connection's requests
        # lead with an i64 trace id; the server records its hop (decode →
        # reply queued) plus the batcher leg.
        self.spans = TraceSpanLog(depth=64)
        # Retired-connection byte history (a reconnecting client must not
        # take its traffic with it — the NetTransport._base discipline).
        self._bytes_in_closed = 0
        self._bytes_out_closed = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingNetServer":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._wake()
        if self._started:
            self._thread.join(timeout=5.0)
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

    def __enter__(self) -> "ServingNetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
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
                # A socket closed under us mid-select: rebuild the sets.
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
                self._conns[sock.fileno()] = _NetConn(sock, self._max_frame)

    def _retire(self, conn: _NetConn, torn: bool = False) -> None:
        """Close one connection; a partial frame left in its parser (or a
        parser fault) counts torn — detected, never delivered."""
        if torn or conn.parser.pending() or conn.parser.error is not None:
            self.torn_frames += 1
        with self._lock:
            self._conns.pop(conn.sock.fileno(), None)
            self._bytes_in_closed += conn.bytes_in
            self._bytes_out_closed += conn.bytes_out
        try:
            conn.sock.close()
        except OSError:
            pass

    def _on_readable(self, conn: _NetConn) -> None:
        while True:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._retire(conn)
                return
            if not data:
                # The peer's FIN: frames it sent whole before it are not
                # torn (no one is left to answer them, so they are dropped);
                # only a partial frame or a parser fault is.  The JAX copy
                # counts whole frames read in the same wakeup as the FIN.
                if conn.hello_done:
                    while conn.parser.next() is not None:
                        pass
                self._retire(conn)
                return
            conn.bytes_in += len(data)
            while not conn.hello_done and data:
                need = conn.hello_need - len(conn.hello)
                conn.hello += data[:need]
                data = data[need:]
                if len(conn.hello) < conn.hello_need:
                    break
                if not self._admit_hello(conn):
                    return
            if not conn.hello_done:
                continue
            if data:
                conn.parser.feed(data)
        if conn.hello_done:
            self._drain_frames(conn)

    def _admit_hello(self, conn: _NetConn) -> bool:
        """Validate the gathered hello bytes (v1 anonymous or the v2
        fleet extension).  A v2 version word promises the extension
        struct right behind it — grow the want and keep gathering.
        False = rejected and retired (nothing framed yet)."""
        buf = bytes(conn.hello)
        if len(buf) == _HELLO_SIZE:
            if parse_serve_hello(buf):
                conn.hello_done = True
                return True
            try:
                magic, version = SERVE_HELLO.unpack(buf)
            except Exception:  # noqa: BLE001 — malformed header
                magic, version = b"", -1
            if magic == SERVE_MAGIC and version == SERVE_VERSION_EXT:
                conn.hello_need = _HELLO_SIZE + SERVE_HELLO_EXT.size
                return True
            self.bad_hellos += 1
            self._retire(conn)
            return False
        ext = parse_serve_hello_ext(buf[_HELLO_SIZE:])
        if ext is None:
            self.bad_hellos += 1
            self._retire(conn)
            return False
        if self._run_token and ext["token"] != self._run_token:
            self.token_rejects += 1
            self.bad_hellos += 1
            self._retire(conn)
            return False
        conn.wid = ext["wid"]
        conn.codec = ext["codec"]
        conn.flags = ext["flags"]
        conn.hello_done = True
        return True

    def _drain_frames(self, conn: _NetConn) -> None:
        while True:
            got = conn.parser.next()
            if got is None:
                if conn.parser.error is not None:
                    self._retire(conn, torn=True)
                return
            kind, payload = got
            if kind == F_SREQ:
                self._handle_request(conn, payload)
            elif kind == F_IREQ:
                self._handle_inference(conn, payload)
            else:
                # Protocol violation (reply kinds only flow server→client):
                # stream corruption, connection-level recovery.
                self._retire(conn, torn=True)
                return

    def _handle_request(self, conn: _NetConn, payload: bytes) -> None:
        t0 = time.monotonic()
        trace_id = 0
        try:
            if conn.flags & HELLO_FLAG_TRACE:
                trace_id, payload = split_trace(payload)
            req_id, obs = decode_request(bytes(payload))
        except ValueError as e:
            self.errors += 1
            self._enqueue(conn, F_SERR, encode_error(0, E_BAD_REQUEST,
                                                     str(e)))
            return
        self.requests += 1
        try:
            fut = self._server.submit(obs)
        except ServerOverloaded as e:
            self.shed += 1
            self._enqueue(conn, F_SERR,
                          encode_error(req_id, E_OVERLOADED, str(e)))
            return
        except ServerClosed as e:
            self._enqueue(conn, F_SERR, encode_error(req_id, E_CLOSED,
                                                     str(e)))
            return
        conn.inflight += 1
        fut.add_done_callback(
            lambda f, c=conn, rid=req_id, t=t0, tid=trace_id:
            self._complete(c, rid, t, f, tid)
        )

    def _complete(self, conn: _NetConn, req_id: int, t0: float,
                  fut, trace_id: int = 0) -> None:
        """Batcher-thread callback: encode the reply and queue it on the
        connection's outbox (or count it orphaned if the client is gone —
        it has already reconnected and retried elsewhere)."""
        exc = fut.exception()
        if exc is None:
            res: ServedAction = fut.result()
            body = encode_reply(req_id, res.action, res.param_version,
                                res.q_values)
            kind = F_SREP
        elif isinstance(exc, ServerClosed):
            body, kind = encode_error(req_id, E_CLOSED, str(exc)), F_SERR
        else:
            self.errors += 1
            body = encode_error(req_id, E_INTERNAL,
                                f"{type(exc).__name__}: {exc}")
            kind = F_SERR
        conn.inflight -= 1
        if not self._enqueue(conn, kind, body):
            self.orphaned += 1
            return
        if exc is None:
            self.replies += 1
            self._record_reply(res.param_version,
                               time.monotonic() - t0, trace_id)
            self.spans.record(trace_id, "serve.request", t0, wid=conn.wid)

    def _record_reply(self, version: int, dt: float, trace_id: int) -> None:
        """One reply's latency, recorded three ways: the lifetime
        histogram, its bucket exemplar (the trace id that landed there),
        and the per-param_version split the canary comparison reads."""
        self.latency.record(dt)
        self.exemplars.record(dt, trace_id)
        with self._lock:
            row = self._by_version.get(int(version))
            if row is None:
                row = self._by_version[int(version)] = {
                    "replies": 0, "hist": LatencyHistogram()
                }
                while len(self._by_version) > _MAX_VERSIONS:
                    del self._by_version[min(self._by_version)]
            row["replies"] += 1
            row["hist"].record(dt)

    # -- batched fleet inference (F_IREQ/F_IREP) ---------------------------

    def _source_count(self, wid, rows: int = 0, replies: int = 0) -> None:
        if wid is None:
            return
        with self._lock:
            src = self._sources.setdefault(
                str(wid), {"requests": 0, "rows": 0, "replies": 0}
            )
            if rows:
                src["requests"] += 1
                src["rows"] += rows
            if replies:
                src["replies"] += replies

    def _handle_inference(self, conn: _NetConn, payload: bytes) -> None:
        """One batched request: every row rides the micro-batcher as its
        own submit (so rows pad/batch with everything else in flight —
        the whole point of central inference), and the reply goes out
        when the LAST row's future lands.  ε is never applied here: the
        reply carries greedy actions + q rows, the worker's ladder slice
        stays worker-side (pinned by test)."""
        t0 = time.monotonic()
        trace_id = 0
        try:
            if conn.flags & HELLO_FLAG_TRACE:
                trace_id, payload = split_trace(payload)
            req_id, rows = decode_inference_request(
                payload, allow_zlib=conn.codec != CODEC_OFF,
                max_bytes=self._max_frame,
            )
        except ValueError as e:
            # Well-framed but undecodable (the crc already verified the
            # bytes): typed, not torn — the single-request discipline.
            self.errors += 1
            self._enqueue(conn, F_SERR,
                          encode_error(0, E_BAD_REQUEST, str(e)))
            return
        self.inference_requests += 1
        self.inference_rows += len(rows)
        self.requests += 1
        self._source_count(conn.wid, rows=len(rows))
        futures = []
        try:
            for obs in rows:
                futures.append(self._server.submit(obs))
        except ServerOverloaded as e:
            # Whole-request shed: the worker retries the group whole.
            # Rows already admitted complete unobserved (greedy inference
            # is pure — serving them costs one padded row each).
            self.shed += 1
            self._enqueue(conn, F_SERR,
                          encode_error(req_id, E_OVERLOADED, str(e)))
            return
        except ServerClosed as e:
            self._enqueue(conn, F_SERR,
                          encode_error(req_id, E_CLOSED, str(e)))
            return
        conn.inflight += 1
        agg = {"lock": threading.Lock(), "left": len(futures),
               "rows": [None] * len(futures), "exc": None,
               "trace_id": trace_id, "t_submit": time.monotonic()}
        for i, fut in enumerate(futures):
            fut.add_done_callback(
                lambda f, c=conn, rid=req_id, t=t0, a=agg, k=i:
                self._inference_row_done(c, rid, t, a, k, f)
            )

    def _inference_row_done(self, conn: _NetConn, req_id: int, t0: float,
                            agg: dict, k: int, fut) -> None:
        """Batcher-thread callback, once per row; the LAST row assembles
        and queues the F_IREP (or one typed error for the group)."""
        exc = fut.exception()
        with agg["lock"]:
            if exc is not None:
                agg["exc"] = exc
            else:
                agg["rows"][k] = fut.result()
            agg["left"] -= 1
            if agg["left"] > 0:
                return
        import numpy as np

        conn.inflight -= 1
        exc = agg["exc"]
        if exc is not None:
            if isinstance(exc, ServerClosed):
                body, kind = encode_error(req_id, E_CLOSED, str(exc)), F_SERR
            else:
                self.errors += 1
                body = encode_error(req_id, E_INTERNAL,
                                    f"{type(exc).__name__}: {exc}")
                kind = F_SERR
            if not self._enqueue(conn, kind, body):
                self.orphaned += 1
            return
        results = agg["rows"]
        actions = np.asarray([r.action for r in results], np.int32)
        q = np.stack([np.asarray(r.q_values, np.float32) for r in results])
        # Version floor: rows may straddle a hot reload (different
        # batches); the FLEET's freshness claim is the oldest row's.
        version = min(int(r.param_version) for r in results)
        body = encode_inference_reply(req_id, actions, version, q)
        if not self._enqueue(conn, F_IREP, body):
            self.orphaned += 1
            return
        self.replies += 1
        self.inference_replies += 1
        self._source_count(conn.wid, replies=1)
        tid = agg["trace_id"]
        self._record_reply(version, time.monotonic() - t0, tid)
        # Two hops of the e2e inference timeline: the replica's whole
        # service span (decode → reply queued) and the batcher leg inside
        # it (rows submitted → last row's future landed).
        self.spans.record(tid, "serve.infer", t0, wid=conn.wid,
                          rows=len(results))
        self.spans.record(tid, "serve.batch", agg["t_submit"], wid=conn.wid)

    def _enqueue(self, conn: _NetConn, kind: int, body: bytes) -> bool:
        """Queue one outbound frame; False if the connection is gone.
        Seq is assigned under the lock, so outbox order == seq order even
        with the batcher and pump threads both replying."""
        with self._lock:
            if self._conns.get(conn.sock.fileno()) is not conn:
                return False
            conn.out_seq += 1
            conn.outbox.append(frame_bytes(kind, conn.out_seq, [body]))
        self._wake()
        return True

    def _flush(self, conn: _NetConn) -> None:
        while True:
            with self._lock:
                if not conn.outbox:
                    return
                buf = conn.outbox[0]
            try:
                n = conn.sock.send(memoryview(buf)[conn.out_off:])
            except (BlockingIOError, InterruptedError):
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
        """The ``serving_net`` section (the JAX package's key set)."""
        with self._lock:
            conns = list(self._conns.values())
            sources = {k: dict(v) for k, v in self._sources.items()}
            by_version = {
                str(v): {"replies": row["replies"],
                         "latency": row["hist"].summary(),
                         "latency_buckets": row["hist"].buckets()}
                for v, row in sorted(self._by_version.items())
            }
        return {
            "port": self.port,
            "connections": len(conns),
            "accepted": self.accepted,
            "requests": self.requests,
            "replies": self.replies,
            "shed": self.shed,
            "errors": self.errors,
            "torn_frames": self.torn_frames,
            "bad_hellos": self.bad_hellos,
            "token_rejects": self.token_rejects,
            "orphaned": self.orphaned,
            "inference_requests": self.inference_requests,
            "inference_rows": self.inference_rows,
            "inference_replies": self.inference_replies,
            "sources": sources,
            "inflight": sum(c.inflight for c in conns),
            "bytes_in": sum(c.bytes_in for c in conns)
            + self._bytes_in_closed,
            "bytes_out": sum(c.bytes_out for c in conns)
            + self._bytes_out_closed,
            "param_version": int(getattr(self._server, "param_version", -1)),
            "latency": self.latency.summary(),
            # Raw buckets, so replicas merge bucket-wise, and this
            # process's recent cross-tier trace spans.
            "latency_buckets": self.latency.buckets(),
            "latency_exemplars": self.exemplars.snapshot(),
            "by_version": by_version,
            "recent_spans": self.spans.snapshot(),
        }


class ServingClient:
    """Blocking closed-loop client with reconnect + whole-request retry.

    ``act`` sends one observation and waits for ITS reply; any transport
    fault — connect refused, reset mid-flight, torn stream — drops the
    connection, backs off (jittered exponential), reconnects and resends
    the request whole.  A request is only lost when the deadline expires
    (``TimeoutError``), so "zero drops" is measurable client-side:
    every ``act`` call either returns, raises typed, or times out.
    """

    def __init__(self, host: str, port: int, *,
                 connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 5.0, seed: int = 0,
                 max_frame: int = 64 << 20, trace: bool = False,
                 token: int = 0):
        self.host = host
        self.port = int(port)
        self._connect_timeout = float(connect_timeout_s)
        self._io_timeout = float(io_timeout_s)
        self._max_frame = int(max_frame)
        # Tracing needs the v2 hello (the flags byte lives in its
        # extension); a plain client keeps the anonymous v1 hello and the
        # bit-identical wire.  ``token`` rides the v2 hello so a traced
        # client can still talk to a run-token-locked fleet port.
        self.trace = bool(trace)
        self._token = int(token)
        self.spans = TraceSpanLog(depth=64)
        self._sock: Optional[socket.socket] = None
        self._parser = FrameParser(max_frame=max_frame)
        self._backoff = Backoff(base_s=0.05, max_s=1.0, seed=seed)
        self._req_id = 0
        self._out_seq = 0
        self.reconnects = 0
        self.retries = 0
        self.shed_seen = 0
        self._ever_connected = False

    # -- connection --------------------------------------------------------

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        if not self._backoff.ready():
            return False
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self._connect_timeout
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(
                serve_hello_ext_bytes(0, 0, self._token,
                                      flags=HELLO_FLAG_TRACE)
                if self.trace else serve_hello_bytes()
            )
            sock.settimeout(self._io_timeout)
        except OSError:
            self._backoff.fail()
            return False
        self._sock = sock
        self._parser = FrameParser(max_frame=self._max_frame)
        self._out_seq = 0
        # NB: backoff resets on a verified REPLY (act), not here — a
        # router with zero healthy replicas accepts and closes instantly,
        # and resetting on connect would turn that into a tight loop.
        self.reconnects += int(self._ever_connected)
        self._ever_connected = True
        return True

    # -- request path ------------------------------------------------------

    def act(self, obs, timeout: float = 30.0,
            trace_id: int = 0) -> ServedAction:
        """One observation → one ServedAction, across reconnects.

        Raises :class:`ServerOverloaded` on a typed shed reply (counted
        on ``shed_seen`` — the caller decides whether to retry),
        :class:`ServingError` on other typed refusals, and
        ``TimeoutError`` when the deadline expires unanswered.
        ``trace_id`` rides the trace prefix on a trace-mode client."""
        t_start = time.monotonic()
        deadline = t_start + timeout
        first_try = True
        while time.monotonic() < deadline:
            if not self._ensure_connected():
                time.sleep(0.005)
                continue
            if not first_try:
                self.retries += 1
            first_try = False
            self._req_id += 1
            rid = self._req_id
            try:
                payload = encode_request(rid, obs)
                if self.trace:
                    payload = wrap_trace(trace_id, payload)
                self._out_seq += 1
                self._sock.sendall(
                    frame_bytes(F_SREQ, self._out_seq, [payload])
                )
                got = self._await_reply(rid, deadline)
            except (OSError, socket.timeout):
                self._drop()
                self._backoff.fail()
                continue
            if got is None:          # torn stream / stale reply: retry
                continue
            kind, payload = got
            if kind == F_SREP:
                self._backoff.reset()
                req_id, action, version, q = decode_reply(payload)
                self.spans.record(trace_id if self.trace else 0,
                                  "serve.request.client", t_start)
                return ServedAction(action, q, version,
                                    time.monotonic() - t_start)
            req_id, code, msg = decode_error(payload)
            if code == E_OVERLOADED:
                self._backoff.reset()   # transport fine; server is shedding
                self.shed_seen += 1
                raise ServerOverloaded(msg)
            if code == E_CLOSED:
                # Replica draining/shutting down: reconnect (the router
                # re-balances to a live one) rather than failing the call.
                self._drop()
                self._backoff.fail()
                continue
            raise ServingError(f"server error {code}: {msg}")
        raise TimeoutError(
            f"no reply within {timeout:.1f}s "
            f"(retries={self.retries}, reconnects={self.reconnects})"
        )

    def _await_reply(self, rid: int, deadline: float):
        """Frames until ``rid``'s reply (or None to force a retry after a
        dropped connection / torn stream)."""
        while True:
            got = self._parser.next()
            if got is not None:
                kind, payload = got
                if kind == F_SREP:
                    if decode_reply(payload)[0] == rid:
                        return kind, payload
                    continue              # stale reply from a retried req
                if kind == F_SERR:
                    req_id = decode_error(payload)[0]
                    if req_id in (rid, 0):
                        return kind, payload
                    continue
                # Unknown kind: protocol violation — treat as torn.
                self._drop()
                self._backoff.fail()
                return None
            if self._parser.error is not None:
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

    def close(self) -> None:
        self._drop()
