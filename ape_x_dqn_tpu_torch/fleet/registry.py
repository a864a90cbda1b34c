"""The fleet's membership registry and its announce wire.

Port of ``ape_x_dqn_tpu/fleet/registry.py`` (:53-641), line for line: every
fleet member (a serving replica, a replay shard, a worker host) dials the
registry the trainer hosts, proves the run token at a hello that is
rejected by close, and announces itself over ``F_FANN`` frames; the
registry answers every announce with an ``F_FREP`` membership snapshot, so
announcing and watching are one round trip.

Wire (the fourth protocol on ``runtime/net.py``'s framing, byte for byte
the JAX package's):

  * hello, member → registry, once per connection: ``FLEET_HELLO`` =
    "APXF" | u32 version | i64 member_id | i64 incarnation | i64 token;
    a wrong magic, version or token is rejected by close before any
    framing state exists (``bad_hellos``).  The ack is ``FLEET_ACK`` =
    "APXG" | version | token | registry incarnation.
  * announces (``F_FANN``): one JSON doc ``{"op": "join" | "heartbeat" |
    "leave" | "sync", "member": {...}}``; ``sync`` carries no member (the
    observer's read).  Each accepted announce is answered with one
    ``F_FREP`` snapshot ``{"token", "version", "incarnation", "members"}``.
  * a torn or bit-flipped frame (``torn_frames``), an unknown kind
    (``unexpected_kinds``) and an undecodable or ill-shaped doc
    (``bad_announces``) are counted and retire the connection; an announce
    whose incarnation is lower than the registered one is counted
    (``stale_rejects``) and never changes membership.

Liveness is a lease: a member not heard from within ``ttl_s`` is swept
out with a ``member_lost`` event (reason ``ttl``); a ``leave`` is
immediate (reason ``leave``).  Membership versions only grow.

Standard library only: the registry and the announcer run in processes
that never load torch (``tests/test_torch_imports.py`` pins it).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import zlib
from typing import Callable, Dict, Optional

from ape_x_dqn_tpu_torch.runtime.net import (
    Backoff,
    F_FANN,
    F_FREP,
    FLEET_ACK,
    FLEET_ACK_MAGIC,
    FLEET_HELLO,
    FLEET_HELLO_VERSION,
    FLEET_MAGIC,
    FrameParser,
    frame_bytes,
)

_MAX_ANNOUNCE = 1 << 20      # sanity bound: a membership doc is KBs, not GBs
_OPS = ("join", "heartbeat", "leave", "sync")
_MEMBER_KINDS = ("replay_shard", "serving_replica", "worker_host",
                 "trainer", "observer")


def member_id_for(name: str) -> int:
    """Stable i64 id for a member name (the hello's member_id field)."""
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


def member_doc(name: str, kind: str, *, host: str = "", port: int = 0,
               incarnation: int = 1, base: int = 0, capacity: int = 0,
               varz_url: str = "", draining: bool = False) -> dict:
    """One membership row, the shape every tier announces and every
    watcher consumes (the JAX package's docs/METRICS.md, "Fleet membership
    schema")."""
    if kind not in _MEMBER_KINDS:
        raise ValueError(f"unknown member kind: {kind}")
    return {
        "name": str(name),
        "kind": str(kind),
        "id": member_id_for(name),
        "host": str(host),
        "port": int(port),
        "incarnation": int(incarnation),
        "base": int(base),
        "capacity": int(capacity),
        "varz_url": str(varz_url),
        "draining": bool(draining),
    }


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class FleetRegistry:
    """The run's membership table, served over the announce wire.

    Hosted by the trainer (or the driving tool): ``serve()`` binds and
    spawns the accept thread plus the TTL sweeper; members dial
    ``host:port`` with the run token.  All mutation flows through
    ``_apply`` under one lock; ``snapshot()`` is what every ``F_FREP``
    carries and what in-process watchers read directly.
    """

    def __init__(self, *, token: int, host: str = "127.0.0.1",
                 port: int = 0, ttl_s: float = 5.0, incarnation: int = 1,
                 on_event: Optional[Callable[..., None]] = None):
        self.token = int(token)
        self.host = str(host)
        self.port = int(port)
        self.ttl_s = float(ttl_s)
        self.incarnation = int(incarnation)
        self._on_event = on_event
        self._lock = threading.Lock()
        self._members: Dict[str, dict] = {}
        self._last_seen: Dict[str, float] = {}
        self.version = 0
        self._counters = {
            "accepted": 0, "bad_hellos": 0, "torn_frames": 0,
            "unexpected_kinds": 0, "bad_announces": 0, "stale_rejects": 0,
            "announces": 0, "joins": 0, "leaves": 0, "expired": 0,
            "replies": 0,
        }
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: list = []

    # -- events / counters -------------------------------------------------

    def _emit(self, name: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event(name, **fields)
            except Exception:  # noqa: BLE001 — telemetry must not stall membership
                pass

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["members"] = len(self._members)
            out["version"] = self.version
        return out

    # -- membership --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "token": self.token,
                "version": self.version,
                "incarnation": self.incarnation,
                "members": {k: dict(v) for k, v in self._members.items()},
            }

    def members(self, kind: Optional[str] = None) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._members.items()
                    if kind is None or v.get("kind") == kind}

    def _apply(self, op: str, member: Optional[dict]) -> bool:
        """Apply one validated announce; True when membership changed.
        Stale incarnations are counted and REFUSED here — the one gate
        every mutation passes."""
        if op == "sync":
            return False
        if not isinstance(member, dict) or "name" not in member:
            raise ValueError("announce without a member doc")
        doc = member_doc(
            str(member["name"]), str(member.get("kind", "observer")),
            host=str(member.get("host", "")),
            port=int(member.get("port", 0)),
            incarnation=int(member.get("incarnation", 1)),
            base=int(member.get("base", 0)),
            capacity=int(member.get("capacity", 0)),
            varz_url=str(member.get("varz_url", "")),
            draining=bool(member.get("draining", False)),
        )
        name = doc["name"]
        now = time.monotonic()
        with self._lock:
            cur = self._members.get(name)
            if cur is not None and doc["incarnation"] < cur["incarnation"]:
                self._counters["stale_rejects"] += 1
                return False
            if op == "leave":
                if cur is None:
                    return False
                del self._members[name]
                self._last_seen.pop(name, None)
                self.version += 1
                self._counters["leaves"] += 1
                version = self.version
            else:
                fresh = cur is None or cur["incarnation"] < doc["incarnation"]
                changed = cur != doc
                self._members[name] = doc
                self._last_seen[name] = now
                if changed:
                    self.version += 1
                if fresh:
                    self._counters["joins"] += 1
                version = self.version
                if not fresh and not changed:
                    return False
        if op == "leave":
            self._emit("member_lost", member=name, reason="leave",
                       version=version)
        elif fresh:
            self._emit("member_join", member=name, kind=doc["kind"],
                       incarnation=doc["incarnation"], version=version)
        return True

    def sweep(self, now: Optional[float] = None) -> list:
        """Expire members past their lease; returns the names lost.
        Public so tests drive time explicitly."""
        now = time.monotonic() if now is None else float(now)
        lost = []
        with self._lock:
            for name, seen in list(self._last_seen.items()):
                if now - seen > self.ttl_s:
                    member = self._members.pop(name, None)
                    del self._last_seen[name]
                    if member is not None:
                        self.version += 1
                        self._counters["expired"] += 1
                        lost.append((name, self.version))
        for name, version in lost:
            self._emit("member_lost", member=name, reason="ttl",
                       version=version)
        return [name for name, _v in lost]

    # -- the wire ----------------------------------------------------------

    def serve(self) -> "FleetRegistry":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(64)
        sock.settimeout(0.25)
        self.port = sock.getsockname()[1]
        self._sock = sock
        for target, name in ((self._accept_loop, "fleet-accept"),
                             (self._sweep_loop, "fleet-sweep")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="fleet-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _sweep_loop(self) -> None:
        cadence = max(0.05, min(1.0, self.ttl_s / 4.0))
        while not self._stop.wait(cadence):
            self.sweep()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5.0)
            hello = _recv_exact(conn, FLEET_HELLO.size)
            ok = False
            if hello is not None:
                try:
                    magic, version, _mid, _inc, token = \
                        FLEET_HELLO.unpack(hello)
                    ok = (magic == FLEET_MAGIC
                          and version == FLEET_HELLO_VERSION
                          and token == self.token)
                except Exception:  # noqa: BLE001 — a malformed hello is rejected by close, below
                    ok = False
            if not ok:
                # Reject by close: wrong magic/version/token never gets
                # framing state, let alone a membership write.
                self._count("bad_hellos")
                return
            conn.sendall(FLEET_ACK.pack(FLEET_ACK_MAGIC,
                                        FLEET_HELLO_VERSION,
                                        self.token, self.incarnation))
            self._count("accepted")
            self._pump(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _pump(self, conn: socket.socket) -> None:
        parser = FrameParser(max_frame=_MAX_ANNOUNCE)
        reply_seq = 0
        conn.settimeout(max(1.0, self.ttl_s))
        while not self._stop.is_set():
            frame = parser.next()
            if frame is None:
                if parser.error is not None:
                    self._count("torn_frames")
                    return
                try:
                    data = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    data = b""
                if not data:
                    if parser.pending():
                        # Truncated mid-frame at disconnect: torn.
                        self._count("torn_frames")
                    return
                parser.feed(data)
                continue
            kind, payload = frame
            if kind != F_FANN:
                # Unknown kind on the announce plane: counted, connection
                # retired — never silently ignored.
                self._count("unexpected_kinds")
                return
            try:
                doc = json.loads(bytes(payload).decode("utf-8"))
                op = doc["op"]
                if op not in _OPS:
                    raise ValueError(f"unknown announce op: {op}")
                self._apply(op, doc.get("member"))
            except Exception:  # noqa: BLE001 — a bad announce is counted and retires the connection
                self._count("bad_announces")
                return
            self._count("announces")
            reply_seq += 1
            body = json.dumps(self.snapshot()).encode("utf-8")
            try:
                conn.sendall(frame_bytes(F_FREP, reply_seq, (body,)))
            except OSError:
                return
            self._count("replies")

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []


class FleetClient:
    """One member-side connection: hello, announce, read the snapshot.

    Connect-on-demand with ``Backoff`` pacing; every announce is a
    request/reply round trip (``F_FANN`` out, ``F_FREP`` back).  A torn
    or unexpected reply retires the connection and raises — callers
    (the announcer thread, the watcher poll) absorb and retry.
    """

    def __init__(self, host: str, port: int, *, token: int,
                 member_id: int = 0, incarnation: int = 1,
                 timeout_s: float = 2.0, seed: int = 0):
        self.host = str(host)
        self.port = int(port)
        self.token = int(token)
        self.member_id = int(member_id)
        self.incarnation = int(incarnation)
        self.timeout_s = float(timeout_s)
        self._sock: Optional[socket.socket] = None
        self._parser: Optional[FrameParser] = None
        self._seq = 0
        self._backoff = Backoff(base_s=0.05, max_s=1.0, seed=seed)
        self.torn_replies = 0
        self.hello_rejects = 0
        self.reconnects = 0

    def set_endpoint(self, host: str, port: int) -> None:
        if (host, port) != (self.host, self.port):
            self.host, self.port = str(host), int(port)
            self._drop()

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._parser = None
        self._seq = 0

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        sock.sendall(FLEET_HELLO.pack(FLEET_MAGIC, FLEET_HELLO_VERSION,
                                      self.member_id, self.incarnation,
                                      self.token))
        ack = _recv_exact(sock, FLEET_ACK.size)
        if ack is None:
            sock.close()
            self.hello_rejects += 1
            raise ConnectionError("fleet registry rejected the hello")
        magic, _version, token, _reg_inc = FLEET_ACK.unpack(ack)
        if magic != FLEET_ACK_MAGIC or token != self.token:
            sock.close()
            self.hello_rejects += 1
            raise ConnectionError("fleet registry ack mismatch")
        self._sock = sock
        self._parser = FrameParser(max_frame=_MAX_ANNOUNCE)
        self._seq = 0
        self.reconnects += 1
        self._backoff.reset()

    def announce(self, op: str, member: Optional[dict] = None) -> dict:
        """One announce round trip; returns the registry's snapshot."""
        if op not in _OPS:
            raise ValueError(f"unknown announce op: {op}")
        if self._sock is None:
            if not self._backoff.ready():
                raise ConnectionError("fleet registry backoff")
            try:
                self._connect()
            except OSError as e:
                self._backoff.fail()
                raise ConnectionError(f"fleet registry connect: {e}") from e
        try:
            self._seq += 1
            body = json.dumps({"op": op, "member": member}).encode("utf-8")
            self._sock.sendall(frame_bytes(F_FANN, self._seq, (body,)))
            while True:
                frame = self._parser.next()
                if frame is not None:
                    break
                if self._parser.error is not None:
                    self.torn_replies += 1
                    raise ConnectionError(
                        f"torn fleet reply: {self._parser.error}")
                data = self._sock.recv(1 << 16)
                if not data:
                    raise ConnectionError("fleet registry closed")
                self._parser.feed(data)
            kind, payload = frame
            if kind != F_FREP:
                self.torn_replies += 1
                raise ConnectionError(f"unexpected fleet reply kind {kind}")
            return json.loads(bytes(payload).decode("utf-8"))
        except (OSError, ValueError, ConnectionError):
            self._drop()
            self._backoff.fail()
            raise

    def sync(self) -> dict:
        """The observer read path: fetch the snapshot without joining."""
        return self.announce("sync")

    def close(self) -> None:
        self._drop()


class FleetAnnouncer:
    """Member-side lifecycle thread: join, heartbeat, leave.

    One announcer may own SEVERAL member docs (a replay fleet announces
    every shard; a serving fleet every replica) — ``set_member`` adds or
    updates a doc (announced as ``join`` once, ``heartbeat`` after),
    ``remove_member`` announces ``leave``.  With zero members the beat
    degrades to a ``sync`` poll, which is how pure watchers (the replay
    client, the aggregator) ride the same class.  Every successful round
    trip hands the snapshot to ``on_membership`` when its version moved.
    """

    def __init__(self, host: str, port: int, *, token: int,
                 member_id: int = 0, heartbeat_s: float = 1.0,
                 on_membership: Optional[Callable[[dict], None]] = None,
                 on_event: Optional[Callable[..., None]] = None,
                 seed: int = 0):
        self._client = FleetClient(host, port, token=token,
                                   member_id=member_id, seed=seed)
        self.heartbeat_s = float(heartbeat_s)
        self._on_membership = on_membership
        self._on_event = on_event
        self._lock = threading.Lock()
        self._docs: Dict[str, dict] = {}
        self._joined: set = set()
        self._pending_leave: Dict[str, dict] = {}
        self._last_version = -1
        self._membership: dict = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0
        self.errors = 0

    # -- member docs -------------------------------------------------------

    def set_member(self, doc: dict) -> None:
        with self._lock:
            name = doc["name"]
            self._docs[name] = dict(doc)
            self._pending_leave.pop(name, None)
        self._wake.set()

    def remove_member(self, name: str) -> None:
        with self._lock:
            doc = self._docs.pop(name, None)
            self._joined.discard(name)
            if doc is not None:
                self._pending_leave[name] = doc
        self._wake.set()

    def membership(self) -> dict:
        with self._lock:
            return dict(self._membership)

    # -- the beat ----------------------------------------------------------

    def poke(self) -> None:
        """Wake the beat thread now (fast propagation after set_member)."""
        self._wake.set()

    def beat_once(self) -> bool:
        """One announce sweep; True when every round trip succeeded.
        Public so tests (and the registry-less unit path) drive it
        synchronously."""
        with self._lock:
            docs = [dict(d) for d in self._docs.values()]
            leaves = dict(self._pending_leave)
            joined = set(self._joined)
        ok = True
        snapshot = None
        for name, doc in leaves.items():
            try:
                snapshot = self._client.announce("leave", doc)
                with self._lock:
                    self._pending_leave.pop(name, None)
            except ConnectionError:
                self.errors += 1
                ok = False
        for doc in docs:
            op = "heartbeat" if doc["name"] in joined else "join"
            try:
                snapshot = self._client.announce(op, doc)
                with self._lock:
                    self._joined.add(doc["name"])
            except ConnectionError:
                self.errors += 1
                ok = False
        if not docs and not leaves:
            try:
                snapshot = self._client.sync()
            except ConnectionError:
                self.errors += 1
                ok = False
        if snapshot is not None:
            self.beats += 1
            self._adopt(snapshot)
        return ok

    def _adopt(self, snapshot: dict) -> None:
        version = int(snapshot.get("version", -1))
        with self._lock:
            moved = version != self._last_version
            if moved:
                self._last_version = version
                self._membership = snapshot
        if moved and self._on_membership is not None:
            try:
                self._on_membership(snapshot)
            except Exception:  # noqa: BLE001 — a sick watcher must not stall heartbeats
                if self._on_event is not None:
                    try:
                        self._on_event("fleet_watch_error", version=version)
                    except Exception:  # noqa: BLE001 — telemetry must not stall heartbeats
                        pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat_once()
            self._wake.wait(self.heartbeat_s)
            self._wake.clear()

    def start(self) -> "FleetAnnouncer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="fleet-announce",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self, leave: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            self._thread = None
        if leave:
            with self._lock:
                docs = list(self._docs.values())
                self._docs.clear()
                self._joined.clear()
            for doc in docs:
                try:
                    self._client.announce("leave", doc)
                except ConnectionError:
                    self.errors += 1
        self._client.close()
