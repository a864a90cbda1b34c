"""Central inference: paramless actors, batched action selection.

Port of ``ape_x_dqn_tpu/serving/central.py`` (:74-526).  The network stays
on the learner's card; actors become env shells that ship observations and
receive actions (SEED-style, ``actor.inference=central``):

  * **CentralInferenceClient** — one persistent CRC-framed connection to
    a ``ServingNetServer`` (or a router in front of several).  Each fleet
    step's observation batch splits into ``inflight`` contiguous row
    groups, all in flight at once as ``F_IREQ`` frames, so the central
    micro-batcher sees concurrency even from one worker.  The rows ride
    the ``F_XPB`` container (in-request frame dedup and the codec the v2
    hello negotiated).  A torn, bit-flipped or oversized reply frame is
    counted and never decoded; the connection is retired, the client
    reconnects with backoff and retries the whole request, and gives up
    only when the caller's deadline expires — the typed
    :class:`InferenceUnavailable`.
  * **CentralSelector** — the ``ActorFleet`` action-selection seam.  The
    reply carries greedy actions, q rows and ``param_version``; ε-greedy
    is applied here, on the worker, from its slice of the global ε-ladder
    with ``np.random.default_rng(seed)``, so the same replies and seed
    give the same actions in both packages.  The q rows feed the fleet's
    priority math as local q values do.  On a serving outage the selector
    blocks with the stall counted, or, with
    ``actor.inference_fallback=local``, acts from a caller-supplied local
    fallback (the fleet's cached-params policy step).

Standard library, numpy and the port's ``runtime/net.py`` only: worker
processes import this module before anything else.
"""

from __future__ import annotations

import socket
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ape_x_dqn_tpu_torch.obs.lineage import BucketExemplars, TraceSpanLog
from ape_x_dqn_tpu_torch.runtime.net import (
    CODEC_OFF,
    CODEC_ZLIB,
    E_CLOSED,
    E_OVERLOADED,
    F_IREP,
    F_SERR,
    HELLO_FLAG_TRACE,
    Backoff,
    FrameParser,
    close_gracefully,
    decode_error,
    decode_inference_reply,
    encode_inference_request,
    frame_bytes,
    serve_hello_ext_bytes,
    wrap_trace,
)
from ape_x_dqn_tpu_torch.runtime.net import F_IREQ as _F_IREQ
from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

_RECV_CHUNK = 1 << 16
_CODEC_IDS = {"off": CODEC_OFF, "zlib": CODEC_ZLIB}


class InferenceUnavailable(Exception):
    """The serving tier did not answer within the caller's deadline
    (across reconnects and whole-request retries) — the typed
    degradation signal; the worker decides block-and-retry vs local
    fallback, never trains on garbage."""


def split_groups(n: int, k: int) -> List[Tuple[int, int]]:
    """[lo, hi) row groups: ``min(k, n)`` contiguous slices, balanced the
    same way worker_slice carves the actor set."""
    k = max(1, min(int(k), int(n)))
    return [(g * n // k, (g + 1) * n // k) for g in range(k)]


class CentralInferenceClient:
    """Pipelined batched-inference client over one serving connection."""

    def __init__(self, host: str, port: int, *, wid: int = 0,
                 attempt: int = 0, token: int = 0, codec: str = "off",
                 dedup: bool = True, inflight: int = 4,
                 connect_timeout_s: float = 2.0, io_timeout_s: float = 5.0,
                 max_frame: int = 64 << 20, seed: int = 0,
                 trace: bool = False, span_recorder=None):
        if codec not in _CODEC_IDS:
            raise ValueError(f"unknown inference codec: {codec}")
        # Cross-tier tracing: negotiated via the v2 hello's flags byte;
        # with it every F_IREQ leads with an i64 trace id and each
        # verified group reply records a client-side hop span (mirrored
        # into ``span_recorder`` — the worker's flight recorder — so the
        # span survives a SIGKILL via the shm event ring).
        self.trace = bool(trace)
        self.spans = TraceSpanLog(depth=64, recorder=span_recorder)
        self.host = host
        self.port = int(port)
        self.wid = int(wid)
        self.attempt = int(attempt)
        self.token = int(token)
        self._codec_id = _CODEC_IDS[codec]
        self._dedup = bool(dedup)
        self.inflight = max(1, int(inflight))
        self._connect_timeout = float(connect_timeout_s)
        self._io_timeout = float(io_timeout_s)
        self._max_frame = int(max_frame)
        self._sock: Optional[socket.socket] = None
        self._parser = FrameParser(max_frame=max_frame)
        self._backoff = Backoff(base_s=0.05, max_s=1.0,
                                seed=(int(wid) << 8) ^ int(attempt) ^ seed)
        self._req_id = 0
        self._out_seq = 0
        self._ever_connected = False
        # Counters (the worker half of the obs `inference` section).
        self.rtt = LatencyHistogram()
        # Newest trace id per rtt bucket: an rtt p99 spike on the fleet
        # rollup links to an assembled cross-tier timeline.
        self.rtt_exemplars = BucketExemplars(self.rtt)
        self.requests = 0        # group requests sent (incl. resends)
        self.rows = 0            # observation rows shipped
        self.replies = 0         # verified F_IREP replies adopted
        self.retries = 0         # whole-request resend rounds
        self.reconnects = 0
        self.shed_seen = 0       # typed E_OVERLOADED refusals
        self.torn_replies = 0    # reply-stream framing faults (never decoded)
        self.errors = 0          # other typed refusals seen
        self.stall_s = 0.0       # wall time blocked past the first attempt
        self.fallback_steps = 0  # selector-side; lives here so one dict ships
        self.param_version = -1  # newest version seen in a reply
        self.wire_bytes_out = 0
        self.logical_bytes_out = 0
        self.dedup_ref_bytes = 0
        self.compressed_frames = 0

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
            sock.sendall(serve_hello_ext_bytes(
                self.wid, self.attempt, self.token, self._codec_id,
                flags=HELLO_FLAG_TRACE if self.trace else 0,
            ))
            sock.settimeout(self._io_timeout)
        except OSError:
            self._backoff.fail()
            return False
        self._sock = sock
        self._parser = FrameParser(max_frame=self._max_frame)
        self._out_seq = 0
        # Backoff resets on a verified REPLY, not here: a router with no
        # healthy replica accepts and closes instantly — resetting on
        # connect would turn that outage into a tight loop.
        self.reconnects += int(self._ever_connected)
        self._ever_connected = True
        return True

    # -- the select path ---------------------------------------------------

    def select(self, obs_batch, *, deadline: Optional[float] = None,
               should_stop: Optional[Callable[[], bool]] = None,
               timeout_s: float = 30.0, trace_id: int = 0):
        """One fleet step's action selection: (int32 actions [N],
        float32 q [N, A], param_version).

        Splits the batch into ``inflight`` pipelined group requests; any
        transport fault retires the connection and the WHOLE select
        retries (fresh req_ids, one counted retry round) until the
        deadline — then typed :class:`InferenceUnavailable`.  The greedy
        rows come back exactly as the server computed them; ε is the
        caller's (CentralSelector)."""
        obs = np.ascontiguousarray(obs_batch, dtype=np.uint8)
        n = obs.shape[0]
        groups = split_groups(n, self.inflight)
        t_start = time.monotonic()
        if deadline is None:
            deadline = t_start + float(timeout_s)
        first_round = True
        while time.monotonic() < deadline:
            if should_stop is not None and should_stop():
                raise InferenceUnavailable("stopped while selecting")
            if not self._ensure_connected():
                # Bounded stall accounting: time spent with no serving
                # connection is the outage the operator sees as stall_ms.
                self.stall_s += 0.005
                time.sleep(0.005)
                continue
            if not first_round:
                self.retries += 1
            first_round = False
            t_round = time.monotonic()
            try:
                got = self._round(obs, groups, deadline, should_stop,
                                  trace_id)
            except (OSError, socket.timeout):
                self._drop()
                self._backoff.fail()
                self.stall_s += time.monotonic() - t_round
                continue
            if got is None:
                # Torn stream / typed refusal: the round's time was
                # stalled work — count it, retry whole.
                self.stall_s += time.monotonic() - t_round
                continue
            actions, q, version = got
            self.param_version = max(self.param_version, version)
            return actions, q, version
        raise InferenceUnavailable(
            f"no inference reply within {deadline - t_start:.1f}s "
            f"(retries={self.retries}, reconnects={self.reconnects})"
        )

    def _round(self, obs, groups, deadline, should_stop, trace_id=0):
        """Send every group, await every reply.  None forces a whole
        retry (after a drop/backoff where the transport faulted)."""
        if not self.trace:
            trace_id = 0
        pending: dict = {}
        t_send: dict = {}
        for lo, hi in groups:
            self._req_id += 1
            rid = self._req_id
            sub = obs[lo:hi]
            payload, st = encode_inference_request(
                rid, sub, codec=self._codec_id, dedup=self._dedup
            )
            if self.trace:
                payload = wrap_trace(trace_id, payload)
            self._out_seq += 1
            buf = frame_bytes(_F_IREQ, self._out_seq, [payload])
            self._sock.sendall(buf)
            pending[rid] = (lo, hi)
            t_send[rid] = time.monotonic()
            self.requests += 1
            self.rows += hi - lo
            self.wire_bytes_out += len(buf)
            self.logical_bytes_out += sub.nbytes
            self.dedup_ref_bytes += st["dedup_bytes"]
            self.compressed_frames += int(st["compressed"])
        n = obs.shape[0]
        actions = np.zeros(n, np.int32)
        q: Optional[np.ndarray] = None
        version = None
        while pending:
            if should_stop is not None and should_stop():
                raise InferenceUnavailable("stopped while selecting")
            got = self._parser.next()
            if got is None:
                if self._parser.error is not None:
                    # Torn reply stream (truncation / crc / seq / length):
                    # counted, never decoded, connection retired.
                    self.torn_replies += 1
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
                continue
            kind, payload = got
            if kind == F_IREP:
                try:
                    rid, acts, ver, qg = decode_inference_reply(payload)
                except ValueError:
                    # Well-framed but inconsistent reply: protocol
                    # violation — torn discipline, retire + retry.
                    self.torn_replies += 1
                    self._drop()
                    self._backoff.fail()
                    return None
                span = pending.pop(rid, None)
                if span is None:
                    continue        # stale reply from a retried round
                lo, hi = span
                if acts.shape[0] != hi - lo:
                    self.torn_replies += 1
                    self._drop()
                    self._backoff.fail()
                    return None
                if q is None:
                    q = np.zeros((n, qg.shape[1]), np.float32)
                actions[lo:hi] = acts
                q[lo:hi] = qg
                version = ver if version is None else min(version, ver)
                self.replies += 1
                self._backoff.reset()
                rtt_s = time.monotonic() - t_send[rid]
                self.rtt.record(rtt_s)
                self.rtt_exemplars.record(rtt_s, trace_id)
                self.spans.record(trace_id, "inf.select.client",
                                  t_send[rid], rows=hi - lo, wid=self.wid)
                continue
            if kind == F_SERR:
                rid, code, msg = decode_error(payload)
                if code == E_OVERLOADED:
                    # Typed shed: transport is fine, server is shedding —
                    # back off briefly and retry the select whole (an env
                    # step cannot be dropped, unlike a loadgen request).
                    self.shed_seen += 1
                    time.sleep(0.01)
                    return None
                if code == E_CLOSED:
                    # Replica draining: reconnect through the router.
                    self._drop()
                    self._backoff.fail()
                    return None
                self.errors += 1
                self._drop()
                self._backoff.fail()
                return None
            # Unknown kind on this plane: protocol violation — torn.
            self.torn_replies += 1
            self._drop()
            self._backoff.fail()
            return None
        return actions, q, int(version if version is not None else -1)

    # -- observability -----------------------------------------------------

    def stats(self, include_hist: bool = False) -> dict:
        out = {
            "requests": self.requests,
            "rows": self.rows,
            "replies": self.replies,
            "retries": self.retries,
            "reconnects": self.reconnects,
            "shed_seen": self.shed_seen,
            "torn_replies": self.torn_replies,
            "errors": self.errors,
            "stall_ms": round(self.stall_s * 1e3, 1),
            "fallback_steps": self.fallback_steps,
            "param_version": self.param_version,
            "wire_bytes_out": self.wire_bytes_out,
            "logical_bytes_out": self.logical_bytes_out,
            "dedup_ref_bytes": self.dedup_ref_bytes,
            "compressed_frames": self.compressed_frames,
            "rtt": self.rtt.summary(),
            "rtt_exemplars": self.rtt_exemplars.snapshot(),
        }
        if include_hist:
            with self.rtt._lock:
                out["rtt_state"] = {
                    "counts": list(self.rtt._counts),
                    "count": self.rtt._count,
                    "sum": self.rtt._sum,
                    "max": self.rtt._max,
                }
        return out

    def close(self) -> None:
        """Teardown: requests already written still reach the server whole
        (``runtime/net.close_gracefully``), never cut by a reset."""
        if self._sock is not None:
            close_gracefully(self._sock)
            self._sock = None


def aggregate_inference_stats(stats_dicts, mode: str = "central") -> dict:
    """Fleet-wide ``inference`` section from per-client snapshots
    (``stats(include_hist=True)`` dicts, one per worker/selector):
    counter sums + merged round-trip percentiles — the one shape both
    the process pool and the thread fleets report (the JAX package's
    ``inference`` keys)."""
    dicts = list(stats_dicts)
    agg = {k: 0 for k in (
        "requests", "rows", "replies", "retries", "reconnects",
        "shed_seen", "torn_replies", "errors", "fallback_steps",
        "selects", "outages",
    )}
    stall = 0.0
    version = -1
    wire = logical = 0
    hist = LatencyHistogram()
    exemplars: dict = {}
    for st in dicts:
        for k in agg:
            agg[k] += int(st.get(k, 0))
        stall += float(st.get("stall_ms", 0.0))
        v = int(st.get("param_version", -1))
        version = v if version < 0 else min(version, v)
        wire += int(st.get("wire_bytes_out", 0))
        logical += int(st.get("logical_bytes_out", 0))
        rs = st.get("rtt_state")
        if rs:
            merge_rtt_state(hist, rs)
        ex = st.get("rtt_exemplars")
        if isinstance(ex, dict):
            exemplars.update(ex)
    agg.update(
        rtt_exemplars=exemplars,
        mode=mode,
        workers_reporting=len(dicts),
        stall_ms=round(stall, 1),
        param_version=version,
        wire_bytes_out=wire,
        logical_bytes_out=logical,
        wire_over_logical=(round(wire / logical, 4) if logical else None),
        rtt=hist.summary(),
    )
    return agg


def merge_rtt_state(hist: LatencyHistogram, state: dict) -> None:
    """Fold one client's shipped histogram state (``stats(include_hist=
    True)['rtt_state']``) into an aggregate with the default layout —
    how the pool builds fleet-wide round-trip percentiles from per-worker
    control-queue snapshots."""
    counts = state.get("counts")
    if not counts or len(counts) != len(hist._counts):
        return
    with hist._lock:
        hist._counts = [a + int(b) for a, b in zip(hist._counts, counts)]
        hist._count += int(state.get("count", 0))
        hist._sum += float(state.get("sum", 0.0))
        hist._max = max(hist._max, float(state.get("max", 0.0)))


class CentralSelector:
    """The ActorFleet action-selection seam for central mode.

    ``select(obs, step) -> (actions, q, param_version)`` — greedy rows
    from the serving tier, ε-greedy applied here from the worker's
    global-ladder slice with a seeded numpy stream (the local mode's
    on-device ε, relocated: same ε values, an independent stream; the
    same replies and seed give the same actions in both packages).
    """

    def __init__(self, client: CentralInferenceClient, epsilons,
                 num_actions: int, *, seed: int = 0,
                 timeout_s: float = 30.0,
                 trace_sample_rate: float = 0.0,
                 fallback: Optional[Callable] = None,
                 should_stop: Optional[Callable[[], bool]] = None):
        self.client = client
        self.epsilons = np.asarray(epsilons, np.float64).reshape(-1)
        self.num_actions = int(num_actions)
        self._rng = np.random.default_rng(seed)
        self._timeout_s = float(timeout_s)
        # Cross-tier trace sampling (obs.trace_sample_rate's inference
        # twin): a sampled select stamps one 63-bit id shared by all its
        # pipelined groups — the worker → replica timeline's key.
        self._trace_rate = float(trace_sample_rate)
        import random as _random

        self._trace_rng = _random.Random((seed << 8) ^ 0x7A5)
        # Local-fallback seam (actor.inference_fallback=local): a
        # callable (obs, step) -> (actions, q, version) over CACHED
        # params — it applies its own ε in-graph (it IS the local path),
        # so fallback rows skip the worker-side ε below.
        self._fallback = fallback
        self._should_stop = should_stop
        self.selects = 0
        self.outages = 0          # selects that hit the typed deadline

    def select(self, obs, step: int):
        self.selects += 1
        trace_id = 0
        if self._trace_rate and self.client.trace \
                and self._trace_rng.random() < self._trace_rate:
            trace_id = self._trace_rng.getrandbits(63) or 1
        while True:
            try:
                greedy, q, version = self.client.select(
                    obs, timeout_s=self._timeout_s,
                    should_stop=self._should_stop,
                    trace_id=trace_id,
                )
                break
            except InferenceUnavailable:
                self.outages += 1
                if self._should_stop is not None and self._should_stop():
                    raise
                if self._fallback is not None:
                    self.client.fallback_steps += 1
                    return self._fallback(obs, step)
                # No fallback configured: BLOCK with the stall counted
                # (client.stall_s) and retry — a paramless worker has no
                # other source of actions, and a mid-quantum raise would
                # drop the quantum's already-emitted chunks.  The stop
                # event is the only exit.
                continue
        n = greedy.shape[0]
        if self.epsilons.shape[0] != n:
            raise ValueError(
                f"ε slice of {self.epsilons.shape[0]} actors vs obs batch "
                f"of {n}"
            )
        explore = self._rng.random(n) < self.epsilons
        randoms = self._rng.integers(0, self.num_actions, size=n)
        actions = np.where(explore, randoms, greedy).astype(np.int32)
        return actions, q, version

    def stats(self, include_hist: bool = False) -> dict:
        out = self.client.stats(include_hist=include_hist)
        out["selects"] = self.selects
        out["outages"] = self.outages
        return out

    def close(self) -> None:
        self.client.close()
