"""The fleet-wide observability plane: the rollup aggregator and the SLO
engine (port of ``ape_x_dqn_tpu/obs/fleet.py``).

A run of the port spreads over many processes: the trainer, replay
shards, serving replicas and remote worker hosts, each with its own
``/varz``.  Ape-X is tuned by signals no single one of them sees (the
age of experience across the fleet, replay throughput, the balance of
actors and learner), and the autopilot (``autopilot/``) acts on them.
This module is that sensor:

  * :class:`FleetAggregator` finds every endpoint of a run (a trainer's
    ``/varz``, or its registry's snapshot in process; replay shards from
    the fleet's endpoints file or the membership registry, scraped over
    their ``stats`` RPC; serving replicas and worker hosts by their
    ``/varz`` URL), scrapes them all concurrently under one deadline per
    sweep, and merges the numbers with the arithmetic of the in-process
    ``merge`` primitives: histograms bucket by bucket
    (``utils.metrics.merge_bucket_dicts``), counters by sum, gauges by
    max.  The rollup serves its own ``/varz``, ``/metrics`` and
    ``/healthz``: a dead member marks only itself down, and the rollup's
    health is its own scrape loop.
  * :class:`SloEngine` evaluates declarative rules over the rollup
    (age-of-experience p95, inference rtt p99, serving p99 and QPS floor,
    the ring-occupancy band, replay add pressure, endpoint liveness) on
    burn-rate windows, with a hysteresis band between ``burn_threshold``
    and ``clear_threshold`` and a minimum sample count, and emits typed
    ``slo_breach`` / ``slo_clear`` events.
  * Trace timelines: the cross-tier spans each snapshot carries group by
    trace id into end-to-end timelines across processes.

Import-light: stdlib at module scope (tools mount it on any host in
milliseconds); the shard stats client is the one lazy import, and it is
numpy-only.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
import zlib
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Dict, List, Optional, Tuple

from ape_x_dqn_tpu_torch.utils.metrics import (
    bucket_percentile,
    emit_event,
    merge_bucket_dicts,
    merge_counter_maps,
    stamp_record,
)

# Shard counter keys the rollup sums across the fleet (a curated subset:
# summing everything would add port numbers).
_SHARD_SUM_KEYS = (
    "requests", "replies", "errors", "torn_frames", "bad_hellos",
    "stale_rejects", "add_dups", "chaos_dropped", "bytes_in", "bytes_out",
    "logical_bytes_in", "size", "capacity", "total_added", "saves",
)
_MAX_TRACES = 256      # trace ids kept for timeline assembly (LRU)
_ROLLUP_TRACES = 8     # newest multi-process timelines on the rollup


# ---------------------------------------------------------------------------
# SLO engine.
# ---------------------------------------------------------------------------


class SloRule:
    """One declarative bound over the rollup.

    ``kind`` is the direction: ``"upper"`` breaches while value > bound
    (latency/occupancy ceilings), ``"lower"`` while value < bound (QPS /
    liveness floors).  ``value_fn(rollup)`` extracts the measured value
    — None means "not measurable this sweep" and the sample is skipped
    (an absent metric is not a breach; endpoint liveness has its own
    rule)."""

    def __init__(self, name: str, kind: str, bound: float,
                 value_fn: Callable[[dict], Optional[float]]):
        if kind not in ("upper", "lower"):
            raise ValueError(f"unknown slo rule kind: {kind}")
        self.name = name
        self.kind = kind
        self.bound = float(bound)
        self.value_fn = value_fn
        self.state = "ok"              # "ok" | "breach"
        self.breaches = 0
        self.clears = 0
        self.last_value: Optional[float] = None
        self._window: deque = deque()  # (t, breached_bool)

    def violated(self, value: float) -> bool:
        return value > self.bound if self.kind == "upper" \
            else value < self.bound


class SloEngine:
    """Burn-rate evaluation of :class:`SloRule` s with flap damping.

    Each sweep appends one (t, violated) sample per rule; the breaching
    FRACTION of the trailing ``window_s`` is the burn rate.  ok→breach
    fires at ``burn >= burn_threshold``; breach→ok at ``burn <=
    clear_threshold`` — and because clear < burn there is a hysteresis
    band where the state HOLDS, so a metric oscillating around the bound
    cannot flap the alarm at sweep cadence.  ``min_samples`` gates both
    transitions (one bad scrape is not a breach; one good one is not a
    recovery)."""

    def __init__(self, rules: List[SloRule], *, window_s: float = 30.0,
                 burn_threshold: float = 0.5, clear_threshold: float = 0.1,
                 min_samples: int = 3, emit=None):
        if not 0.0 <= clear_threshold <= burn_threshold <= 1.0:
            raise ValueError(
                "slo thresholds must satisfy 0 <= clear <= burn <= 1"
            )
        self.rules = list(rules)
        self.window_s = float(window_s)
        self.burn_threshold = float(burn_threshold)
        self.clear_threshold = float(clear_threshold)
        self.min_samples = int(min_samples)
        self._emit = emit              # callable(event_name, **fields)
        self._subscribers: List[Callable] = []
        self.breaches = 0
        self.clears = 0

    def subscribe(self, fn: Callable[..., None]) -> None:
        """Register an event listener called as ``fn(name, **fields)`` on
        every ``slo_breach``/``slo_clear`` in addition to the emit sink —
        the actuation hook the autopilot controller consumes (a listener
        that raises is isolated; evaluation never stops)."""
        self._subscribers.append(fn)

    def _event(self, name: str, **fields) -> None:
        for fn in ((self._emit,) if self._emit is not None else ()) \
                + tuple(self._subscribers):
            try:
                fn(name, **fields)
            except Exception:  # noqa: BLE001 — telemetry must not stop evaluation
                pass

    def evaluate(self, rollup: dict, now: Optional[float] = None) -> dict:
        """One sweep over every rule; returns the ``slo`` status section
        and emits ``slo_breach`` / ``slo_clear`` on state transitions."""
        now = time.monotonic() if now is None else float(now)
        for rule in self.rules:
            try:
                value = rule.value_fn(rollup)
            except Exception:  # noqa: BLE001 — a broken extractor is "unmeasurable", not a crash
                value = None
            if value is None:
                rule.last_value = None
                continue
            value = float(value)
            rule.last_value = value
            rule._window.append((now, rule.violated(value)))
            cutoff = now - self.window_s
            while rule._window and rule._window[0][0] < cutoff:
                rule._window.popleft()
            n = len(rule._window)
            if n < self.min_samples:
                continue
            burn = sum(1 for _, v in rule._window if v) / n
            if rule.state == "ok" and burn >= self.burn_threshold:
                rule.state = "breach"
                rule.breaches += 1
                self.breaches += 1
                self._event(
                    "slo_breach", rule=rule.name, kind=rule.kind,
                    value=round(value, 4), bound=rule.bound,
                    burn=round(burn, 3), window_s=self.window_s,
                    samples=n,
                )
            elif rule.state == "breach" and burn <= self.clear_threshold:
                rule.state = "ok"
                rule.clears += 1
                self.clears += 1
                self._event(
                    "slo_clear", rule=rule.name, kind=rule.kind,
                    value=round(value, 4), bound=rule.bound,
                    burn=round(burn, 3), window_s=self.window_s,
                    samples=n,
                )
        return self.status()

    def status(self) -> dict:
        """The ``slo`` rollup section (the JAX package's docs/METRICS.md
        "SLO schema")."""
        rules = {}
        for rule in self.rules:
            w = rule._window
            burn = (sum(1 for _, v in w if v) / len(w)) if w else 0.0
            rules[rule.name] = {
                "state": rule.state,
                "kind": rule.kind,
                "bound": rule.bound,
                "value": (round(rule.last_value, 4)
                          if rule.last_value is not None else None),
                "burn": round(burn, 3),
                "samples": len(w),
                "breaches": rule.breaches,
                "clears": rule.clears,
            }
        return {
            "rules": rules,
            "breaching": sorted(r.name for r in self.rules
                                if r.state == "breach"),
            "breaches": self.breaches,
            "clears": self.clears,
            "window_s": self.window_s,
            "burn_threshold": self.burn_threshold,
            "clear_threshold": self.clear_threshold,
        }


class _BucketWindow:
    """Windowed percentiles over CUMULATIVE bucket dicts.

    The lineage age histogram and the replica latency histograms are
    cumulative for their process's lifetime, so their percentiles barely
    move once a run has history — a capacity action that fixed the
    CURRENT distribution would never show on them.  Feed each sweep's
    merged cumulative buckets here: per-edge deltas vs the previous feed
    accumulate in a trailing deque, and ``percentile`` re-derives from
    the window's summed deltas — the distribution of the LAST
    ``window_s`` seconds only.  Negative deltas (an endpoint respawned
    and its counters reset, or dropped out of the merge) clamp to zero:
    a reset loses at most one endpoint's window contribution, never
    corrupts the sum."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = float(window_s)
        self._prev: dict = {}
        self._deltas: deque = deque()   # (t, {edge: count_delta})

    def feed(self, buckets: dict, now: float) -> None:
        delta = {
            k: max(0, int(v) - int(self._prev.get(k, 0)))
            for k, v in (buckets or {}).items()
        }
        self._prev = dict(buckets or {})
        if any(delta.values()):
            self._deltas.append((now, delta))
        cutoff = now - self.window_s
        while self._deltas and self._deltas[0][0] < cutoff:
            self._deltas.popleft()

    def merged(self) -> dict:
        out: dict = {}
        for _, d in self._deltas:
            out = merge_bucket_dicts(out, d)
        return out

    def count(self) -> int:
        return sum(sum(d.values()) for _, d in self._deltas)

    def percentile(self, q: float) -> Optional[float]:
        m = self.merged()
        if not any(m.values()):
            return None
        return bucket_percentile(m, q)


# -- rollup metric extractors (the rule vocabulary) -------------------------


def _age_p95_ms(rollup: dict) -> Optional[float]:
    age = rollup.get("age_of_experience") or {}
    win = age.get("window") or {}
    if win.get("count"):
        # Windowed value when the aggregator computes one: the SLO must
        # see the CURRENT distribution, not the run's whole history.
        return win.get("p95_s", 0.0) * 1e3
    if not age.get("count"):
        return None
    return age.get("p95_s", 0.0) * 1e3


def _inference_rtt_p99_ms(rollup: dict) -> Optional[float]:
    inf = rollup.get("inference") or {}
    return inf.get("rtt_p99_ms_max")


def _serving_p99_ms(rollup: dict) -> Optional[float]:
    srv = rollup.get("serving") or {}
    win = srv.get("window") or {}
    if win.get("count"):
        return win.get("p99_ms")
    if not srv.get("count"):
        return None
    return srv.get("p99_ms")


def _serving_qps(rollup: dict) -> Optional[float]:
    srv = rollup.get("serving") or {}
    if not srv.get("replicas"):
        return None
    return srv.get("qps", 0.0)


def _ring_occupancy(rollup: dict) -> Optional[float]:
    return rollup.get("ring_occupancy_max")


def _replay_add_qps_per_shard(rollup: dict) -> Optional[float]:
    """Fleet replay ingest pressure NORMALIZED per live shard — the
    signal that stays comparable across reshards: growing the fleet
    lowers it, shrinking raises it, so one bound governs both ends."""
    rep = rollup.get("replay") or {}
    shards = int(rep.get("shards_alive") or 0)
    if shards <= 0:
        return None
    return float(rep.get("add_qps") or 0.0) / shards


def _endpoints_down(rollup: dict) -> Optional[float]:
    eps = rollup.get("endpoints") or {}
    if not eps:
        return None
    return float(sum(1 for e in eps.values() if not e.get("alive")))


def rules_from_config(obs_cfg) -> List[SloRule]:
    """The config-declared rule set (``obs.fleet_slo_*``): a bound of 0
    (or an occupancy band of (0, 1]) leaves that rule off, so the default
    config evaluates only endpoint liveness."""
    rules: List[SloRule] = []
    if obs_cfg.fleet_slo_age_p95_ms > 0:
        rules.append(SloRule("age_p95_ms", "upper",
                             obs_cfg.fleet_slo_age_p95_ms, _age_p95_ms))
    if obs_cfg.fleet_slo_inference_rtt_p99_ms > 0:
        rules.append(SloRule(
            "inference_rtt_p99_ms", "upper",
            obs_cfg.fleet_slo_inference_rtt_p99_ms, _inference_rtt_p99_ms))
    if obs_cfg.fleet_slo_serving_p99_ms > 0:
        rules.append(SloRule("serving_p99_ms", "upper",
                             obs_cfg.fleet_slo_serving_p99_ms,
                             _serving_p99_ms))
    if obs_cfg.fleet_slo_serving_qps_min > 0:
        rules.append(SloRule("serving_qps", "lower",
                             obs_cfg.fleet_slo_serving_qps_min,
                             _serving_qps))
    if obs_cfg.fleet_slo_ring_occupancy_high < 1.0:
        rules.append(SloRule("ring_occupancy", "upper",
                             obs_cfg.fleet_slo_ring_occupancy_high,
                             _ring_occupancy))
    if obs_cfg.fleet_slo_ring_occupancy_low > 0.0:
        rules.append(SloRule("ring_occupancy_floor", "lower",
                             obs_cfg.fleet_slo_ring_occupancy_low,
                             _ring_occupancy))
    if obs_cfg.fleet_slo_replay_add_qps_high > 0:
        rules.append(SloRule("replay_add_qps", "upper",
                             obs_cfg.fleet_slo_replay_add_qps_high,
                             _replay_add_qps_per_shard))
    if obs_cfg.fleet_slo_endpoint_alive:
        rules.append(SloRule("endpoints_alive", "upper", 0.0,
                             _endpoints_down))
    return rules


def engine_from_config(obs_cfg, emit=None) -> SloEngine:
    return SloEngine(
        rules_from_config(obs_cfg),
        window_s=obs_cfg.fleet_slo_window_s,
        burn_threshold=obs_cfg.fleet_slo_burn_threshold,
        clear_threshold=obs_cfg.fleet_slo_clear_threshold,
        min_samples=obs_cfg.fleet_slo_min_samples,
        emit=emit,
    )


# ---------------------------------------------------------------------------
# Endpoints + the aggregator.
# ---------------------------------------------------------------------------


class _Endpoint:
    __slots__ = ("name", "kind", "url", "shard_spec", "snapshot_fn",
                 "alive", "scrape_failures", "consecutive_failures",
                 "last_ok_t", "last_error", "snapshot", "prev_qps_mark")

    def __init__(self, name: str, kind: str, url: Optional[str] = None,
                 shard_spec: Optional[dict] = None, snapshot_fn=None):
        self.name = name
        self.kind = kind               # trainer | replica | shard | host
        self.url = url                 # /varz base for HTTP endpoints
        self.shard_spec = shard_spec   # {host, port, token, id, incarnation}
        self.snapshot_fn = snapshot_fn  # in-process /varz twin (add_local)
        self.alive = False
        self.scrape_failures = 0
        self.consecutive_failures = 0
        self.last_ok_t = 0.0
        self.last_error: Optional[str] = None
        self.snapshot: Optional[dict] = None
        self.prev_qps_mark: Optional[Tuple[float, float]] = None

    def summary(self, now: float) -> dict:
        return {
            "kind": self.kind,
            "alive": self.alive,
            "scrape_failures": self.scrape_failures,
            "consecutive_failures": self.consecutive_failures,
            "last_ok_age_s": (round(now - self.last_ok_t, 3)
                              if self.last_ok_t else None),
            "last_error": self.last_error,
            "addr": self.url or (
                f"{self.shard_spec['host']}:{self.shard_spec['port']}"
                if self.shard_spec
                else ("local" if self.snapshot_fn is not None else None)
            ),
        }


def _endpoint_detail(ep: "_Endpoint") -> dict:
    """The per-row numbers obs_top --fleet renders (a curated slice of
    the endpoint's last snapshot, by kind)."""
    snap = ep.snapshot or {}
    if ep.kind == "shard":
        op = snap.get("op_ms") or {}
        return {"size": snap.get("size"), "requests": snap.get("requests"),
                "p95_ms": op.get("p95_ms"),
                "torn_frames": snap.get("torn_frames"),
                "incarnation": snap.get("incarnation")}
    if ep.kind == "replica":
        snet = snap.get("serving_net") \
            or (snap.get("serving") or {}).get("net") or {}
        lat = snet.get("latency") or {}
        return {"requests": snet.get("requests"),
                "p95_ms": lat.get("p95_ms"),
                "shed": snet.get("shed"),
                "param_version": snet.get("param_version")}
    ln = snap.get("learner") or {}
    age = (snap.get("lineage") or {}).get("age_at_sample") or {}
    return {"step": ln.get("step"),
            "steps_per_sec": ln.get("steps_per_sec"),
            "workers": len(snap.get("workers") or {}),
            "age_p95_ms": age.get("p95_ms")}


class FleetAggregator:
    """Scrape → merge → serve.  See the module docstring.

    Construction is passive; ``start()`` begins the scrape thread (or
    call ``scrape_once()`` yourself — tests and the smoke drive sweeps
    deterministically).  ``serve(port)`` mounts the rollup exporter."""

    def __init__(self, *, scrape_interval_s: float = 1.0,
                 scrape_timeout_s: float = 2.0,
                 slo: Optional[SloEngine] = None,
                 window_s: float = 30.0,
                 scrape_workers: int = 8,
                 emit=None, jsonl_stream=None):
        self._interval = float(scrape_interval_s)
        self._timeout = float(scrape_timeout_s)
        self._window_s = float(window_s)
        # Concurrent scrape plane: endpoints are fetched on a bounded
        # pool under one TOTAL-cycle deadline, so a dead member costs the
        # sweep one timeout, not N of them — the serial loop stretched
        # cadence by N×timeout and skewed every windowed SLO burn rate.
        self._workers = max(1, int(scrape_workers))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: Dict[str, object] = {}   # name -> still-running Future
        self.timeline = None                      # attach_timeline()
        # Windowed twins of the cumulative merged histograms (the values
        # the SLO extractors prefer — see _BucketWindow).
        self._age_window = _BucketWindow(window_s=window_s)
        self._serving_window = _BucketWindow(window_s=window_s)
        self._emit = emit if emit is not None else (
            lambda name, **f: emit_event(name, stream=jsonl_stream, **f)
        )
        self._jsonl = jsonl_stream
        self.slo = slo if slo is not None else SloEngine([], emit=self._emit)
        if slo is not None and slo._emit is None:
            slo._emit = self._emit
        self._lock = threading.Lock()
        self._eps: "OrderedDict[str, _Endpoint]" = OrderedDict()
        self._replay_files: List[dict] = []   # {path, digest}
        self._registry_fn: Optional[Callable[[], dict]] = None
        self._member_adopted: set = set()
        self._membership: dict = {}
        self.membership_adopts = 0
        self._traces: "OrderedDict[int, dict]" = OrderedDict()
        self._rollup: dict = {"endpoints": {}}
        self.scrapes = 0
        self.scrape_failures = 0
        self.sweeps = 0
        self.last_sweep_t = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self.registry = None
        self.health = None

    # -- discovery ---------------------------------------------------------

    def add_varz(self, name: str, url: str, kind: str = "trainer") -> None:
        """Register one HTTP /varz endpoint (trainer, serving replica, a
        remote host's exporter).  Re-registering a name replaces its URL
        (a respawned replica announces a fresh port) and keeps its
        failure history."""
        base = url.rstrip("/")
        if not base.endswith("/varz"):
            base += "/varz"
        with self._lock:
            ep = self._eps.get(name)
            if ep is None or ep.kind != kind:
                self._eps[name] = _Endpoint(name, kind, url=base)
            else:
                ep.url = base

    def add_local(self, name: str, snapshot_fn, kind: str = "trainer") -> None:
        """Register an IN-PROCESS endpoint: ``snapshot_fn()`` returns the
        same sectioned dict its /varz would serve (e.g. a registry's
        ``snapshot``).  How a trainer-hosted aggregator (the autopilot's
        sensor) reads its own process without an HTTP round trip — the
        merge arithmetic and liveness accounting are identical."""
        with self._lock:
            self._eps[name] = _Endpoint(name, kind, snapshot_fn=snapshot_fn)

    def remove_endpoint(self, name: str) -> None:
        """Forget one endpoint (a replica retired by the autopilot leaves
        the fleet ON PURPOSE — keeping it registered would read as a
        liveness breach)."""
        with self._lock:
            self._eps.pop(name, None)

    def watch_replay_endpoints(self, path: str) -> None:
        """Discover replay shards from the fleet's endpoints file (the
        atomic tmp+rename publication clients already re-resolve); the
        file's CONTENT digest gates the re-read each sweep — mtime has
        filesystem-granularity resolution, so a rewrite within the same
        tick (respawn storms do this) would be invisible to an
        mtime-equality early-out."""
        self._replay_files.append({"path": path, "digest": None})
        self._refresh_replay_files()

    def _refresh_replay_files(self) -> None:
        for src in self._replay_files:
            try:
                with open(src["path"], "rb") as f:
                    raw = f.read()
                digest = zlib.crc32(raw)
                if digest == src["digest"]:
                    continue
                doc = json.loads(raw.decode("utf-8"))
                src["digest"] = digest
            except (OSError, ValueError):
                continue
            token = int(doc.get("token", 0))
            for s in doc.get("shards", []):
                name = f"replay_shard{int(s['id'])}"
                spec = {
                    "id": int(s["id"]), "host": s["host"],
                    "port": int(s["port"]), "token": token,
                    "incarnation": int(s.get("incarnation", -1)),
                }
                with self._lock:
                    ep = self._eps.get(name)
                    if ep is None:
                        self._eps[name] = _Endpoint(name, "shard",
                                                    shard_spec=spec)
                    else:
                        ep.shard_spec = spec

    # -- membership adoption (fleet discovery plane) -----------------------

    def bind_registry(self, registry) -> None:
        """Adopt fleet membership from an in-process
        :class:`~ape_x_dqn_tpu_torch.fleet.registry.FleetRegistry`: every sweep
        re-reads ``registry.snapshot()`` and reconciles the endpoint set
        against it — replay shards become stats-RPC scrape specs keyed by
        their announced slot base, serving replicas and worker hosts join
        by their announced ``varz_url``.  Under ``fleet.discovery =
        "registry"`` this REPLACES the endpoints-file watch and the
        caller-handed replica ports: the membership registry is the one
        source of scrape-target truth."""
        self._registry_fn = registry.snapshot
        self.adopt_membership(registry.snapshot())

    def adopt_membership(self, snapshot: dict) -> None:
        """Reconcile the endpoint set against one membership snapshot
        (also the ``on_membership`` hook shape a FleetAnnouncer pushes).
        Members that left (reshard, retire, TTL expiry) drop their
        endpoints ON PURPOSE — a departed member must not read as a
        liveness breach."""
        snapshot = snapshot or {}
        members = snapshot.get("members") or {}
        token = int(snapshot.get("token", 0))
        version = int(snapshot.get("version", 0))
        adopted: set = set()
        draining: List[str] = []
        by_kind: Dict[str, int] = {}
        for name, doc in members.items():
            kind = str(doc.get("kind", ""))
            by_kind[kind] = by_kind.get(kind, 0) + 1
            if doc.get("draining"):
                draining.append(name)
            if kind == "replay_shard":
                cap = int(doc.get("capacity", 0))
                port = int(doc.get("port", 0))
                if cap <= 0 or port <= 0:
                    continue
                sid = int(doc.get("base", 0)) // cap
                ep_name = f"replay_shard{sid}"
                spec = {
                    "id": sid, "host": doc.get("host") or "127.0.0.1",
                    "port": port, "token": token,
                    "incarnation": int(doc.get("incarnation", -1)),
                }
                with self._lock:
                    ep = self._eps.get(ep_name)
                    if ep is None:
                        self._eps[ep_name] = _Endpoint(ep_name, "shard",
                                                       shard_spec=spec)
                    else:
                        ep.shard_spec = spec
                adopted.add(ep_name)
            elif doc.get("varz_url"):
                ep_kind = {"serving_replica": "replica",
                           "worker_host": "host"}.get(kind, "trainer")
                self.add_varz(name, str(doc["varz_url"]), kind=ep_kind)
                adopted.add(name)
        for stale in self._member_adopted - adopted:
            self.remove_endpoint(stale)
        self._member_adopted = adopted
        if version != self._membership.get("version"):
            self.membership_adopts += 1
        self._membership = {
            "version": version,
            "incarnation": int(snapshot.get("incarnation", 0)),
            "members": len(members),
            "by_kind": by_kind,
            "draining": sorted(draining),
            "adopted_endpoints": len(adopted),
            "adopts": self.membership_adopts,
        }

    # -- scraping ----------------------------------------------------------

    def _scrape_http(self, ep: _Endpoint) -> dict:
        with urllib.request.urlopen(ep.url, timeout=self._timeout) as r:
            return json.load(r)

    def _scrape_shard(self, ep: _Endpoint) -> dict:
        # Lazy, numpy-only import: the stats RPC rides the replay plane's
        # own client (its hello, ack and deadline discipline).
        from ape_x_dqn_tpu_torch.replay.service import ShardClient

        spec = ep.shard_spec
        client = ShardClient(
            spec["id"], spec["host"], spec["port"], token=spec["token"],
            client_id=(os.getpid() << 16) ^ 0xF1EE7, codec="off",
            connect_timeout_s=self._timeout, io_timeout_s=self._timeout,
        )
        try:
            return client.shard_stats(timeout=self._timeout)
        finally:
            client.close()

    def _fetch(self, ep: _Endpoint) -> dict:
        if ep.snapshot_fn is not None:
            return dict(ep.snapshot_fn())
        if ep.kind == "shard":
            return self._scrape_shard(ep)
        return self._scrape_http(ep)

    def _scrape_all(self, eps: List[_Endpoint]) -> List[tuple]:
        """Fetch every endpoint concurrently (bounded pool) under one
        total-cycle deadline.  Returns ``(ep, snapshot_or_None,
        error_or_None)`` in endpoint order.  An endpoint whose PREVIOUS
        fetch is still wedged (a hang the socket timeout can't see —
        e.g. a snapshot_fn stuck on a lock) is skipped and counted as a
        failure instead of stacking another worker behind it; the
        straggler's eventual result is discarded."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers, thread_name_prefix="fleet-scrape"
            )
        # One endpoint timeout of budget for everyone at once, plus
        # pool-queueing slack when the fleet outnumbers the workers.
        waves = (len(eps) + self._workers - 1) // max(1, self._workers)
        deadline = time.monotonic() + self._timeout * max(1, waves) + 0.25
        futs: Dict[str, object] = {}
        results: List[tuple] = []
        for ep in eps:
            old = self._inflight.get(ep.name)
            if old is not None and not old.done():
                results.append((ep, None,
                                "ScrapeStuck: previous scrape still in flight"))
                continue
            self._inflight.pop(ep.name, None)
            futs[ep.name] = self._pool.submit(self._fetch, ep)
        for ep in eps:
            fut = futs.get(ep.name)
            if fut is None:
                continue
            try:
                snap = fut.result(
                    timeout=max(0.0, deadline - time.monotonic())
                )
                results.append((ep, snap, None))
            except _FutureTimeout:
                self._inflight[ep.name] = fut
                results.append((ep, None,
                                "ScrapeDeadline: cycle deadline exceeded"))
            except Exception as e:  # noqa: BLE001 — ANY scrape fault = endpoint down, never a sweep crash
                results.append((ep, None, f"{type(e).__name__}: {e}"))
        order = {ep.name: i for i, ep in enumerate(eps)}
        results.sort(key=lambda r: order.get(r[0].name, len(order)))
        return results

    def scrape_once(self, now: Optional[float] = None) -> dict:
        """One full sweep: scrape every endpoint (concurrently, one
        total-cycle deadline), rebuild the rollup, evaluate the SLO
        rules, append the sweep to the timeline when one is attached.
        Returns the rollup (also kept for the /varz provider).  A
        failing endpoint is marked down and the sweep continues — the
        fleet view never dies of a member's death."""
        if self._registry_fn is not None:
            try:
                self.adopt_membership(self._registry_fn())
            except Exception:  # noqa: BLE001 — membership adoption must never kill the sweep
                pass
        self._refresh_replay_files()
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            eps = list(self._eps.values())
        for ep, snap, err in self._scrape_all(eps):
            self.scrapes += 1
            if err is not None:
                self.scrape_failures += 1
                ep.scrape_failures += 1
                ep.consecutive_failures += 1
                ep.alive = False
                ep.last_error = err
                continue
            ep.alive = True
            ep.consecutive_failures = 0
            ep.last_ok_t = now
            ep.last_error = None
            ep.snapshot = snap
        rollup = self._merge(eps, now)
        with self._lock:
            self._rollup = rollup
        slo_status = self.slo.evaluate(rollup, now=now)
        if self.timeline is not None:
            try:
                self.timeline.append_sweep(rollup, slo_status, now=now)
                self._lift_timeline_windows(rollup, now)
            except Exception:  # noqa: BLE001 — the recorder must never kill the sweep
                pass
        self.sweeps += 1
        self.last_sweep_t = time.monotonic()
        if self._jsonl is not None:
            try:
                compact = {k: rollup.get(k) for k in (
                    "alive", "expected", "age_of_experience", "inference",
                    "serving", "replay", "membership",
                    "ring_occupancy_max", "scrape_failures",
                )}
                rec = stamp_record({"fleet": compact,
                                    "slo": self.slo.status()})
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()
            except (OSError, ValueError):
                pass
        return rollup

    # -- timeline (flight-data recorder) -----------------------------------

    def attach_timeline(self, store, rebuild: bool = True) -> None:
        """Attach a :class:`~ape_x_dqn_tpu_torch.obs.timeline.TimelineStore`
        (duck-typed — fleet.py stays import-light): every sweep appends
        one compacted delta record, and — the respawn story — the SLO
        engine's burn/clear windows and rule states are REBUILT from the
        timeline tail right now, so a restarted aggregator resumes the
        previous incarnation's alarm state instead of opening a blind
        window that false-clears a live breach."""
        self.timeline = store
        if rebuild:
            try:
                store.rebuild_slo(self.slo)
            except Exception:  # noqa: BLE001 — a corrupt tail degrades to a cold start, never a crash
                pass

    def _lift_timeline_windows(self, rollup: dict, now: float) -> None:
        """Windowed rates from the recorder onto the rollup: the
        scrape-to-scrape ``qps`` / ``add_qps`` are instantaneous (one
        quiet sweep reads as idleness); these are the smoothed trailing-
        window twins the autopilot's idle rules prefer."""
        win = self._window_s
        qps = self.timeline.rate("serving_replies", win, now=now)
        if qps is not None:
            (rollup.get("serving") or {}).setdefault("window", {})[
                "qps"] = round(qps, 2)
        add = self.timeline.rate("replay_added", win, now=now)
        rep = rollup.get("replay")
        if add is not None and isinstance(rep, dict):
            rep["window"] = {"add_qps": round(add, 2), "window_s": win}

    # -- merge arithmetic --------------------------------------------------

    def _collect_spans(self, snap: dict) -> List[dict]:
        out: List[dict] = []
        for holder in (
            snap.get("trace_spans"),                       # trainer + shard
            (snap.get("serving_net") or {}).get("recent_spans"),
            ((snap.get("serving") or {}).get("net") or {}).get(
                "recent_spans"),
        ):
            if isinstance(holder, dict):
                out.extend(holder.get("spans") or [])
            elif isinstance(holder, list):
                out.extend(holder)
        return [s for s in out if isinstance(s, dict) and s.get("trace_id")]

    def _fold_traces(self, spans: List[dict]) -> None:
        for span in spans:
            tid = int(span["trace_id"])
            rec = self._traces.get(tid)
            if rec is None:
                rec = self._traces[tid] = {"trace_id": tid, "spans": {},
                                           "t_new": 0.0}
                while len(self._traces) > _MAX_TRACES:
                    self._traces.popitem(last=False)
            key = (span.get("pid"), span.get("hop"), span.get("t0_s"))
            rec["spans"][key] = span
            rec["t_new"] = max(rec["t_new"], float(span.get("t1_s") or 0.0))

    def _timelines(self) -> List[dict]:
        """The newest assembled multi-process timelines: spans sorted by
        start time, the distinct-pid set, and whether an RPC hop's two
        halves are both present (a client-side and a server-side span of
        the same trace from different pids)."""
        out = []
        for rec in self._traces.values():
            spans = sorted(rec["spans"].values(),
                           key=lambda s: s.get("t0_s") or 0.0)
            pids = sorted({s.get("pid") for s in spans
                           if s.get("pid") is not None})
            if len(pids) < 2:
                continue
            out.append({
                "trace_id": rec["trace_id"],
                "pids": pids,
                "hops": [s.get("hop") for s in spans],
                "spans": spans,
                "t_new": rec["t_new"],
            })
        out.sort(key=lambda t: t["t_new"], reverse=True)
        for t in out:
            t.pop("t_new", None)
        return out[:_ROLLUP_TRACES]

    def _merge(self, eps: List[_Endpoint], now: float) -> dict:
        age_buckets: dict = {}
        age_count = 0
        serving_buckets: dict = {}
        serving_count = 0
        serving_qps = 0.0
        serving_replicas = 0
        shard_ms_buckets: dict = {}
        shard_counters: dict = {}
        shards_alive = 0
        replay_add_qps = 0.0
        # Per-param_version serving telemetry (a canary's sensor) and the
        # newest bucket exemplars, merged across replicas.
        version_counts: Dict[str, int] = {}
        version_buckets: Dict[str, dict] = {}
        serving_exemplars: dict = {}
        op_exemplars: dict = {}
        rtt_exemplars: dict = {}
        inference_p99: List[float] = []
        inference_stall = 0.0
        inference_replies = 0
        ring_occ: List[float] = []
        spans: List[dict] = []
        autopilot: Optional[dict] = None
        for ep in eps:
            snap = ep.snapshot
            if snap is None:
                continue
            spans.extend(self._collect_spans(snap))
            if ep.kind == "shard":
                if ep.alive:
                    shards_alive += 1
                    op = snap.get("op_ms") or {}
                    shard_ms_buckets = merge_bucket_dicts(
                        shard_ms_buckets, op.get("buckets") or {}
                    )
                    if isinstance(op.get("exemplars"), dict):
                        op_exemplars.update(op["exemplars"])
                    shard_counters = merge_counter_maps(
                        shard_counters,
                        {k: snap[k] for k in _SHARD_SUM_KEYS if k in snap},
                    )
                    # Per-shard ingest rate from prev-mark deltas of the
                    # monotone total_added counter (the serving qps
                    # pattern) — THE autopilot grow signal: occupancy
                    # saturates once a ring wraps, add rate does not.
                    added = float(snap.get("total_added", 0))
                    mark = ep.prev_qps_mark
                    if mark is not None and now > mark[0]:
                        replay_add_qps += max(0.0, added - mark[1]) \
                            / (now - mark[0])
                    ep.prev_qps_mark = (now, added)
                continue
            # HTTP/local endpoints: lineage / inference / serving /
            # workers / autopilot.
            if isinstance(snap.get("autopilot"), dict):
                # The controller's own state rides its trainer's /varz;
                # lift the newest live one onto the rollup so obs_top
                # --fleet renders it next to the SLO states.
                autopilot = snap["autopilot"]
            lineage = snap.get("lineage") or {}
            age = lineage.get("age_at_sample") or {}
            if age.get("count"):
                age_buckets = merge_bucket_dicts(
                    age_buckets, age.get("buckets_s") or {}
                )
                age_count += int(age.get("count", 0))
            inf = snap.get("inference") or {}
            rtt = inf.get("rtt") or {}
            if rtt.get("count"):
                inference_p99.append(float(rtt.get("p99_ms", 0.0)))
                inference_stall += float(inf.get("stall_ms", 0.0))
                inference_replies += int(inf.get("replies", 0))
            if isinstance(inf.get("rtt_exemplars"), dict):
                rtt_exemplars.update(inf["rtt_exemplars"])
            snet = snap.get("serving_net") \
                or (snap.get("serving") or {}).get("net")
            if isinstance(snet, dict) and ep.kind == "replica":
                if ep.alive:
                    serving_replicas += 1
                serving_buckets = merge_bucket_dicts(
                    serving_buckets, snet.get("latency_buckets") or {}
                )
                lat = snet.get("latency") or {}
                serving_count += int(lat.get("count", 0))
                if isinstance(snet.get("latency_exemplars"), dict):
                    serving_exemplars.update(snet["latency_exemplars"])
                for ver, row in (snet.get("by_version") or {}).items():
                    if not isinstance(row, dict):
                        continue
                    ver = str(ver)
                    version_counts[ver] = version_counts.get(ver, 0) \
                        + int(row.get("replies", 0))
                    version_buckets[ver] = merge_bucket_dicts(
                        version_buckets.get(ver, {}),
                        row.get("latency_buckets") or {},
                    )
                replies = float(snet.get("replies", 0))
                mark = ep.prev_qps_mark
                if mark is not None and now > mark[0]:
                    serving_qps += max(0.0, replies - mark[1]) \
                        / (now - mark[0])
                ep.prev_qps_mark = (now, replies)
            xp = snap.get("xp_transport") or {}
            ring_bytes = float(xp.get("ring_bytes") or 0)
            if ring_bytes > 0:
                for w in (snap.get("workers") or {}).values():
                    if isinstance(w, dict):
                        ring_occ.append(
                            float(w.get("ring_backlog_bytes", 0))
                            / ring_bytes
                        )
        self._fold_traces(spans)
        self._age_window.feed(age_buckets, now)
        self._serving_window.feed(serving_buckets, now)
        age_win_n = self._age_window.count()
        srv_win_n = self._serving_window.count()
        rollup: dict = {
            "endpoints": {
                ep.name: {**ep.summary(now), "detail": _endpoint_detail(ep)}
                for ep in eps
            },
            "expected": len(eps),
            "alive": sum(1 for ep in eps if ep.alive),
            "scrapes": self.scrapes,
            "scrape_failures": self.scrape_failures,
            "sweeps": self.sweeps,
            "age_of_experience": {
                "count": age_count,
                "p50_s": round(bucket_percentile(age_buckets, 50), 4)
                if age_count else None,
                "p95_s": round(bucket_percentile(age_buckets, 95), 4)
                if age_count else None,
                "p99_s": round(bucket_percentile(age_buckets, 99), 4)
                if age_count else None,
                "buckets_s": age_buckets,
                # Trailing-window distribution (see _BucketWindow): the
                # value the age SLO rule actually evaluates.
                "window": {
                    "count": age_win_n,
                    "p50_s": round(self._age_window.percentile(50), 4)
                    if age_win_n else None,
                    "p95_s": round(self._age_window.percentile(95), 4)
                    if age_win_n else None,
                },
            },
            "inference": {
                "rtt_p99_ms_max": (round(max(inference_p99), 3)
                                   if inference_p99 else None),
                "stall_ms": round(inference_stall, 1),
                "replies": inference_replies,
                "trainers_reporting": len(inference_p99),
                "rtt_exemplars": rtt_exemplars,
            },
            "serving": {
                "replicas": serving_replicas,
                "count": serving_count,
                "p50_ms": round(
                    bucket_percentile(serving_buckets, 50) * 1e3, 3)
                if serving_count else None,
                "p95_ms": round(
                    bucket_percentile(serving_buckets, 95) * 1e3, 3)
                if serving_count else None,
                "p99_ms": round(
                    bucket_percentile(serving_buckets, 99) * 1e3, 3)
                if serving_count else None,
                "qps": round(serving_qps, 2),
                "latency_buckets": serving_buckets,
                # Canary sensor: the same latency split by the
                # param_version each reply carried, fleet-merged.
                "by_version": {
                    ver: {
                        "replies": version_counts.get(ver, 0),
                        "p50_ms": round(
                            bucket_percentile(bkts, 50) * 1e3, 3)
                        if any(bkts.values()) else None,
                        "p99_ms": round(
                            bucket_percentile(bkts, 99) * 1e3, 3)
                        if any(bkts.values()) else None,
                    }
                    for ver, bkts in sorted(version_buckets.items())
                },
                "exemplars": serving_exemplars,
                "window": {
                    "count": srv_win_n,
                    "p50_ms": round(
                        self._serving_window.percentile(50) * 1e3, 3)
                    if srv_win_n else None,
                    "p99_ms": round(
                        self._serving_window.percentile(99) * 1e3, 3)
                    if srv_win_n else None,
                },
            },
            "replay": {
                "shards_alive": shards_alive,
                "add_qps": round(replay_add_qps, 2),
                "occupancy": (
                    round(float(shard_counters.get("size", 0))
                          / float(shard_counters["capacity"]), 4)
                    if shard_counters.get("capacity") else None),
                "op_p95_ms": round(
                    bucket_percentile(shard_ms_buckets, 95) * 1e3, 3)
                if shard_ms_buckets else None,
                "op_buckets": shard_ms_buckets,
                "op_exemplars": op_exemplars,
                **shard_counters,
            },
            "membership": dict(self._membership) if self._membership
            else None,
            "ring_occupancy_max": (round(max(ring_occ), 4)
                                   if ring_occ else None),
            "autopilot": autopilot,
            "traces": self._timelines(),
        }
        return rollup

    # -- serving the rollup ------------------------------------------------

    def rollup(self) -> dict:
        """The ``fleet`` /varz section: the newest completed sweep."""
        with self._lock:
            return self._rollup

    def slo_status(self) -> dict:
        return self.slo.status()

    def serve(self, port: int = 0, host: str = "127.0.0.1"):
        """Mount the rollup exporter: ``/varz`` carries the ``fleet`` +
        ``slo`` sections, ``/metrics`` flattens them, ``/healthz``
        reflects ONLY the aggregator's own scrape loop — dead fleet
        endpoints ride the body, they never 503 the rollup."""
        from ape_x_dqn_tpu_torch.obs.exporter import ObsServer
        from ape_x_dqn_tpu_torch.obs.registry import Health, MetricsRegistry

        self.registry = MetricsRegistry()
        self.registry.gauge(
            "fleet/scrapes", help="endpoint scrapes attempted",
        ).set_fn(lambda: self.scrapes)
        self.registry.gauge(
            "fleet/scrape_failures", help="endpoint scrapes that failed",
        ).set_fn(lambda: self.scrape_failures)
        self.registry.gauge(
            "fleet/slo_breaches", help="slo ok->breach transitions",
        ).set_fn(lambda: self.slo.breaches)
        self.registry.gauge(
            "fleet/slo_clears", help="slo breach->ok transitions",
        ).set_fn(lambda: self.slo.clears)
        self.registry.register_provider("fleet", self.rollup)
        self.registry.register_provider("slo", self.slo_status)
        if self.timeline is not None:
            self.registry.register_provider("timeline", self.timeline.stats)
        self.health = Health(stale_after_s=max(10.0, 5 * self._interval))
        self.health.register(
            "scrape_loop", lambda: time.monotonic() - self.last_sweep_t
        )
        self._server = ObsServer(self.registry, self.health,
                                 port=port, host=host)
        return self._server

    @property
    def port(self) -> Optional[int]:
        return self._server.port if self._server is not None else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetAggregator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-aggregator", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the sweep must survive anything a member sends
                self.scrape_failures += 1

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self.timeline is not None:
            # Clean shutdown commits the active segment; a SIGKILL skips
            # this and the next incarnation adopts the tail instead.
            try:
                self.timeline.close()
            except Exception:  # noqa: BLE001 — shutdown is best-effort, the tail is adoptable
                pass
