"""The autopilot's decision core: guardrails and the multi-fleet controller
(port of ``ape_x_dqn_tpu/autopilot/controller.py``).

Control law, per fleet, per tick:

  * **scale up** when any of the fleet's governing SLO rules is in
    breach (the damped ``slo_breach``/``slo_clear`` stream — the SLO
    engine's burn windows already filtered blips out);
  * **scale down** only while every governing rule is green AND the
    fleet's idle rule — evaluated on the controller's OWN burn-window
    engine, so scale-down inherits the same damping — says the capacity
    is sitting unused (serving: per-replica QPS under
    ``autopilot.serving_idle_qps_per_replica``; replay: per-shard add
    QPS under ``autopilot.replay_idle_add_qps_per_shard`` — add RATE,
    not occupancy, because a full ring stays full after a grow and an
    occupancy pair would oscillate);
  * the actor loop's ring-occupancy-high response is a LADDER: tune the
    pool's drain budget up (×2 per action, bounded by
    ``autopilot.drain_tune_max_factor``) before any worker is retired —
    drain harder first, shrink the fleet last;
  * when scale-up is wanted but the fleet is at its ceiling, the actor
    loop degrades the dispatch pipeline to strict depth 1 instead
    (fresher priority write-backs — the same lever the watchdog pulls).

Every decision passes :class:`Guardrails` — min/max bounds,
per-direction cooldowns, a hold window against the opposite direction,
one step at a time — and emits a typed ``autopilot_action`` event.
``dry_run`` evaluates and emits without actuating (cooldowns still
arm, so a dry run previews the REAL decision cadence).

Deterministic where it matters: every entry point takes an explicit
``now`` so tests drive time, and event ingestion is an explicit queue
drained by ``step`` — no hidden clocks, no hidden threads in tests.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ape_x_dqn_tpu_torch.obs.fleet import SloEngine, SloRule

# Which fleet each SLO rule governs and the direction its breach pushes
# (the rule vocabulary of obs/fleet.rules_from_config).  endpoint
# liveness is deliberately absent: dead processes are the SUPERVISOR's
# domain (respawn/quarantine); the autopilot only moves capacity.
DEFAULT_RULE_FLEETS: Dict[str, tuple] = {
    "age_p95_ms": ("actor", "up"),
    "ring_occupancy_floor": ("actor", "up"),
    "ring_occupancy": ("actor", "down"),
    "serving_p99_ms": ("serving", "up"),
    "serving_qps": ("serving", "up"),
    "inference_rtt_p99_ms": ("serving", "up"),
    "replay_add_qps": ("replay", "up"),
}

# Idle (scale-down) rules the controller's OWN burn-window engine owns,
# mapped to the fleet they shrink.  Kept separate from the breach-driven
# map: an idle rule only ever gates scale-down while everything else on
# its fleet is green.
IDLE_RULE_FLEETS: Dict[str, str] = {
    "serving_idle": "serving",
    "replay_idle": "replay",
}

_RECENT = 8


class Guardrails:
    """Shared decision gate: bounds, per-direction cooldowns, a hold
    window against the opposite direction.  ``check`` returns None when
    the action may proceed, else the suppression reason (a short closed
    vocabulary the state section surfaces)."""

    def __init__(self, *, min_size: int, max_size: int,
                 cooldown_up_s: float, cooldown_down_s: float,
                 hold_opposite_s: float):
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.cooldown = {"up": float(cooldown_up_s),
                         "down": float(cooldown_down_s)}
        self.hold_opposite_s = float(hold_opposite_s)
        self._last = {"up": None, "down": None}   # direction -> t

    def check(self, direction: str, size: int, now: float,
              busy: bool = False, bounded: bool = True) -> Optional[str]:
        if direction not in ("up", "down"):
            raise ValueError(f"unknown direction: {direction}")
        if busy:
            return "busy"
        if bounded and direction == "up" and size >= self.max_size:
            return "at_max"
        if bounded and direction == "down" and size <= self.min_size:
            return "at_min"
        last = self._last[direction]
        if last is not None and now - last < self.cooldown[direction]:
            return "cooldown"
        opp = "down" if direction == "up" else "up"
        last_opp = self._last[opp]
        if last_opp is not None and now - last_opp < self.hold_opposite_s:
            return "hold"
        return None

    def record(self, direction: str, now: float) -> None:
        self._last[direction] = now

    def remaining(self, direction: str, now: float) -> float:
        last = self._last[direction]
        if last is None:
            return 0.0
        return max(0.0, self.cooldown[direction] - (now - last))


class _Fleet:
    """Per-fleet decision state: the governing rules currently in
    breach, the guardrails, and the attached actuator."""

    def __init__(self, name: str, guard: Guardrails):
        self.name = name
        self.guard = guard
        self.actuator = None
        self.breaching: Dict[str, dict] = {}   # rule -> last breach fields
        self.last_action: Optional[str] = None
        self.last_rule: Optional[str] = None

    def up_breaches(self, rule_fleets) -> List[str]:
        return sorted(r for r in self.breaching
                      if rule_fleets.get(r, (None, None))
                      == (self.name, "up"))

    def down_breaches(self, rule_fleets) -> List[str]:
        return sorted(r for r in self.breaching
                      if rule_fleets.get(r, (None, None))
                      == (self.name, "down"))


class AutopilotController:
    """One controller, two loops — see the module docstring.

    Construction is passive.  Attach actuators (``attach_actor`` /
    ``attach_serving``), subscribe ``on_slo_event`` to the SLO engine,
    then either ``start()`` the poll thread or drive ``step(now=...)``
    deterministically (tests, and the smoke's phase assertions).
    """

    def __init__(self, cfg, *, rollup_fn: Optional[Callable[[], dict]] = None,
                 emit: Optional[Callable[..., None]] = None,
                 rule_fleets: Optional[Dict[str, tuple]] = None):
        self.cfg = cfg
        self._rollup_fn = rollup_fn
        self._emit = emit
        self._rule_fleets = dict(rule_fleets if rule_fleets is not None
                                 else DEFAULT_RULE_FLEETS)
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._fleets: Dict[str, _Fleet] = {}
        self.decisions = 0      # actions decided (incl. dry-run)
        self.actions = 0        # actions actuated
        self.suppressed: Dict[str, int] = {}
        self.recent: deque = deque(maxlen=_RECENT)
        self._last_rollup: dict = {}
        # Idle (scale-down) rules ride the controller's own burn-window
        # engine — same damping discipline as the breach-driven side.
        idle_rules: List[SloRule] = []
        if cfg.serving_idle_qps_per_replica > 0:
            idle_rules.append(SloRule(
                "serving_idle", "lower",
                cfg.serving_idle_qps_per_replica,
                self._serving_qps_per_replica,
            ))
        if getattr(cfg, "replay_idle_add_qps_per_shard", 0.0) > 0:
            idle_rules.append(SloRule(
                "replay_idle", "lower",
                cfg.replay_idle_add_qps_per_shard,
                self._replay_add_qps_per_shard,
            ))
        self._idle = SloEngine(
            idle_rules, window_s=cfg.idle_window_s,
            burn_threshold=0.6, clear_threshold=0.3, min_samples=3,
            emit=self._idle_event,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring ------------------------------------------------------------

    def _make_fleet(self, name: str, actuator, min_size: int,
                    max_size: int) -> _Fleet:
        fleet = _Fleet(name, Guardrails(
            min_size=min_size, max_size=max_size,
            cooldown_up_s=self.cfg.cooldown_up_s,
            cooldown_down_s=self.cfg.cooldown_down_s,
            hold_opposite_s=self.cfg.hold_opposite_s,
        ))
        fleet.actuator = actuator
        self._fleets[name] = fleet
        return fleet

    def attach_actor(self, actuator) -> "AutopilotController":
        """Actor-fleet actuator (autopilot/actuators.ActorPoolActuator
        shape: size/capacity/busy/scale_up/scale_down/tune_drain/
        drain_factor/tune_pipeline)."""
        self._make_fleet(
            "actor", actuator,
            min_size=self.cfg.actor_min_workers,
            max_size=actuator.capacity(),
        )
        return self

    def attach_serving(self, actuator) -> "AutopilotController":
        """Serving-fleet actuator (ServingFleetActuator shape:
        size/busy/scale_up/scale_down)."""
        self._make_fleet(
            "serving", actuator,
            min_size=self.cfg.serving_min_replicas,
            max_size=self.cfg.serving_max_replicas,
        )
        return self

    def attach_replay(self, actuator) -> "AutopilotController":
        """Replay-fleet actuator (ReplayFleetActuator shape:
        size/busy/scale_up/scale_down over ReplayServiceFleet's
        grow/retire reshard primitives)."""
        self._make_fleet(
            "replay", actuator,
            min_size=self.cfg.replay_min_shards,
            max_size=self.cfg.replay_max_shards,
        )
        return self

    def on_slo_event(self, name: str, **fields) -> None:
        """SLO-engine subscription hook (``SloEngine.subscribe``):
        breach/clear transitions queue here and apply on the next
        ``step`` — the listener never blocks the scrape thread."""
        if name not in ("slo_breach", "slo_clear"):
            return
        with self._lock:
            self._events.append((name, fields))

    def _idle_event(self, name: str, **fields) -> None:
        # The idle engine's own transitions feed the same queue (rule
        # "serving_idle"), so scale-down decisions read like scale-up
        # ones in the state section and the event stream.
        if self._emit is not None:
            try:
                self._emit(name, **fields)
            except Exception:  # noqa: BLE001 — telemetry must not steer capacity
                pass
        with self._lock:
            self._events.append((name, fields))

    def _serving_qps_per_replica(self, rollup: dict) -> Optional[float]:
        srv = (rollup or {}).get("serving") or {}
        fleet = self._fleets.get("serving")
        if fleet is None or fleet.actuator is None:
            return None
        if not srv.get("replicas"):
            return None
        # Prefer the timeline's trailing-window rate over the
        # instantaneous scrape-to-scrape delta: one quiet sweep must not
        # read as idleness and shrink a loaded fleet.
        qps = (srv.get("window") or {}).get("qps")
        if qps is None:
            qps = srv.get("qps")
        if qps is None:
            return None
        return float(qps) / max(1, fleet.actuator.size())

    def _replay_add_qps_per_shard(self, rollup: dict) -> Optional[float]:
        rep = (rollup or {}).get("replay") or {}
        fleet = self._fleets.get("replay")
        if fleet is None or fleet.actuator is None:
            return None
        if not rep.get("shards_alive"):
            return None
        qps = (rep.get("window") or {}).get("add_qps")
        if qps is None:
            qps = rep.get("add_qps")
        if qps is None:
            return None
        return float(qps) / max(1, fleet.actuator.size())

    # -- the decision sweep ------------------------------------------------

    def _drain_events(self) -> None:
        with self._lock:
            events, self._events = list(self._events), deque()
        for name, fields in events:
            rule = fields.get("rule")
            if rule is None:
                continue
            owner = None
            if rule in IDLE_RULE_FLEETS:
                owner = self._fleets.get(IDLE_RULE_FLEETS[rule])
            else:
                fleet_name, _dir = self._rule_fleets.get(rule, (None, None))
                owner = self._fleets.get(fleet_name)
            if owner is None:
                continue
            if name == "slo_breach":
                owner.breaching[rule] = fields
            else:
                owner.breaching.pop(rule, None)

    def step(self, now: Optional[float] = None) -> List[dict]:
        """One decision sweep: ingest queued SLO transitions, evaluate
        the idle rules on a fresh rollup, then decide AT MOST ONE action
        per fleet through the guardrails.  Returns the actions decided
        this sweep (also emitted as ``autopilot_action`` events)."""
        now = time.monotonic() if now is None else float(now)
        self._drain_events()
        if self._rollup_fn is not None:
            try:
                self._last_rollup = self._rollup_fn() or {}
            except Exception:  # noqa: BLE001 — a sick rollup must not stop decisions on queued events
                pass
        if self._idle.rules:
            self._idle.evaluate(self._last_rollup, now=now)
            self._drain_events()   # idle transitions apply THIS sweep
        acted: List[dict] = []
        for fleet in self._fleets.values():
            rec = self._decide(fleet, now)
            if rec is not None:
                acted.append(rec)
        return acted

    def _decide(self, fleet: _Fleet, now: float) -> Optional[dict]:
        act = fleet.actuator
        if act is None:
            return None
        ups = fleet.up_breaches(self._rule_fleets)
        downs = fleet.down_breaches(self._rule_fleets)
        idle_rule = next(
            (r for r, owner in IDLE_RULE_FLEETS.items()
             if owner == fleet.name and r in fleet.breaching), None)
        if ups:
            rule = ups[0]
            reason = fleet.guard.check("up", act.size(), now,
                                       busy=act.busy())
            if reason == "at_max" and fleet.name == "actor":
                # Ceiling ladder: no more workers to add — degrade the
                # dispatch pipeline to strict depth instead (fresher
                # priorities), once.
                tune = getattr(act, "tune_pipeline", None)
                if tune is not None and fleet.guard.check(
                        "up", act.size(), now, bounded=False) is None:
                    return self._fire(fleet, "up", "tune_pipeline", rule,
                                      tune, now)
            if reason is not None:
                self._suppress(fleet, "up", reason)
                return None
            return self._fire(fleet, "up", "scale_up", rule,
                              act.scale_up, now)
        if downs and fleet.name == "actor":
            rule = downs[0]
            # Drain-harder-first ladder: raise the pool's drain budget
            # up to the configured multiple before retiring anyone.
            tune = getattr(act, "tune_drain", None)
            if tune is not None and act.drain_factor() \
                    < self.cfg.drain_tune_max_factor:
                if fleet.guard.check("down", act.size(), now,
                                     bounded=False) is not None:
                    self._suppress(fleet, "down", "cooldown")
                    return None
                return self._fire(fleet, "down", "tune_drain", rule,
                                  tune, now)
            reason = fleet.guard.check("down", act.size(), now)
            if reason is not None:
                self._suppress(fleet, "down", reason)
                return None
            return self._fire(fleet, "down", "scale_down", rule,
                              act.scale_down, now)
        if idle_rule is not None and not ups:
            reason = fleet.guard.check("down", act.size(), now,
                                       busy=act.busy())
            if reason is not None:
                self._suppress(fleet, "down", reason)
                return None
            return self._fire(fleet, "down", "scale_down", idle_rule,
                              act.scale_down, now)
        return None

    def _suppress(self, fleet: _Fleet, direction: str, reason: str) -> None:
        key = f"{fleet.name}:{direction}:{reason}"
        self.suppressed[key] = self.suppressed.get(key, 0) + 1

    def _fire(self, fleet: _Fleet, direction: str, action: str, rule: str,
              fn: Callable[[], Optional[dict]], now: float
              ) -> Optional[dict]:
        size_from = fleet.actuator.size()
        detail: Optional[dict] = None
        if not self.cfg.dry_run:
            try:
                detail = fn()
            except Exception as e:  # noqa: BLE001 — a failed actuation is a counted decision, never a controller crash
                detail = {"error": f"{type(e).__name__}: {e}"}
            if detail is None:
                # The actuator had nothing to move (no grow candidates,
                # no retirable member): a bound in disguise.
                self._suppress(fleet, direction, "exhausted")
                return None
        fleet.guard.record(direction, now)
        self.decisions += 1
        if not self.cfg.dry_run:
            self.actions += 1
        fleet.last_action = action
        fleet.last_rule = rule
        rec = {
            "fleet": fleet.name,
            "action": action,
            "direction": direction,
            "rule": rule,
            "size_from": size_from,
            "size_to": fleet.actuator.size(),
            "dry_run": bool(self.cfg.dry_run),
            "detail": detail,
        }
        self.recent.append(dict(rec, t=round(now, 3)))
        if self._emit is not None:
            try:
                self._emit("autopilot_action", **rec)
            except Exception:  # noqa: BLE001 — telemetry must not steer capacity
                pass
        return rec

    # -- observability -----------------------------------------------------

    def state(self, now: Optional[float] = None) -> dict:
        """The ``autopilot`` JSONL / /varz section (docs/METRICS.md
        "Autopilot schema", doc-pinned)."""
        now = time.monotonic() if now is None else float(now)
        fleets = {}
        for fleet in self._fleets.values():
            act = fleet.actuator
            fleets[fleet.name] = {
                "size": act.size() if act is not None else None,
                "min": fleet.guard.min_size,
                "max": fleet.guard.max_size,
                "busy": bool(act.busy()) if act is not None else False,
                "breaching": sorted(fleet.breaching),
                "last_action": fleet.last_action,
                "last_rule": fleet.last_rule,
                "cooldown_up_s": round(fleet.guard.remaining("up", now), 2),
                "cooldown_down_s": round(
                    fleet.guard.remaining("down", now), 2),
            }
        return {
            "enabled": True,
            "dry_run": bool(self.cfg.dry_run),
            "decisions": self.decisions,
            "actions": self.actions,
            "suppressed": dict(self.suppressed),
            "fleets": fleets,
            "idle": self._idle.status()["rules"],
            "recent": list(self.recent),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "AutopilotController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="autopilot", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(float(self.cfg.poll_s)):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the controller outlives a bad sweep
                pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
