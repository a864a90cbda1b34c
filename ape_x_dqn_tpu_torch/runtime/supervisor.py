"""Fleet supervision: the policy layer over every recovery signal.

Port of ``ape_x_dqn_tpu/runtime/supervisor.py``, one typed policy per
failure class:

  * ``RespawnPolicy`` (JAX :59-131) — a worker death respawns after an
    exponential backoff with jitter, inside a crash-loop budget: a worker
    that dies more than ``budget`` times within ``window_s`` is QUARANTINED
    (the fleet shrinks; the run goes on) instead of spinning the pool or
    failing the run.  ``ProcessActorPool.supervise()`` consults it (or the
    ``FleetSupervisor`` holding it) for every death.
  * ``LearnerWatchdog`` (JAX :132-201) — no learner progress (step or host
    syncs) for ``stall_deadline_s`` first DEGRADES: the overlapped
    ``DispatchPipeline`` drops to strict depth 1; still none
    ``wedge_deadline_s`` later declares the run WEDGED, an event, never a
    kill.  Any progress resets the ladder.
  * ``ServingStalenessPolicy`` (JAX :202-239) — a ``PolicyServer`` whose
    params age past ``serving.param_stale_s`` sheds new requests with the
    typed ``ServerOverloaded`` (``E_OVERLOADED`` on the wire) until a fresh
    snapshot lands.
  * ``FleetSupervisor`` (JAX :240-439) — one per run: holds the policies,
    counts respawns, quarantines, degradations and fallback restores
    (``utils/checkpoint_inc``'s walk-backs) as the registry's
    ``supervisor/*`` counters beside a ``supervisor`` provider (JAX
    :258-285), and ticks the watchdog and the staleness policies on a
    thread of its own.  With a ``Health`` the watchdog is the
    ``supervisor`` component of ``/healthz`` (a wedged run reads 503) and
    each staleness policy a ``serving_params`` one.  Its events go to the
    run's JSONL (``emit``).

Every method takes an optional ``now`` so tests drive time instead of
sleeping; the jitter generator is seeded.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

RESPAWN = "respawn"
WAIT = "wait"
QUARANTINE = "quarantine"


class RespawnPolicy:
    """Per-worker respawn discipline: exponential backoff + jitter inside a
    crash-loop budget.

    ``on_death(wid)`` records a death; ``decide(wid)`` answers what the pool
    should do now: ``RESPAWN`` (the backoff has elapsed), ``WAIT`` (ask
    again next sweep) or ``QUARANTINE`` (more than ``budget`` deaths inside
    ``window_s``).  The backoff doubles per death inside the window and
    carries multiplicative jitter, so a fleet-wide kill does not respawn in
    lockstep.
    """

    def __init__(self, base_s: float = 0.5, max_s: float = 30.0,
                 jitter: float = 0.25, window_s: float = 120.0,
                 budget: int = 5, seed: int = 0):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.window_s = float(window_s)
        self.budget = int(budget)
        self._rng = random.Random(seed ^ 0x5E5)
        self._deaths: Dict[int, deque] = {}
        self._next_ok: Dict[int, float] = {}
        self.quarantined: set = set()

    @classmethod
    def from_config(cls, scfg, seed: int = 0) -> "RespawnPolicy":
        """The policy a ``SupervisorConfig`` section describes."""
        return cls(base_s=scfg.respawn_backoff_base_s, max_s=scfg.respawn_backoff_max_s,
                   jitter=scfg.respawn_jitter, window_s=scfg.crash_loop_window_s,
                   budget=scfg.crash_loop_budget, seed=seed)

    def _window(self, wid: int, now: float) -> deque:
        d = self._deaths.setdefault(wid, deque())
        while d and now - d[0] > self.window_s:
            d.popleft()
        return d

    def on_death(self, wid: int, now: Optional[float] = None) -> str:
        """Record one death; returns ``QUARANTINE`` when this death blows the
        budget, else ``WAIT`` with the backoff armed."""
        now = time.monotonic() if now is None else now
        d = self._window(wid, now)
        d.append(now)
        if len(d) > self.budget:
            self.quarantined.add(wid)
            return QUARANTINE
        backoff = min(self.base_s * (2.0 ** (len(d) - 1)), self.max_s)
        backoff *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        self._next_ok[wid] = now + backoff
        return WAIT

    def decide(self, wid: int, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        if wid in self.quarantined:
            return QUARANTINE
        if now < self._next_ok.get(wid, 0.0):
            return WAIT
        return RESPAWN

    def backoff_remaining(self, wid: int, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return max(0.0, self._next_ok.get(wid, 0.0) - now)

    # The pool's callback surface (``FleetSupervisor`` has the same two).
    def on_worker_death(self, wid: int, error: str = "", now: Optional[float] = None) -> str:
        return self.on_death(wid, now)

    def decide_respawn(self, wid: int, now: Optional[float] = None) -> str:
        return self.decide(wid, now)

    def state(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        return {
            str(wid): {
                "deaths_in_window": len(self._window(wid, now)),
                "backoff_remaining_s": round(self.backoff_remaining(wid, now), 3),
                "quarantined": wid in self.quarantined,
            }
            for wid in sorted(set(self._deaths) | self.quarantined)
        }


class LearnerWatchdog:
    """Progress watchdog with a degrade-before-wedge ladder.

    ``progress_fn`` returns any hashable progress token (the pipeline gives
    ``(learner_step, host_syncs)``); a token unchanged for
    ``stall_deadline_s`` calls ``degrade_fn`` ONCE (phase ``degraded``), and
    still unchanged ``wedge_deadline_s`` after the degrade declares the run
    ``wedged``.  Any progress resets the ladder to ``ok``.
    """

    def __init__(self, progress_fn: Callable[[], object],
                 degrade_fn: Optional[Callable[[], None]] = None,
                 stall_deadline_s: float = 120.0, wedge_deadline_s: float = 120.0,
                 on_event: Optional[Callable[..., None]] = None):
        self._progress_fn = progress_fn
        self._degrade_fn = degrade_fn
        self.stall_deadline_s = float(stall_deadline_s)
        self.wedge_deadline_s = float(wedge_deadline_s)
        self._on_event = on_event
        self.phase = "ok"            # ok -> degraded -> wedged
        self.degradations = 0
        self._last_token = None
        self._last_progress: Optional[float] = None

    def check(self, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        try:
            token = self._progress_fn()
        except Exception:  # noqa: BLE001 — an unreadable learner counts as stalled
            token = self._last_token
        if self._last_progress is None or token != self._last_token:
            self._last_token = token
            self._last_progress = now
            if self.phase != "ok" and token is not None:
                self._event("watchdog_recovered", phase_was=self.phase)
                self.phase = "ok"
            return self.phase
        stalled_s = now - self._last_progress
        if self.phase == "ok" and stalled_s > self.stall_deadline_s:
            self.phase = "degraded"
            self.degradations += 1
            self._event("pipeline_degraded", stalled_s=round(stalled_s, 1))
            if self._degrade_fn is not None:
                try:
                    self._degrade_fn()
                except Exception:  # noqa: BLE001 — the degrade is best effort
                    pass
            # Strict mode gets a whole deadline to show progress.
            self._last_progress = now
        elif self.phase == "degraded" and stalled_s > self.wedge_deadline_s:
            self.phase = "wedged"
            self._event("run_wedged", stalled_s=round(stalled_s, 1))
        return self.phase

    def age_s(self) -> float:
        """0 while ok or degraded, +inf once wedged (a health check's age)."""
        return float("inf") if self.phase == "wedged" else 0.0

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, **fields)
            except Exception:  # noqa: BLE001 — an observer must never break supervision
                pass


class ServingStalenessPolicy:
    """Degrade a ``PolicyServer`` whose param source went quiet: ``check()``
    compares the server's param age with ``stale_after_s`` and toggles its
    ``degraded`` flag (submissions shed with the typed ``ServerOverloaded``);
    a fresh snapshot's adoption recovers it at the next check."""

    def __init__(self, server, stale_after_s: float,
                 on_event: Optional[Callable[..., None]] = None):
        self._server = server
        self.stale_after_s = float(stale_after_s)
        self._on_event = on_event
        self.transitions = 0

    def age_s(self) -> float:
        return self._server.param_age_s

    def check(self, now: Optional[float] = None) -> bool:
        """The (possibly toggled) degraded state."""
        stale = self.age_s() > self.stale_after_s
        if stale != self._server.degraded:
            self._server.degraded = stale
            self.transitions += 1
            if self._on_event is not None:
                try:
                    self._on_event("serving_degraded" if stale else "serving_recovered",
                                   param_age_s=round(self.age_s(), 3),
                                   stale_after_s=self.stale_after_s)
                except Exception:  # noqa: BLE001 — telemetry; the shedding still happens
                    pass
        return stale


class FleetSupervisor:
    """One supervisor per run: the policies, their counters and the thread
    that ticks the watchdog and the staleness policies.

    Construction registers the four ``supervisor/*`` counters and the
    ``supervisor`` provider on ``registry`` (a private one when None);
    ``attach_pool(pool)`` installs it as the pool's respawn policy (the pool
    calls ``on_worker_death`` / ``decide_respawn``);
    ``attach_learner(progress_fn, degrade_fn)`` arms the watchdog;
    ``attach_serving(server, stale_after_s)`` arms staleness shedding;
    ``start()`` / ``close()`` run the ``poll_s`` tick thread.  Restores that
    walked back a corrupt chain before it existed are counted at
    construction.
    """

    def __init__(self, cfg, registry=None, health=None,
                 emit: Optional[Callable[..., None]] = None, seed: int = 0):
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import consume_fallback_events

        self.cfg = cfg
        self._health = health
        self._emit = emit
        self.events: List[dict] = []
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self.respawns = reg.counter("supervisor/respawns", help="worker respawns ordered")
        self.quarantines = reg.counter("supervisor/quarantines",
                                       help="workers quarantined (crash loop)")
        self.degradations = reg.counter(
            "supervisor/degradations",
            help="degraded-mode transitions (pipeline strict, serving shed)")
        self.fallback_restores = reg.counter(
            "supervisor/fallback_restores",
            help="checkpoint restores that walked back a corrupt chain")
        reg.register_provider("supervisor", self.state)
        self.respawn_policy = RespawnPolicy.from_config(cfg, seed=seed)
        self.watchdog: Optional[LearnerWatchdog] = None
        self.serving_policies: List[ServingStalenessPolicy] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for ev in consume_fallback_events():
            self.note_fallback_restore(ev)

    def _event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})
        if len(self.events) > 1024:
            del self.events[:256]
        if self._emit is not None:
            try:
                self._emit(kind, **fields)
            except Exception:  # noqa: BLE001 — telemetry must not stop supervision
                pass

    # -- worker respawn (the pool's callback surface) ------------------------

    def attach_pool(self, pool) -> "FleetSupervisor":
        pool.respawn_policy = self
        return self

    def on_worker_death(self, wid: int, error: str = "", now: Optional[float] = None) -> str:
        verdict = self.respawn_policy.on_death(wid, now)
        if verdict == QUARANTINE:
            self.quarantines.inc()
            self._event("worker_quarantined", worker=wid, error=error,
                        deaths_in_window=len(self.respawn_policy._deaths.get(wid, ())))
        else:
            self._event("worker_death", worker=wid, error=error,
                        backoff_s=round(self.respawn_policy.backoff_remaining(wid, now), 3))
        return verdict

    def decide_respawn(self, wid: int, now: Optional[float] = None) -> str:
        verdict = self.respawn_policy.decide(wid, now)
        if verdict == RESPAWN:
            self.respawns.inc()
            self._event("worker_respawn", worker=wid)
        return verdict

    # -- learner watchdog ----------------------------------------------------

    def attach_learner(self, progress_fn: Callable[[], object],
                       degrade_fn: Optional[Callable[[], None]] = None) -> "FleetSupervisor":
        def degrade():
            self.degradations.inc()
            if degrade_fn is not None:
                degrade_fn()

        self.watchdog = LearnerWatchdog(progress_fn, degrade,
                                        stall_deadline_s=self.cfg.stall_deadline_s,
                                        wedge_deadline_s=self.cfg.wedge_deadline_s,
                                        on_event=self._event)
        if self._health is not None:
            self._health.register("supervisor", self.watchdog.age_s)
        return self

    # -- serving staleness ---------------------------------------------------

    def attach_serving(self, server, stale_after_s: float) -> ServingStalenessPolicy:
        def on_event(kind, **fields):
            if kind == "serving_degraded":
                self.degradations.inc()
            self._event(kind, **fields)

        policy = ServingStalenessPolicy(server, stale_after_s, on_event=on_event)
        self.serving_policies.append(policy)
        if self._health is not None:
            self._health.register("serving_params", policy.age_s,
                                  stale_after_s=stale_after_s)
        return policy

    # -- checkpoint fallback -------------------------------------------------

    def note_fallback_restore(self, event: dict) -> None:
        self.fallback_restores.inc()
        self._event("degraded_restore", **{k: v for k, v in event.items() if k != "event"})

    # -- the tick thread -----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        if self.watchdog is not None:
            self.watchdog.check(now)
        for policy in self.serving_policies:
            policy.check(now)

    def start(self) -> "FleetSupervisor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="fleet-supervisor",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(float(self.cfg.poll_s)):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the supervisor outlives a sick policy
                pass

    def state(self) -> dict:
        """The live policy state: per-worker backoff, the quarantine list,
        the watchdog's phase, serving shedding, the latest events."""
        return {
            "workers": self.respawn_policy.state(),
            "quarantined": sorted(self.respawn_policy.quarantined),
            "watchdog": self.watchdog.phase if self.watchdog is not None else None,
            "serving_degraded": any(p._server.degraded for p in self.serving_policies),
            "recent_events": self.events[-8:],
        }
