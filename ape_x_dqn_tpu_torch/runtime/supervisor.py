"""Worker respawn policy — port of ``RespawnPolicy`` from
``ape_x_dqn_tpu/runtime/supervisor.py`` (:59-131).

A worker death respawns after an exponential backoff with jitter, inside a
crash-loop budget: a worker that dies more than ``budget`` times within
``window_s`` is QUARANTINED (the fleet shrinks; the run goes on) instead of
spinning the pool or failing the run.  With ``supervisor.enabled`` (the
default) the async pipeline sets the policy as the pool's
``respawn_policy``, as the JAX ``FleetSupervisor.attach_pool`` does
(:321-324), and ``ProcessActorPool.supervise()`` consults it for every
death.  The JAX module's ``LearnerWatchdog``, ``ServingStalenessPolicy``
and obs counters are not part of the port yet.

Every method takes an optional ``now`` so tests drive time instead of
sleeping; the jitter generator is seeded.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Dict, Optional

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
