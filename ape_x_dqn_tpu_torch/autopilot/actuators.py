"""Concrete actuators binding the controller to the three fleets (port of
``ape_x_dqn_tpu/autopilot/actuators.py``).

Thin, state-light adapters: every capacity primitive they call is owned
by the fleet object itself (``ProcessActorPool.grow``/``retire``/
``set_drain_budget``, ``ServingFleet.spawn``/``retire``,
``ReplayServiceFleet.grow``/``retire``, ``DispatchPipeline.degrade``) —
the actuator only names the protocol the controller speaks
(``size``/``busy``/``scale_up``/``scale_down`` + the actor loop's
tuning ladder), so unit tests drive the controller with dict-recording
fakes and never spawn a process.
"""

from __future__ import annotations

from typing import Callable, Optional


class ActorPoolActuator:
    """Actor-fleet actuator over a ``ProcessActorPool``.

    ``pipeline_fn`` (optional) resolves the live DispatchPipeline at
    call time — AsyncPipeline constructs it after the pool, so a
    deferred lookup is the only correct binding.
    """

    def __init__(self, pool, *, pipeline_fn: Optional[Callable] = None):
        self._pool = pool
        self._pipeline_fn = pipeline_fn
        self._drain_base = max(1, int(pool.drain_budget_bytes))
        self._pipeline_tuned = False

    def size(self) -> int:
        return len(self._pool.live_workers())

    def capacity(self) -> int:
        return int(self._pool.local_capacity)

    def busy(self) -> bool:
        # Worker spawns are seconds, not minutes; the up-cooldown is the
        # settling window — the pool itself is never "booting".
        return False

    def scale_up(self) -> Optional[dict]:
        grown = self._pool.grow(1)
        return {"wids": grown} if grown else None

    def scale_down(self) -> Optional[dict]:
        wid = self._pool.retire()
        return {"wid": wid} if wid is not None else None

    def drain_factor(self) -> float:
        return self._pool.drain_budget_bytes / self._drain_base

    def tune_drain(self) -> dict:
        """One rung of the drain ladder: double the pool's per-poll
        drain budget (the controller bounds the factor)."""
        budget = self._pool.set_drain_budget(
            self._pool.drain_budget_bytes * 2
        )
        return {"drain_budget_bytes": budget,
                "factor": round(self.drain_factor(), 2)}

    def tune_pipeline(self) -> Optional[dict]:
        """Ceiling fallback: degrade the overlapped dispatch pipeline to
        strict depth 1 (fresher priority write-backs) — once."""
        if self._pipeline_tuned or self._pipeline_fn is None:
            return None
        pipeline = self._pipeline_fn()
        if pipeline is None or getattr(pipeline, "depth", 1) <= 1:
            return None
        pipeline.degrade()
        self._pipeline_tuned = True
        return {"pipeline_depth": pipeline.depth}


class ServingFleetActuator:
    """Serving-fleet actuator over a ``ServingFleet``.

    ``on_scale`` (optional) is called as ``on_scale(kind, rid)`` after
    every actuation — how a caller keeps its aggregator's endpoint set
    in step with the fleet (register a spawned replica's /varz, forget a
    retired one).
    """

    def __init__(self, fleet, *, drain_grace_s: float = 2.0,
                 on_scale: Optional[Callable] = None):
        self._fleet = fleet
        self._grace = float(drain_grace_s)
        self._on_scale = on_scale

    def size(self) -> int:
        return len(self._fleet.active_replicas())

    def busy(self) -> bool:
        # A spawned replica imports torch and builds its server before it
        # can serve; holding further scale-ups while one boots is the
        # one-step-at-a-time guardrail made physical.
        return bool(self._fleet.booting())

    def _notify(self, kind: str, rid) -> None:
        if self._on_scale is not None and rid is not None:
            try:
                self._on_scale(kind, rid)
            except Exception:  # noqa: BLE001 — observer must not block actuation
                pass

    def scale_up(self) -> Optional[dict]:
        rid = self._fleet.spawn()
        self._notify("spawn", rid)
        return {"rid": rid}

    def scale_down(self) -> Optional[dict]:
        rid = self._fleet.retire(drain_grace_s=self._grace)
        self._notify("retire", rid)
        return {"rid": rid} if rid is not None else None


class ReplayFleetActuator:
    """Replay-fleet actuator over a ``ReplayServiceFleet`` — the third
    autopilot-governed fleet.

    Scale-up is ``fleet.grow()`` (spawn + announce a fresh highest-sid
    shard); scale-down is ``fleet.retire()`` (drain → stop → restore →
    digest-proven re-ingest into the survivors).  Both return None when
    nothing moved (spawn failed, handoff digest mismatch, nothing
    retirable) — the controller books that as ``exhausted``, never a
    crash.  ``on_scale(kind, sid)`` mirrors the serving actuator's
    observer hook so a caller can keep its aggregator in step when it is
    not membership-driven.
    """

    def __init__(self, fleet, *, drain_grace_s: float = 0.5,
                 on_scale: Optional[Callable] = None):
        self._fleet = fleet
        self._grace = float(drain_grace_s)
        self._on_scale = on_scale

    def size(self) -> int:
        return int(self._fleet.num_shards)

    def busy(self) -> bool:
        # One topology change at a time: a reshard in flight (grow's
        # spawn-and-announce or a retire's handoff chain) holds further
        # actuation until the slot-range math is settled.
        return bool(self._fleet.resharding())

    def _notify(self, kind: str, sid) -> None:
        if self._on_scale is not None and sid is not None:
            try:
                self._on_scale(kind, sid)
            except Exception:  # noqa: BLE001 — observer must not block actuation
                pass

    def scale_up(self) -> Optional[dict]:
        sid = self._fleet.grow()
        self._notify("grow", sid)
        return {"sid": sid} if sid is not None else None

    def scale_down(self) -> Optional[dict]:
        sid = self._fleet.retire(drain_grace_s=self._grace)
        self._notify("retire", sid)
        return {"sid": sid} if sid is not None else None
