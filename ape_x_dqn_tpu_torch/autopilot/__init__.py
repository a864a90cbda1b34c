"""The elastic autopilot: the SLO-driven capacity controller (port of
``ape_x_dqn_tpu/autopilot/``).

The fleet aggregator (``obs/fleet.FleetAggregator``) and its SLO engine
are the sensor; this package is the actuation.  One
:class:`AutopilotController` (its own thread, ``autopilot.*`` knobs,
default off) consumes the engine's ``slo_breach`` / ``slo_clear`` events
and the rollup, and moves capacity:

  * **actor fleet**: grow or retire worker processes through the pool's
    elastic primitives (``ProcessActorPool.grow`` / ``retire``: reserved
    wids on the same ε-ladder partition, retire by a clean drain, never a
    SIGKILL), and tune the drain budget and the pipeline depth, to hold
    the age-of-experience p95 under its bound and ring occupancy in band;
  * **serving fleet**: grow or retire replicas through
    ``ServingFleet.spawn`` and the router's drain from rotation
    (``retire``), against the QPS floor and the p99 bound;
  * **replay fleet**: grow or retire shards through
    ``ReplayServiceFleet.grow`` / ``retire`` (resharding with a
    digest-proven handoff), against the per-shard add QPS.

Every decision passes shared guardrails (min/max bounds, per-direction
cooldowns, a hold against the opposite direction, one step at a time)
and emits a typed ``autopilot_action`` event naming its rule;
``autopilot.dry_run`` decides without actuating.

Import-light (stdlib at module scope): tools mount the controller beside
an aggregator on hosts that never import torch.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "AutopilotController": "ape_x_dqn_tpu_torch.autopilot.controller",
    "Guardrails": "ape_x_dqn_tpu_torch.autopilot.controller",
    "ActorPoolActuator": "ape_x_dqn_tpu_torch.autopilot.actuators",
    "ServingFleetActuator": "ape_x_dqn_tpu_torch.autopilot.actuators",
    "ReplayFleetActuator": "ape_x_dqn_tpu_torch.autopilot.actuators",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
