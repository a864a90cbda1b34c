"""The port's supervision tier (``ape_x_dqn_tpu_torch/runtime/supervisor.py``)
against the JAX package's, mirrored from ``tests/test_supervisor.py``.

Policies are clock-injected, so both packages are driven through the same
time scripts and must answer the same: the watchdog's degrade-then-wedge
ladder, its reset on progress and its unreadable-progress case; the fleet
supervisor's respawn, quarantine and fallback-restore counters and its
events; staleness shedding on a real CPU ``PolicyServer``, typed, and its
recovery; the pipeline's wiring (the watchdog's degrade drops a live
``DispatchPipeline`` to depth 1; the JSONL ``supervisor`` section).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from ape_x_dqn_tpu.config import SupervisorConfig as JSupervisorConfig
from ape_x_dqn_tpu.runtime import supervisor as jsup
from ape_x_dqn_tpu_torch.config import SupervisorConfig
from ape_x_dqn_tpu_torch.models import dueling as tdueling
from ape_x_dqn_tpu_torch.runtime import supervisor as tsup
from ape_x_dqn_tpu_torch.runtime.supervisor import (
    QUARANTINE,
    RESPAWN,
    WAIT,
    FleetSupervisor,
    LearnerWatchdog,
    ServingStalenessPolicy,
)
from ape_x_dqn_tpu_torch.serving.batcher import ServerOverloaded
from ape_x_dqn_tpu_torch.serving.server import PolicyServer

# (now, progress token) — each script is replayed against both packages.
SCRIPTS = {
    "degrade_then_wedge": [(0.0, 0), (9.0, 0), (11.0, 0), (30.0, 0), (32.0, 0), (40.0, 0)],
    "progress_resets": [(0.0, 0), (11.0, 0), (12.0, 1), (21.0, 1), (25.0, 1), (40.0, 2)],
    "slow_but_moving": [(float(t), t // 5) for t in range(0, 60, 3)],
    "unreadable": [(0.0, None), (6.0, "raise"), (12.0, "raise"), (30.0, "raise")],
}


def _run_watchdog(mod, script):
    state = {"token": None}
    degraded, events = [], []

    def progress():
        if state["token"] == "raise":
            raise RuntimeError("learner gone")
        return state["token"]

    w = mod.LearnerWatchdog(progress, lambda: degraded.append(1), stall_deadline_s=10.0,
                            wedge_deadline_s=20.0,
                            on_event=lambda kind, **f: events.append((kind, f)))
    phases = []
    for now, token in script:
        state["token"] = token
        phases.append(w.check(now=now))
    return phases, len(degraded), w.degradations, w.age_s(), events


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_watchdog_ladder_equals_jax(script):
    got = _run_watchdog(tsup, SCRIPTS[script])
    assert got == _run_watchdog(jsup, SCRIPTS[script])


def test_watchdog_degrade_then_wedge_ladder():
    phases, degraded, degradations, age, events = _run_watchdog(
        tsup, SCRIPTS["degrade_then_wedge"])
    assert phases == ["ok", "ok", "degraded", "degraded", "wedged", "wedged"]
    assert degraded == degradations == 1 and age == float("inf")
    assert [k for k, _ in events] == ["pipeline_degraded", "run_wedged"]


def test_watchdog_progress_resets_ladder():
    phases, _, _, age, events = _run_watchdog(tsup, SCRIPTS["progress_resets"])
    assert phases[:3] == ["ok", "degraded", "ok"] and age == 0.0
    assert ("watchdog_recovered", {"phase_was": "degraded"}) in events


def test_unreadable_progress_counts_as_stalled():
    w = LearnerWatchdog(lambda: 1 / 0, None, stall_deadline_s=5.0, wedge_deadline_s=5.0)
    w.check(now=0.0)
    assert w.check(now=6.0) == "degraded"


# -- the fleet supervisor ---------------------------------------------------------


def _sup(mod_cfg, mod, **over):
    """A supervisor of ``mod``'s package.  Each package counts, at
    construction, the fallback restores its process recorded so far; an
    earlier test in this worker process may have left some behind, so both
    packages' records are drained first."""
    from ape_x_dqn_tpu.utils.checkpoint_inc import consume_fallback_events as jconsume
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import consume_fallback_events as tconsume

    jconsume()
    tconsume()
    return mod.FleetSupervisor(mod_cfg(**over), emit=None, seed=0)


def test_death_respawn_quarantine_accounting_equals_jax():
    over = dict(respawn_backoff_base_s=0.0, respawn_backoff_max_s=0.0, respawn_jitter=0.0,
                crash_loop_budget=2)
    results = []
    for cfg_cls, mod in ((SupervisorConfig, tsup), (JSupervisorConfig, jsup)):
        sup = _sup(cfg_cls, mod, **over)
        trace = [sup.on_worker_death(0, "boom", now=0.0), sup.decide_respawn(0, now=0.1),
                 sup.on_worker_death(0, "boom", now=0.2),
                 sup.on_worker_death(0, "boom", now=0.3), sup.decide_respawn(0, now=9.0)]
        results.append((trace, int(sup.respawns.value), int(sup.quarantines.value),
                        sup.state()["quarantined"], sup.respawn_policy.state(now=1.0),
                        [e["kind"] for e in sup.events]))
    assert results[0] == results[1]
    trace, respawns, quarantines, quarantined, _, kinds = results[0]
    assert trace == [WAIT, RESPAWN, WAIT, QUARANTINE, QUARANTINE]
    assert (respawns, quarantines, quarantined) == (1, 1, [0])
    assert "worker_quarantined" in kinds and "worker_respawn" in kinds


def test_fallback_events_drained_at_construction():
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
        FALLBACK_EVENTS,
        consume_fallback_events,
    )

    consume_fallback_events()
    FALLBACK_EVENTS.append({"event": "degraded_restore", "fallback": "previous_generation",
                            "generation": 1, "step": 40})
    emitted = []
    sup = FleetSupervisor(SupervisorConfig(), emit=lambda k, **f: emitted.append((k, f)))
    assert sup.fallback_restores.value == 1 and not FALLBACK_EVENTS
    assert emitted == [("degraded_restore", {"fallback": "previous_generation",
                                             "generation": 1, "step": 40})]


def test_supervisor_is_the_pools_respawn_policy():
    class Pool:
        respawn_policy = None

    pool = Pool()
    sup = FleetSupervisor(SupervisorConfig(respawn_backoff_base_s=0.0, respawn_jitter=0.0))
    assert sup.attach_pool(pool) is sup and pool.respawn_policy is sup
    assert pool.respawn_policy.on_worker_death(3, "x", now=0.0) == WAIT
    assert pool.respawn_policy.decide_respawn(3, now=0.0) == RESPAWN
    # A bare RespawnPolicy offers the same two calls.
    bare = tsup.RespawnPolicy(base_s=0.0, jitter=0.0)
    assert bare.on_worker_death(3, "x", now=0.0) == WAIT
    assert bare.decide_respawn(3, now=0.0) == RESPAWN


@pytest.mark.parametrize("field,value", [("stall_deadline_s", 0.0),
                                         ("wedge_deadline_s", -1.0), ("poll_s", 0.0)])
def test_watchdog_knobs_validated(field, value):
    from ape_x_dqn_tpu_torch.config import ApexConfig

    cfg = ApexConfig()
    setattr(cfg.supervisor, field, value)
    with pytest.raises(ValueError, match=field):
        cfg.validate()


# -- serving staleness on a real CPU server ---------------------------------------


def _server():
    net = tdueling.build_network("mlp", 3, (4,), hidden_sizes=(8,))
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return PolicyServer(net, params, max_batch=2, max_wait_ms=1.0, device="cpu").start()


def test_stale_sheds_typed_and_recovers():
    server = _server()
    try:
        policy = ServingStalenessPolicy(server, stale_after_s=0.05)
        obs = np.zeros((4,), np.uint8)
        assert server.act(obs, timeout=10.0).action in (0, 1, 2)
        time.sleep(0.1)
        assert policy.check() is True and server.degraded
        assert policy.age_s() > 0.05
        with pytest.raises(ServerOverloaded, match="stale"):
            server.submit(obs)
        assert server.stats()["shed_total"] >= 1 and server.stats()["degraded"] is True
        server._live = (*server._live[:2], server._live[2] + 1, time.monotonic())
        assert policy.check() is False and not server.degraded
        assert server.act(obs, timeout=10.0).action in (0, 1, 2)
        assert policy.transitions == 2
    finally:
        server.close()


def test_supervisor_attach_serving_counts_degradations():
    server = _server()
    try:
        sup = FleetSupervisor(SupervisorConfig(), emit=None, seed=0)
        policy = sup.attach_serving(server, stale_after_s=0.05)
        time.sleep(0.1)
        sup.tick()
        assert server.degraded and sup.degradations.value == 1
        assert sup.state()["serving_degraded"] is True and policy in sup.serving_policies
        assert [e["kind"] for e in sup.events] == ["serving_degraded"]
    finally:
        server.close()


def test_supervisor_thread_ticks_and_closes():
    ticks = []
    sup = FleetSupervisor(SupervisorConfig(poll_s=0.01))
    sup.attach_learner(lambda: ticks.append(1) or 0)
    sup.start()
    deadline = time.monotonic() + 10.0
    while len(ticks) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    sup.close()
    assert len(ticks) >= 3 and sup._thread is None


# -- the pipeline's wiring -----------------------------------------------------------


def test_pipeline_watchdog_degrades_the_overlapped_pipeline():
    from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.runtime.infeed import DispatchPipeline

    cfg = apply_overrides(ApexConfig(), [
        "network=mlp", "env.name=chain:6", "learner.device_replay=true",
        "replay.capacity=512", "learner.min_replay_mem_size=64",
        "learner.steps_per_call=4", "learner.pipeline_depth=2", "actor.num_actors=2"])
    pipe = AsyncPipeline(cfg, device="cpu")
    try:
        assert pipe.supervisor is not None and pipe.supervisor.watchdog is not None
        pipe._dispatch_pipeline = DispatchPipeline(2, probe_fn=lambda m: m)
        wd = pipe.supervisor.watchdog
        wd.check(now=0.0)
        assert wd.check(now=cfg.supervisor.stall_deadline_s + 1.0) == "degraded"
        assert pipe._dispatch_pipeline.depth == 1
        section = pipe._sections_extra()["supervisor"]
        assert section["degradations"] == 1 and section["watchdog"] == "degraded"
    finally:
        pipe.worker.join()
        pipe._publisher.close()
