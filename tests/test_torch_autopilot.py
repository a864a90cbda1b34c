"""The autopilot against the JAX package.

Twins of ``tests/test_autopilot.py`` and of ``tests/test_fleet.py``'s
``TestReplayFleetControl``.  The decisions are pure: every case drives both
packages' controllers with the same event stream, fake actuators and
injected clocks, and requires the same action trail, events and
``suppressed`` map, then the oracle's own assertions on the port.  The
actuators then move real CPU processes: ``ActorPoolActuator`` over the
port's ``ProcessActorPool`` (grow, clean retire), ``ServingFleetActuator``
over a ``ServingFleet`` of CPU replicas (1 → 2 → 1) and
``ReplayFleetActuator`` over a CPU ``ReplayServiceFleet`` (2 → 3 → 2, the
handoff digest-proven).  Last, the slice: a CPU ``AsyncPipeline`` with the
autopilot on runs ``chip_smoke.py``'s ``autopilot_train`` drill (green,
kill, breach, scale-up, clear) at CPU size.

Every case that spawns processes has its own deadline and stops what it
started in ``finally``; at most 2 workers or replicas run at once beside
the learner, each with one intra-op thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
from _torch_harness import bounded_teardown, pinned_cores, port_deadline  # noqa: F401 — port_deadline is autouse

import ape_x_dqn_tpu.autopilot as japilot
import ape_x_dqn_tpu_torch.autopilot as tapilot
from ape_x_dqn_tpu import config as jconfig
from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch.autopilot import AutopilotController, Guardrails

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (japilot, jconfig), "torch": (tapilot, tconfig)}
STAMPS = ("seq", "pid")


def make_cfg(cfg_mod=tconfig, **kw):
    base = dict(enabled=True, dry_run=False, poll_s=0.1, actor_min_workers=1,
                serving_min_replicas=1, serving_max_replicas=4, cooldown_up_s=5.0,
                cooldown_down_s=5.0, hold_opposite_s=8.0, serving_idle_qps_per_replica=0.0,
                idle_window_s=10.0, drain_tune_max_factor=4.0)
    base.update(kw)
    return cfg_mod.AutopilotConfig(**base)


class FakeServing:
    def __init__(self, size=1, busy=False, exhausted=False):
        self._size = size
        self._busy = busy
        self._exhausted = exhausted
        self.calls = []

    def size(self):
        return self._size

    def busy(self):
        return self._busy

    def scale_up(self):
        if self._exhausted:
            return None
        self.calls.append("up")
        self._size += 1
        return {"rid": self._size}

    def scale_down(self):
        if self._exhausted:
            return None
        self.calls.append("down")
        self._size -= 1
        return {"rid": self._size + 1}


class FakeActor(FakeServing):
    def __init__(self, size=1, capacity=4, **kw):
        super().__init__(size=size, **kw)
        self._capacity = capacity
        self._drain = 1.0
        self.pipeline_tunes = 0

    def capacity(self):
        return self._capacity

    def drain_factor(self):
        return self._drain

    def tune_drain(self):
        self.calls.append("tune_drain")
        self._drain *= 2
        return {"factor": self._drain}

    def tune_pipeline(self):
        if self.pipeline_tunes:
            return None
        self.calls.append("tune_pipeline")
        self.pipeline_tunes += 1
        return {"pipeline_depth": 1}


def breach(ctl, rule, **fields):
    ctl.on_slo_event("slo_breach", rule=rule, value=1.0, bound=0.5, **fields)


def clear(ctl, rule):
    ctl.on_slo_event("slo_clear", rule=rule, value=0.1, bound=0.5)


class Run:
    """One package's controller with fakes: ``script(run)`` calls
    ``breach``/``clear``/``step`` on it; the trail is comparable."""

    def __init__(self, pkg, cfg_kw=None, serving=None, actor=None, rollup=None):
        mod, cfg_mod = PKGS[pkg]
        self.events = []
        self.ctl = mod.AutopilotController(
            make_cfg(cfg_mod, **(cfg_kw or {})),
            rollup_fn=(lambda: rollup) if rollup is not None else None,
            emit=lambda name, **f: self.events.append((name, f)))
        self.serving, self.actor = serving, actor
        if serving is not None:
            self.ctl.attach_serving(serving)
        if actor is not None:
            self.ctl.attach_actor(actor)
        self.acted = []

    def step(self, now):
        acted = self.ctl.step(now=now)
        self.acted.append(acted)
        return acted

    def trail(self):
        return {"acted": self.acted,
                "events": [(n, {k: v for k, v in f.items() if k not in STAMPS})
                           for n, f in self.events],
                "suppressed": dict(self.ctl.suppressed), "decisions": self.ctl.decisions,
                "actions": self.ctl.actions, "state": self.ctl.state(now=100.0),
                "serving": self.serving.calls if self.serving else None,
                "actor": self.actor.calls if self.actor else None}


def both(script, cfg_kw=None, rollup=None, serving=None, actor=None):
    """Run ``script`` on both packages' controllers, with fresh fakes from
    the ``serving`` / ``actor`` factories; require equal trails and return
    the port's run."""
    runs = {}
    for pkg in PKGS:
        runs[pkg] = Run(pkg, cfg_kw=cfg_kw, rollup=rollup,
                        serving=serving() if serving else None,
                        actor=actor() if actor else None)
        script(runs[pkg])
    assert runs["torch"].trail() == runs["jax"].trail()
    return runs["torch"]


# -- guardrails -------------------------------------------------------------------


class TestGuardrails:
    def g(self, mod=tapilot, **kw):
        base = dict(min_size=1, max_size=3, cooldown_up_s=10.0, cooldown_down_s=20.0,
                    hold_opposite_s=30.0)
        base.update(kw)
        return mod.Guardrails(**base)

    def _both(self, calls):
        out = {}
        for pkg, (mod, _) in PKGS.items():
            g = self.g(mod)
            out[pkg] = [getattr(g, name)(*args, **kw) for name, args, kw in calls]
        assert out["torch"] == out["jax"]
        return out["torch"]

    def test_bounds_clamp(self):
        assert self._both([("check", ("up", 3), {"now": 0.0}),
                           ("check", ("down", 1), {"now": 0.0}),
                           ("check", ("up", 2), {"now": 0.0}),
                           ("check", ("up", 3), {"now": 0.0, "bounded": False})]) \
            == ["at_max", "at_min", None, None]

    def test_per_direction_cooldown(self):
        out = self._both([("record", ("up", 0.0), {}), ("check", ("up", 2), {"now": 5.0}),
                          ("check", ("up", 2), {"now": 10.1}),
                          ("remaining", ("up", 5.0), {})])
        assert out[1:3] == ["cooldown", None] and round(out[3], 1) == 5.0

    def test_hold_opposite_outlasts_own_cooldown(self):
        assert self._both([("record", ("up", 0.0), {}),
                           ("check", ("down", 2), {"now": 25.0}),
                           ("check", ("down", 2), {"now": 30.1})])[1:] == ["hold", None]

    def test_busy_blocks_everything(self):
        assert self._both([("check", ("up", 2), {"now": 0.0, "busy": True})]) == ["busy"]

    def test_unknown_direction_raises(self):
        for mod, _ in PKGS.values():
            with pytest.raises(ValueError, match="unknown direction: sideways"):
                self.g(mod).check("sideways", 2, now=0.0)


# -- the controller's decisions ---------------------------------------------------


class TestControllerDecisions:
    def test_scale_up_on_breach_then_cooldown_suppression(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            r.step(0.0)
            r.step(2.0)
            r.step(6.0)

        r = both(script, serving=lambda: FakeServing(size=1))
        assert [a["action"] for a in r.acted[0]] == ["scale_up"]
        assert r.events[0][0] == "autopilot_action"
        assert (r.events[0][1]["rule"], r.events[0][1]["size_from"],
                r.events[0][1]["size_to"]) == ("serving_p99_ms", 1, 2)
        assert r.acted[1] == [] and r.ctl.suppressed.get("serving:up:cooldown") == 1
        assert [a["action"] for a in r.acted[2]] == ["scale_up"] and r.serving.size() == 3

    def test_clear_stops_scaling(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            r.step(0.0)
            clear(r.ctl, "serving_p99_ms")
            r.step(10.0)

        r = both(script, serving=lambda: FakeServing(size=1))
        assert r.acted[1] == [] and r.serving.size() == 2

    def test_bounds_clamp_at_max(self):
        def script(r):
            breach(r.ctl, "serving_qps")
            r.step(0.0)

        r = both(script, serving=lambda: FakeServing(size=4))
        assert r.acted == [[]] and r.ctl.suppressed.get("serving:up:at_max") == 1
        assert r.serving.calls == []

    def test_busy_holds_scale_up(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            r.step(0.0)

        r = both(script, serving=lambda: FakeServing(size=1, busy=True))
        assert r.acted == [[]] and r.ctl.suppressed.get("serving:up:busy") == 1

    def test_dry_run_is_inert(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            r.step(0.0)
            r.step(2.0)

        r = both(script, cfg_kw={"dry_run": True}, serving=lambda: FakeServing())
        assert [a["action"] for a in r.acted[0]] == ["scale_up"]
        assert r.acted[0][0]["dry_run"] is True
        assert r.serving.calls == [] and r.serving.size() == 1
        assert (r.ctl.decisions, r.ctl.actions) == (1, 0)
        assert r.acted[1] == [] and r.ctl.suppressed.get("serving:up:cooldown") == 1

    def test_both_fleet_independence(self):
        def script(r):
            breach(r.ctl, "age_p95_ms")
            r.step(0.0)
            breach(r.ctl, "serving_p99_ms")
            r.step(0.1)

        r = both(script, serving=lambda: FakeServing(size=1),
                                 actor=lambda: FakeActor(size=1, capacity=4))
        assert [a["fleet"] for a in r.acted[0]] == ["actor"]
        assert [a["fleet"] for a in r.acted[1]] == ["serving"]
        assert r.actor.size() == 2 and r.serving.size() == 2

    def test_actor_ceiling_degrades_pipeline_once(self):
        def script(r):
            breach(r.ctl, "age_p95_ms")
            r.step(0.0)
            r.step(10.0)

        r = both(script, actor=lambda: FakeActor(size=4, capacity=4))
        assert [a["action"] for a in r.acted[0]] == ["tune_pipeline"]
        assert all(a["action"] != "tune_pipeline" for a in r.acted[1])
        assert r.actor.pipeline_tunes == 1

    def test_ring_occupancy_ladder_tunes_drain_before_retiring(self):
        def script(r):
            breach(r.ctl, "ring_occupancy")
            for t in (0.0, 2.0, 4.0):
                r.step(t)

        r = both(script, cfg_kw={"drain_tune_max_factor": 4.0, "cooldown_down_s": 1.0,
                                 "hold_opposite_s": 0.0},
                 actor=lambda: FakeActor(size=3, capacity=4))
        assert [[a["action"] for a in acted] for acted in r.acted] \
            == [["tune_drain"], ["tune_drain"], ["scale_down"]]
        assert r.actor.drain_factor() == 4.0 and r.actor.size() == 2

    def test_flap_damping_hold_opposite(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            r.step(0.0)
            clear(r.ctl, "serving_p99_ms")
            for t in (1.0, 2.0, 3.0, 4.0, 21.0):
                r.step(t)

        r = both(script, cfg_kw={"cooldown_up_s": 1.0, "cooldown_down_s": 1.0,
                                 "hold_opposite_s": 20.0, "serving_idle_qps_per_replica": 5.0,
                                 "idle_window_s": 10.0},
                 rollup={"serving": {"replicas": 2, "qps": 0.5}},
                 serving=lambda: FakeServing(size=2))
        assert all(acted == [] for acted in r.acted[1:5])
        assert any(k == "serving:down:hold" for k in r.ctl.suppressed)
        assert [a["action"] for a in r.acted[5]] == ["scale_down"]
        assert r.acted[5][0]["rule"] == "serving_idle" and r.serving.size() == 2

    def test_idle_scale_down_needs_green_up_rules(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            for t in (0.0, 1.0, 2.0, 3.0):
                r.step(t)

        r = both(script, cfg_kw={"serving_idle_qps_per_replica": 5.0, "hold_opposite_s": 0.0,
                                 "idle_window_s": 10.0},
                 rollup={"serving": {"replicas": 2, "qps": 0.5}},
                 serving=lambda: FakeServing(size=2))
        assert "down" not in r.serving.calls

    def test_exhausted_actuator_is_suppression_not_crash(self):
        def script(r):
            breach(r.ctl, "serving_p99_ms")
            r.step(0.0)
            r.step(0.1)

        r = both(script, serving=lambda: FakeServing(size=2, exhausted=True))
        assert r.acted == [[], []]
        assert r.ctl.suppressed.get("serving:up:exhausted") == 2

    def test_unknown_rules_and_foreign_events_ignored(self):
        def script(r):
            r.ctl.on_slo_event("slo_breach", rule="endpoints_alive")
            r.ctl.on_slo_event("slo_breach", rule="no_such_rule")
            r.ctl.on_slo_event("worker_death", worker=3)
            r.step(0.0)

        r = both(script, serving=lambda: FakeServing(size=1))
        assert r.acted == [[]] and r.serving.calls == []

    def test_state_matches_doc_schema(self):
        from ape_x_dqn_tpu.analysis.metrics_doc import doc_section_keys

        doc = doc_section_keys("## Autopilot schema", os.path.join(REPO, "docs", "METRICS.md"))
        assert doc
        c = AutopilotController(make_cfg())
        c.attach_serving(FakeServing())
        c.attach_actor(FakeActor())
        state = c.state(now=0.0)
        assert set(doc) == set(state), set(doc) ^ set(state)
        for fleet in state["fleets"].values():
            assert {"size", "min", "max", "busy", "breaching", "last_action", "last_rule",
                    "cooldown_up_s", "cooldown_down_s"} == set(fleet)

    def test_a_long_mixed_stream_leaves_equal_trails(self):
        """Every branch in one stream: breaches and clears on each fleet's
        rules, the idle rule, cooldowns, holds, the drain ladder, the
        ceiling's pipeline tune and an exhausted serving fleet."""
        rng = np.random.default_rng(5)
        rules = ["age_p95_ms", "ring_occupancy_floor", "ring_occupancy", "serving_p99_ms",
                 "serving_qps", "inference_rtt_p99_ms", "endpoints_alive"]
        ops = [(str(rng.choice(["slo_breach", "slo_clear", "none"])), str(rng.choice(rules)))
               for _ in range(120)]

        def script(r):
            for i, (ev, rule) in enumerate(ops):
                if ev != "none":
                    r.ctl.on_slo_event(ev, rule=rule, value=float(i), bound=1.0)
                r.step(0.7 * i)

        r = both(script, cfg_kw={"cooldown_up_s": 2.0, "cooldown_down_s": 3.0,
                                 "hold_opposite_s": 4.0, "serving_idle_qps_per_replica": 1.0,
                                 "idle_window_s": 3.0, "serving_max_replicas": 3},
                 rollup={"serving": {"replicas": 2, "qps": 0.5, "window": {"qps": 0.2}}},
                 serving=lambda: FakeServing(size=2),
                         actor=lambda: FakeActor(size=2, capacity=3))
        kinds = {a["action"] for acted in r.acted for a in acted}
        assert {"scale_up", "scale_down", "tune_drain"} <= kinds
        assert r.ctl.decisions > 5 and r.ctl.suppressed


# -- the replay fleet's loop (tests/test_fleet.py TestReplayFleetControl) ---------


class _FakeReplayFleet:
    """ReplayServiceFleet's actuator surface, without processes."""

    def __init__(self, shards=2):
        self.num_shards = shards
        self.grown = self.retired = 0
        self._resharding = False

    def resharding(self):
        return self._resharding

    def grow(self, timeout=60.0):
        sid = self.num_shards
        self.num_shards += 1
        self.grown += 1
        return sid

    def retire(self, drain_grace_s=0.5, timeout=60.0):
        if self.num_shards <= 1:
            return None
        self.num_shards -= 1
        self.retired += 1
        return self.num_shards


class TestReplayFleetControl:
    def _run(self, pkg, rollup=None, **kw):
        mod, cfg_mod = PKGS[pkg]
        kw = {"enabled": True, "cooldown_up_s": 0.0, "cooldown_down_s": 0.0,
              "hold_opposite_s": 0.0, "replay_min_shards": 1, "replay_max_shards": 3, **kw}
        fleet = _FakeReplayFleet()
        ctl = mod.AutopilotController(cfg_mod.AutopilotConfig(**kw),
                                      rollup_fn=lambda: rollup or {})
        ctl.attach_replay(mod.ReplayFleetActuator(fleet))
        return ctl, fleet

    def _both(self, script, **kw):
        out = {}
        for pkg in PKGS:
            ctl, fleet = self._run(pkg, **kw)
            out[pkg] = (script(ctl, fleet), dict(ctl.suppressed), fleet.num_shards,
                        fleet.grown, fleet.retired)
        assert out["torch"] == out["jax"]
        return out["torch"]

    def test_add_qps_breach_grows_the_fleet(self):
        def script(ctl, fleet):
            ctl.on_slo_event("slo_breach", rule="replay_add_qps", value=900.0)
            return ctl.step(now=100.0)

        acted, _, shards, _, _ = self._both(script)
        assert [a["action"] for a in acted] == ["scale_up"]
        assert acted[0]["fleet"] == "replay" and shards == 3

    def test_grow_respects_max_and_busy(self):
        def script(ctl, fleet):
            ctl.on_slo_event("slo_breach", rule="replay_add_qps", value=900.0)
            first = ctl.step(now=100.0)
            fleet.num_shards = 1
            fleet._resharding = True
            return first, ctl.step(now=101.0)

        (first, second), suppressed, _, grown, _ = self._both(script, replay_max_shards=2)
        assert first == [] and second == [] and grown == 0
        assert suppressed.get("replay:up:at_max") == 1 and suppressed.get("replay:up:busy") == 1

    def test_idle_rule_retires_through_own_burn_window(self):
        def script(ctl, fleet):
            acted = [a for k in range(8) for a in ctl.step(now=100.0 + k)]
            later = [ctl.step(now=110.0 + k) for k in range(4)]
            return acted, later

        (acted, later), suppressed, shards, _, retired = self._both(
            script, replay_idle_add_qps_per_shard=5.0, idle_window_s=10.0,
            rollup={"replay": {"shards_alive": 2, "add_qps": 0.5}})
        assert [a["action"] for a in acted] == ["scale_down"]
        assert acted[0]["rule"] == "replay_idle" and retired == 1 and shards == 1
        assert later == [[]] * 4 and suppressed.get("replay:down:at_min", 0) >= 1

    def test_breach_vetoes_idle_scale_down(self):
        def script(ctl, fleet):
            ctl.on_slo_event("slo_breach", rule="replay_add_qps", value=900.0)
            return [a["action"] for k in range(8) for a in ctl.step(now=100.0 + k)]

        actions, _, _, _, retired = self._both(
            script, replay_idle_add_qps_per_shard=5.0, idle_window_s=10.0,
            rollup={"replay": {"shards_alive": 2, "add_qps": 0.5}})
        assert "scale_down" not in actions and retired == 0


# -- config: the 34 keys ------------------------------------------------------------

_OBS_KEYS = ("fleet_scrape_interval_s", "fleet_scrape_timeout_s", "fleet_port",
             "fleet_slo_age_p95_ms", "fleet_slo_inference_rtt_p99_ms",
             "fleet_slo_serving_p99_ms", "fleet_slo_serving_qps_min",
             "fleet_slo_ring_occupancy_low", "fleet_slo_ring_occupancy_high",
             "fleet_slo_replay_add_qps_high", "fleet_slo_endpoint_alive",
             "fleet_slo_window_s", "fleet_slo_burn_threshold", "fleet_slo_clear_threshold",
             "fleet_slo_min_samples", "timeline_dir", "timeline_max_bytes",
             "timeline_segment_bytes", "timeline_tail_keep_s")


def test_all_34_keys_load_with_jax_defaults():
    tobs, jobs = tconfig.ObsConfig(), jconfig.ObsConfig()
    assert {k: getattr(tobs, k) for k in _OBS_KEYS} == {k: getattr(jobs, k) for k in _OBS_KEYS}
    tap = dataclasses.asdict(tconfig.AutopilotConfig())
    assert tap == dataclasses.asdict(jconfig.AutopilotConfig()) and len(tap) == 15
    assert len(_OBS_KEYS) + len(tap) == 34
    assert dataclasses.asdict(tconfig.ApexConfig())["autopilot"] == tap
    assert not tconfig._NOT_PORTED and not tconfig._NOT_PORTED_SECTIONS
    with pytest.raises(ValueError, match="unknown config field: autopilot.bogus"):
        tconfig.apply_overrides(tconfig.ApexConfig(), ["autopilot.bogus=1"])


_SETS = [
    ("obs.fleet_port", "8080"), ("obs.fleet_port", "none"), ("obs.timeline_dir", "/x/tl"),
    ("obs.fleet_slo_endpoint_alive", "false"), ("obs.fleet_slo_min_samples", "5"),
    ("autopilot.enabled", "true"), ("autopilot.poll_s", "0.25"),
    ("autopilot.replay_max_shards", "6"),
]


@pytest.mark.parametrize("key,value", _SETS)
def test_overrides_coerce_like_jax(key, value):
    section, field = key.split(".")
    got = getattr(getattr(tconfig.load_config(None, [f"{key}={value}"]), section), field)
    want = getattr(getattr(jconfig.load_config(None, [f"{key}={value}"]), section), field)
    assert got == want and type(got) is type(want)


_BAD = [
    "obs.fleet_scrape_interval_s=0", "obs.fleet_scrape_timeout_s=0", "obs.fleet_port=70000",
    "obs.fleet_slo_age_p95_ms=-1", "obs.fleet_slo_inference_rtt_p99_ms=-1",
    "obs.fleet_slo_serving_p99_ms=-1", "obs.fleet_slo_serving_qps_min=-1",
    "obs.fleet_slo_ring_occupancy_low=-0.1", "obs.fleet_slo_ring_occupancy_high=1.5",
    "obs.fleet_slo_replay_add_qps_high=-1", "obs.fleet_slo_window_s=0",
    "obs.fleet_slo_burn_threshold=0.05", "obs.fleet_slo_clear_threshold=0.9",
    "obs.fleet_slo_min_samples=0", "obs.timeline_segment_bytes=1024",
    "obs.timeline_max_bytes=4096", "obs.timeline_tail_keep_s=0",
    "autopilot.poll_s=0", "autopilot.actor_min_workers=0", "autopilot.serving_min_replicas=0",
    "autopilot.serving_max_replicas=0", "autopilot.cooldown_up_s=-1",
    "autopilot.cooldown_down_s=-1", "autopilot.hold_opposite_s=-1",
    "autopilot.serving_idle_qps_per_replica=-1", "autopilot.idle_window_s=0",
    "autopilot.drain_tune_max_factor=0.5", "autopilot.replay_min_shards=0",
    "autopilot.replay_max_shards=0", "autopilot.replay_idle_add_qps_per_shard=-1",
]


@pytest.mark.parametrize("override", _BAD)
def test_bad_values_fail_with_jax_messages(override):
    with pytest.raises(ValueError) as jerr:
        jconfig.load_config(None, [override])
    with pytest.raises(ValueError) as terr:
        tconfig.load_config(None, [override])
    assert str(terr.value) == str(jerr.value)


def test_native_json_loads_the_sections_like_jax(tmp_path):
    doc = {"obs": {"fleet_slo_age_p95_ms": 1500.0, "timeline_dir": "tl",
                   "fleet_slo_endpoint_alive": False},
           "autopilot": {"enabled": True, "dry_run": True, "cooldown_up_s": 3.0}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(doc))
    t, j = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert dataclasses.asdict(t.autopilot) == dataclasses.asdict(j.autopilot)
    assert {k: getattr(t.obs, k) for k in _OBS_KEYS} == {k: getattr(j.obs, k) for k in _OBS_KEYS}


# -- the actuators on real CPU processes ----------------------------------------------


@pytest.fixture
def two_cores():
    """Two usable cores: spawned children inherit them and take one
    intra-op thread each."""
    with pinned_cores(2):   # this xdist worker's own pair (_torch_harness)
        yield


def _pool_cfg(num_workers=1, max_workers=3, num_actors=6):
    cfg = tconfig.ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.mode = "process"
    cfg.actor.num_workers = num_workers
    cfg.actor.max_workers = max_workers
    cfg.actor.num_actors = num_actors
    cfg.actor.T = 100_000
    cfg.actor.flush_every = 8
    cfg.actor.respawn_min_interval_s = 0.05
    cfg.learner.min_replay_mem_size = 64
    cfg.replay.capacity = 4096
    return cfg.validate()


def _wait(cond, what, deadline, tick=None):
    while time.monotonic() < deadline:
        if tick is not None:
            tick()
        if cond():
            return
        if tick is None:
            time.sleep(0.05)
    raise TimeoutError(what)


class _Pipeline:
    """The surface ``tune_pipeline`` reads: ``depth`` and ``degrade``."""

    def __init__(self, depth):
        self.depth = depth

    def degrade(self):
        self.depth = 1


def test_actor_pool_actuator_grows_and_retires_real_workers(two_cores):
    """The controller's actor loop over the port's pool: a breach of
    ``age_p95_ms`` grows the reserved wid (1 → 2), the grown worker feeds
    its own slice; the drain ladder doubles the pool's budget up to the
    factor, then ``ring_occupancy`` retires the grown wid by a clean drain;
    at the ceiling the pipeline degrades once."""
    from ape_x_dqn_tpu_torch.autopilot import ActorPoolActuator
    from ape_x_dqn_tpu_torch.runtime.process_actors import (
        ProcessActorPool,
        network_and_template,
    )

    cfg = _pool_cfg(num_workers=1, max_workers=2, num_actors=4)
    pool = ProcessActorPool(cfg, num_workers=1, quantum=8)
    _, _, template = network_and_template(cfg)
    pipeline = _Pipeline(depth=2)
    act = ActorPoolActuator(pool, pipeline_fn=lambda: pipeline)
    events = []
    ctl = AutopilotController(make_cfg(cooldown_up_s=0.0, cooldown_down_s=0.0,
                                       hold_opposite_s=0.0, drain_tune_max_factor=4.0),
                              emit=lambda name, **f: events.append((name, f)))
    ctl.attach_actor(act)
    deadline = time.monotonic() + 150.0

    def drain():
        pool.supervise()
        pool.poll(max_items=64, timeout=0.05)

    try:
        pool.publish(template)
        pool.start()
        _wait(lambda: 0 in pool.last_versions, "wid 0 first chunk", deadline, drain)
        assert (act.size(), act.capacity(), act.busy()) == (1, 2, False)
        base = pool.drain_budget_bytes
        breach(ctl, "age_p95_ms")
        (up,) = ctl.step(now=0.0)
        assert (up["action"], up["size_from"], up["size_to"], up["detail"]) \
            == ("scale_up", 1, 2, {"wids": [1]})
        _wait(lambda: 1 in pool.last_versions, "grown wid 1 first chunk", deadline, drain)
        # At the ceiling: the pipeline degrades, once.
        (tune,) = ctl.step(now=1.0)
        assert tune["action"] == "tune_pipeline" and pipeline.depth == 1
        # The degrade is spent: the ceiling's tune has nothing left to move.
        assert ctl.step(now=2.0) == [] and ctl.suppressed.get("actor:up:exhausted") == 1
        clear(ctl, "age_p95_ms")
        breach(ctl, "ring_occupancy")
        ladder = [ctl.step(now=3.0 + k)[0] for k in range(3)]
        assert [a["action"] for a in ladder] == ["tune_drain", "tune_drain", "scale_down"]
        assert pool.drain_budget_bytes == 4 * base and act.drain_factor() == 4.0
        assert ladder[-1]["detail"] == {"wid": 1} and ladder[-1]["size_to"] == 1
        _wait(lambda: 1 in pool.finished_workers and 1 not in pool._rings,
              "retired wid 1 clean done and channel reclaimed", deadline, drain)
        assert pool.live_workers() == [0] and pool.retired == {1}
        assert not pool.worker_errors and pool.restarts == 0
        assert pool.transport_stats()["torn_records"] == 0
        assert [n for n, _ in events] == ["autopilot_action"] * 5
    finally:
        bounded_teardown(("pool.stop", pool.stop))


def test_serving_fleet_actuator_spawns_and_retires_a_cpu_replica(two_cores):
    """A 1-replica CPU ``ServingFleet``: a ``serving_p99_ms`` breach spawns
    replica 1 (busy while it boots: a second breach waits), the router then
    serves through both; the idle rule retires it on the drain path
    (``replica_retired_done``), never a kill."""
    from ape_x_dqn_tpu_torch.autopilot import ServingFleetActuator
    from ape_x_dqn_tpu_torch.config import apply_overrides
    from ape_x_dqn_tpu_torch.runtime.components import build_components
    from ape_x_dqn_tpu_torch.serving.net_server import ServingClient
    from ape_x_dqn_tpu_torch.serving.router import ServingFleet

    overrides = ["network=mlp", "env.name=chain:6", "serving.max_wait_ms=1.0",
                 "replay.capacity=1024", "learner.min_replay_mem_size=64"]
    comps = build_components(apply_overrides(tconfig.ApexConfig(), overrides), device="cpu")
    events, scaled = [], []
    fleet = ServingFleet(replicas=1, probe_interval_s=0.25,
                         replica_args=["--device", "cpu",
                                       *(a for ov in overrides for a in ("--set", ov))],
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         on_event=lambda kind, **f: events.append(kind))
    act = ServingFleetActuator(fleet, drain_grace_s=0.5,
                               on_scale=lambda kind, rid: scaled.append((kind, rid)))
    rollup = {"serving": {"replicas": 1, "qps": 50.0}}
    ctl = AutopilotController(make_cfg(cooldown_up_s=0.0, cooldown_down_s=0.0,
                                       hold_opposite_s=0.0, serving_max_replicas=2,
                                       serving_idle_qps_per_replica=5.0, idle_window_s=3.0),
                              rollup_fn=lambda: rollup)
    ctl.attach_serving(act)
    deadline = time.monotonic() + 240.0
    client = None
    try:
        fleet.publish(comps.state.params)
        fleet.start(timeout=180.0)
        assert (act.size(), act.busy()) == (1, False)
        breach(ctl, "serving_p99_ms")
        (up,) = ctl.step(now=0.0)
        assert (up["action"], up["size_from"], up["size_to"]) == ("scale_up", 1, 2)
        assert scaled == [("spawn", 1)] and act.busy()
        assert ctl.step(now=0.5) == [] and ctl.suppressed.get("serving:up:busy") == 1
        _wait(lambda: not fleet.booting(), "replica 1 in rotation", deadline)
        client = ServingClient("127.0.0.1", fleet.port)
        reply = client.act(np.zeros(comps.obs_shape, np.uint8), timeout=60.0)
        assert reply.param_version == 1
        clear(ctl, "serving_p99_ms")
        rollup["serving"] = {"replicas": 2, "qps": 0.0}
        acted = [a for k in range(1, 6) for a in ctl.step(now=1.0 + k)]
        assert [(a["action"], a["rule"], a["size_to"]) for a in acted] \
            == [("scale_down", "serving_idle", 1)]
        assert scaled[-1] == ("retire", 1) and fleet.active_replicas() == [0]
        _wait(lambda: "replica_retired_done" in events, "replica 1 reaped", deadline)
        assert fleet.respawns == 0 and fleet.retires == 1
        # The surviving replica still serves.
        assert client.act(np.zeros(comps.obs_shape, np.uint8), timeout=60.0) is not None
    finally:
        bounded_teardown(("client.close", client.close if client is not None else lambda: None),
                         ("fleet.stop", fleet.stop))
    assert all(not rep.alive() for rep in fleet.replicas.values())


def _chunk(n=16, seed=0):
    r = np.random.default_rng(seed)
    return {"prio": (np.abs(r.normal(size=n)) + 0.1).astype(np.float64),
            "obs": r.integers(0, 255, (n, 6), dtype=np.uint8),
            "action": r.integers(0, 2, n).astype(np.int32),
            "reward": r.normal(size=n).astype(np.float32),
            "discount": np.full(n, 0.99, np.float32),
            "next_obs": r.integers(0, 255, (n, 6), dtype=np.uint8)}


class _Batch:
    def __init__(self, arrays):
        for k, v in arrays.items():
            setattr(self, k, v)


def test_replay_fleet_actuator_reshards_2_3_2_through_the_rollup(tmp_path):
    """``tools/elastic_replay_smoke.py`` at a small size, on the port: a
    2-shard CPU fleet announcing to a registry, the aggregator adopting it
    from membership, the SLO engine's ``replay_add_qps`` rule and the
    controller's ``replay_idle`` rule on one virtual clock.  Ingest over the
    bound grows the fleet 2 → 3 (the client and the aggregator adopt the new
    shard); idle retires it 3 → 2 with ``reshard_done`` digest-proven and
    nothing lost; the client samples throughout."""
    from ape_x_dqn_tpu_torch.autopilot import ReplayFleetActuator
    from ape_x_dqn_tpu_torch.fleet.registry import FleetRegistry
    from ape_x_dqn_tpu_torch.obs.fleet import FleetAggregator, SloEngine, SloRule
    from ape_x_dqn_tpu_torch.obs.fleet import _replay_add_qps_per_shard
    from ape_x_dqn_tpu_torch.replay.service import ReplayServiceFleet, ShardedReplayClient

    reg = FleetRegistry(token=91).serve()
    events = []
    fleet = ReplayServiceFleet(2, 256, (6,), root_dir=str(tmp_path), token=reg.token,
                               registry_addr=(reg.host, reg.port), heartbeat_s=0.2,
                               save_every_s=0.2, auto_respawn=False,
                               on_event=lambda name, **f: events.append({"event": name, **f}))
    slo = SloEngine([SloRule("replay_add_qps", "upper", 40.0, _replay_add_qps_per_shard)],
                    window_s=2.0, burn_threshold=0.5, clear_threshold=0.25, min_samples=3)
    agg = FleetAggregator(scrape_timeout_s=5.0, window_s=2.0, slo=slo)
    ctl = AutopilotController(
        tconfig.AutopilotConfig(enabled=True, cooldown_up_s=2.0, cooldown_down_s=2.0,
                                hold_opposite_s=2.0, replay_min_shards=2, replay_max_shards=3,
                                replay_idle_add_qps_per_shard=4.0, idle_window_s=2.0),
        rollup_fn=agg.rollup)
    slo.subscribe(ctl.on_slo_event)
    ctl.attach_replay(ReplayFleetActuator(fleet))
    cl = None
    deadline = time.monotonic() + 240.0
    try:
        fleet.start(timeout=60.0)
        agg.bind_registry(reg)
        cl = ShardedReplayClient.from_registry(reg.host, reg.port, token=reg.token,
                                               probe_interval_s=0.2, wait_timeout_s=30.0)
        t = [0.0]
        acted = []

        def sweep(chunks):
            for i in range(chunks):
                a = _chunk(seed=int(t[0] * 10) + i)
                cl.add(a["prio"], _Batch(a))
            cl.sample(8)
            t[0] += 0.5
            agg.scrape_once(now=t[0])
            acted.extend(ctl.step(now=t[0]))

        while not acted and time.monotonic() < deadline:
            sweep(4)                      # 64 adds per 0.5 s: 64/s per shard
        assert [(a["action"], a["rule"], a["size_from"], a["size_to"]) for a in acted] \
            == [("scale_up", "replay_add_qps", 2, 3)]
        _wait(lambda: cl.num_shards == 3 and "replay_shard2" in agg._eps,
              "the client and the aggregator adopt shard 2", deadline,
              tick=lambda: (agg.adopt_membership(reg.snapshot()), time.sleep(0.05)))
        for _ in range(4):
            sweep(2)                      # shard 2 holds real data
        while len(acted) < 2 and time.monotonic() < deadline:
            sweep(0)
        assert [(a["action"], a["rule"], a["size_to"]) for a in acted[1:]] \
            == [("scale_down", "replay_idle", 2)]
        done = [e for e in events if e["event"] == "reshard_done" and e["kind"] == "retire"]
        assert done and done[0]["digest_ok"] is True and done[0]["lost"] == 0
        assert done[0]["transferred"] > 0
        _wait(lambda: cl.num_shards == 2, "the client adopts the retire", deadline)
        assert len(cl.sample(8).indices) == 8
        rollup = agg.scrape_once(now=t[0] + 0.5)
        assert rollup["replay"]["shards_alive"] == 2 and "replay_shard2" not in agg._eps
        assert ctl.state()["fleets"]["replay"]["size"] == 2
    finally:
        bounded_teardown(("client.close", cl.close if cl is not None else lambda: None),
                         ("agg.close", agg.close), ("fleet.stop", fleet.stop),
                         ("reg.close", reg.close))


# -- the slice: the autopilot drill on a CPU AsyncPipeline ---------------------------

# chip_smoke.autopilot_drill at CPU size: chain:6 with the mlp, 2 workers x
# 2 actors whose env steps sleep 10 ms on average, a 200-slot ring.
_DRILL_CPU = ["network=mlp", "env.name=chain:6", "seed=7", "chaos.env_latency_ms=10",
              "replay.capacity=200", "learner.min_replay_mem_size=100",
              "actor.flush_every=8", "actor.sync_every=32"]


def test_autopilot_drill_on_a_cpu_pipeline(two_cores, tmp_path):
    """As on the card: a calibrating run measures the windowed age p95 at
    two live workers and at one, and the drill's bound is their geometric
    mean.  Then green for a window with 0 decisions; wid 1 SIGKILLed
    through its respawn into quarantine; ``slo_breach`` on ``age_p95_ms``,
    one ``scale_up`` of the actor fleet from 1 to 2 onto the reserved wid,
    then ``slo_clear``; the timeline read back whole, its windowed p95
    equal to the live rollup's; ``/varz`` and the JSONL's ``autopilot``
    section; no sampler launch, every worker gone, no /dev/shm left (the
    drill's own gates raise; these are the numbers it returns)."""
    import torch

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # A full window of samples before any transition: under load the
    # workers start slowly and the first samples' age runs high until the
    # ring has turned over (the card's drill keeps the JAX drill's 4).
    kw = dict(window_s=3.0, scrape_s=0.25, min_samples=12, root=str(tmp_path / "drill"),
              wait_s=120.0)
    try:
        cal = chip_smoke.autopilot_drill("cpu", _DRILL_CPU, age_bound_ms=1e9,
                                         calibrate=True, **kw)
        bound = (cal["age_p95_ms_two_workers"] * cal["age_p95_ms_one_worker"]) ** 0.5
        assert cal["age_p95_ms_one_worker"] > cal["age_p95_ms_two_workers"]
        assert cal["green_decisions"] == 0 and cal["sampler_launches"] == 0
        r = chip_smoke.autopilot_drill("cpu", _DRILL_CPU, age_bound_ms=bound, **kw)
    finally:
        torch.set_num_threads(threads)
    assert r["green_decisions"] == 0 and r["sampler_launches"] == 0
    assert r["action"] == {"fleet": "actor", "action": "scale_up", "rule": "age_p95_ms",
                           "size_from": 1, "size_to": 2, "detail": {"wids": [2]}}
    assert r["age_p95_ms_two_workers"] < bound < r["age_p95_ms_one_worker"]
    assert r["age_p95_ms_after_grow"] < bound
    assert r["kill_to_quarantine"] < r["kill_to_breach"] <= r["kill_to_action"] \
        < r["kill_to_clear"]
    assert abs(r["timeline"]["records"] - r["sweeps"]) <= 1 and r["timeline"]["torn"] == 0
    assert round(r["timeline"]["window_p95_s_disk"], 4) == r["timeline"]["window_p95_s_live"]
    ap = r["autopilot"]
    assert ap["enabled"] and ap["actions"] == ap["decisions"] == 1
    assert (ap["fleets"]["actor"]["last_action"], ap["fleets"]["actor"]["last_rule"]) \
        == ("scale_up", "age_p95_ms")
