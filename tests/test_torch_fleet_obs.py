"""The fleet aggregator and the SLO engine against the JAX package.

Twins of ``tests/test_fleet_obs.py`` and of the aggregator cases of
``tests/test_fleet.py`` (the same-mtime endpoints rewrite, membership
adoption).  Where the logic is pure, each case runs both packages on the
same inputs with ``now`` injected and requires the same event stream and
status (``seq``, ``pid`` and time stamps left out), then the oracle's own
assertions on the port.  The interop cases scrape the other package's
trainer ``/varz``, shards (stats RPC) and replicas, and render the port's
rollup with ``tools/obs_top.py --fleet``.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import ape_x_dqn_tpu.obs.fleet as jfleet
import ape_x_dqn_tpu_torch.obs.fleet as tfleet
from ape_x_dqn_tpu.config import ApexConfig as JApexConfig
from ape_x_dqn_tpu_torch.config import ApexConfig
from ape_x_dqn_tpu_torch.obs.fleet import (
    FleetAggregator,
    SloEngine,
    SloRule,
    _endpoints_down,
    rules_from_config,
)
from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

from _torch_harness import port_deadline, readline_within  # noqa: F401 — port_deadline is autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = (6,)
PKGS = {"jax": jfleet, "torch": tfleet}
STAMPS = ("seq", "pid")


def _strip(events):
    return [(n, {k: v for k, v in f.items() if k not in STAMPS}) for n, f in events]


def _both(scenario):
    """Run ``scenario(fleet_module)`` on both packages; require equal
    results and return the port's."""
    out = {name: scenario(mod) for name, mod in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _doc_keys(section_header):
    from ape_x_dqn_tpu.analysis.metrics_doc import doc_section_keys

    return doc_section_keys(section_header, os.path.join(REPO, "docs", "METRICS.md"))


# -- the SLO engine -------------------------------------------------------------


def _engine(mod, emit_list, *, bound=100.0, kind="upper", window_s=10.0, burn=0.5,
            clear=0.1, min_samples=3):
    return mod.SloEngine(
        [mod.SloRule("r", kind, bound, lambda r: r.get("v"))],
        window_s=window_s, burn_threshold=burn, clear_threshold=clear,
        min_samples=min_samples, emit=lambda name, **f: emit_list.append((name, f)))


def _drive(mod, values, step=1.0, **kw):
    """Feed ``values`` (None = an empty rollup) one sweep per ``step``
    seconds; return (events, status, state per sweep)."""
    events = []
    eng = _engine(mod, events, **kw)
    states = []
    for i, v in enumerate(values):
        eng.evaluate({} if v is None else {"v": v}, now=i * step)
        states.append(eng.rules[0].state)
    return _strip(events), eng.status(), states


class TestSloEngine:
    def test_single_bad_sample_is_not_a_breach(self):
        events, _, states = _both(lambda m: _drive(m, [500.0, 50.0], min_samples=3))
        assert states[-1] == "ok" and not events

    def test_breach_fires_at_burn_threshold_then_clears(self):
        events, status, states = _both(lambda m: _drive(m, [500.0] * 4 + [10.0] * 20))
        assert states[3] == "breach" and states[-1] == "ok"
        assert [e[0] for e in events] == ["slo_breach", "slo_clear"]
        ev = events[0][1]
        assert ev["rule"] == "r" and ev["bound"] == 100.0 and ev["burn"] >= 0.5
        assert status["breaches"] == status["clears"] == 1

    def test_burn_window_expires_old_samples(self):
        def scenario(m):
            events = []
            eng = _engine(m, events, window_s=5.0)
            for t, v in ((0.0, 500.0), (1.0, 500.0), (10.0, 10.0), (11.0, 10.0),
                         (12.0, 10.0)):
                eng.evaluate({"v": v}, now=t)
            return events, eng.rules[0].state, eng.status()

        events, state, _ = _both(scenario)
        assert state == "ok" and not events

    def test_flapping_is_damped_by_hysteresis(self):
        values = [500.0 if i % 2 else 10.0 for i in range(60)]
        events, _, _ = _both(lambda m: _drive(m, values, burn=0.8, clear=0.2))
        assert len(events) <= 1

    def test_lower_bound_rule_and_none_skips(self):
        def scenario(m):
            events = []
            eng = m.SloEngine([m.SloRule("qps", "lower", 10.0, lambda r: r.get("qps"))],
                              window_s=10.0, burn_threshold=0.5, clear_threshold=0.1,
                              min_samples=2, emit=lambda n, **f: events.append((n, f)))
            t = 0.0
            for _ in range(4):
                eng.evaluate({}, now=t)
                t += 1.0
            quiet = (eng.rules[0].state, len(eng.rules[0]._window), list(events))
            for _ in range(3):
                eng.evaluate({"qps": 2.0}, now=t)
                t += 1.0
            return quiet, eng.rules[0].state, _strip(events), eng.status()

        quiet, state, events, _ = _both(scenario)
        assert quiet == ("ok", 0, [])
        assert state == "breach" and events[0][1]["kind"] == "lower"

    def test_threshold_ordering_validated(self):
        for m in PKGS.values():
            with pytest.raises(ValueError, match="0 <= clear <= burn <= 1"):
                m.SloEngine([], burn_threshold=0.2, clear_threshold=0.5)

    def test_rules_from_config_defaults_and_knobs(self):
        def names(cfg_cls, mod, knobs):
            cfg = cfg_cls()
            for k, v in knobs.items():
                setattr(cfg.obs, k, v)
            cfg.validate()
            return [(r.name, r.kind, r.bound) for r in mod.rules_from_config(cfg.obs)]

        assert {r[0] for r in names(ApexConfig, tfleet, {})} == {"endpoints_alive"}
        knobs = {"fleet_slo_age_p95_ms": 2000.0, "fleet_slo_serving_p99_ms": 50.0,
                 "fleet_slo_serving_qps_min": 5.0, "fleet_slo_ring_occupancy_high": 0.9,
                 "fleet_slo_inference_rtt_p99_ms": 100.0,
                 "fleet_slo_ring_occupancy_low": 0.1, "fleet_slo_replay_add_qps_high": 50.0}
        port = names(ApexConfig, tfleet, knobs)
        assert port == names(JApexConfig, jfleet, knobs)
        assert {r[0] for r in port} == {
            "endpoints_alive", "age_p95_ms", "serving_p99_ms", "serving_qps",
            "ring_occupancy", "ring_occupancy_floor", "inference_rtt_p99_ms",
            "replay_add_qps"}

    def test_config_validation_rejects_bad_bands(self):
        for cls in (ApexConfig, JApexConfig):
            cfg = cls()
            cfg.obs.fleet_slo_clear_threshold = 0.9
            with pytest.raises(ValueError, match="clear"):
                cfg.validate()
            cfg = cls()
            cfg.obs.fleet_slo_ring_occupancy_low = 0.8
            cfg.obs.fleet_slo_ring_occupancy_high = 0.5
            with pytest.raises(ValueError, match="occupancy"):
                cfg.validate()

    def test_rule_vocabulary_matches_jax_on_the_same_rollups(self):
        rollups = [
            {},
            {"age_of_experience": {"count": 3, "p95_s": 1.25,
                                   "window": {"count": 2, "p95_s": 0.5}}},
            {"age_of_experience": {"count": 3, "p95_s": 1.25, "window": {"count": 0}}},
            {"inference": {"rtt_p99_ms_max": 7.5}},
            {"serving": {"replicas": 2, "qps": 3.0, "count": 4, "p99_ms": 9.0,
                         "window": {"count": 1, "p99_ms": 2.0}}},
            {"serving": {"replicas": 0, "count": 0}},
            {"ring_occupancy_max": 0.75},
            {"replay": {"shards_alive": 2, "add_qps": 90.0}},
            {"replay": {"shards_alive": 0, "add_qps": 90.0}},
            {"endpoints": {"a": {"alive": True}, "b": {"alive": False}}},
        ]
        fns = ("_age_p95_ms", "_inference_rtt_p99_ms", "_serving_p99_ms", "_serving_qps",
               "_ring_occupancy", "_replay_add_qps_per_shard", "_endpoints_down")
        _both(lambda m: [[getattr(m, f)(r) for f in fns] for r in rollups])


# -- the aggregator: merge, liveness, schema ------------------------------------


def _fake_trainer_varz(age_values=(0.5, 1.0, 2.0), spans=(), jax=False):
    """A registry shaped like a trainer's /varz, served over HTTP by either
    package's exporter."""
    if jax:
        from ape_x_dqn_tpu.obs.exporter import ObsServer
        from ape_x_dqn_tpu.obs.registry import MetricsRegistry
        from ape_x_dqn_tpu.utils.metrics import LatencyHistogram as Hist
    else:
        from ape_x_dqn_tpu_torch.obs.exporter import ObsServer
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry
        Hist = LatencyHistogram

    reg = MetricsRegistry()
    h = Hist(min_s=1e-3, max_s=7200.0, per_decade=10)
    for v in age_values:
        h.record(v)
    reg.register_provider("lineage", lambda: {
        "age_at_sample": {"count": h.count, "buckets_s": h.buckets()}})
    reg.register_provider("trace_spans", lambda: {"recorded": len(spans),
                                                  "spans": list(spans)})
    reg.register_provider("learner", lambda: {"step": 7, "steps_per_sec": 3.0})
    return ObsServer(reg), h


@pytest.fixture
def shard():
    from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
    from ape_x_dqn_tpu_torch.replay.service import ReplayShardServer

    rep = PrioritizedReplay(256, OBS)
    srv = ReplayShardServer(rep, 0, token=5, codec="off").start()
    yield rep, srv
    srv.close()


def _endpoints_file(tmp_path, srv, sid=0, name="endpoints.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump({"token": srv.token, "codec": "off", "total_capacity": 256,
                   "shards": [{"id": sid, "host": "127.0.0.1", "port": srv.port,
                               "base": 0, "capacity": 256,
                               "incarnation": srv.incarnation}]}, f)
    return path


class TestFleetAggregator:
    def test_rollup_merges_and_marks_dead_endpoint(self, shard, tmp_path):
        rep, srv = shard
        t1, h1 = _fake_trainer_varz(age_values=(0.5, 1.0))
        t2, h2 = _fake_trainer_varz(age_values=(2.0, 4.0, 8.0))
        events = []
        agg = FleetAggregator(
            slo=SloEngine([SloRule("endpoints_alive", "upper", 0.0, _endpoints_down)],
                          window_s=60.0, min_samples=2),
            emit=lambda name, **f: events.append((name, f)))
        try:
            agg.add_varz("trainer_a", t1.url)
            agg.add_varz("trainer_b", t2.url)
            agg.add_varz("dead", "http://127.0.0.1:1/varz", kind="replica")
            agg.watch_replay_endpoints(_endpoints_file(tmp_path, srv))
            for i in range(3):
                rollup = agg.scrape_once(now=float(i))
            eps = rollup["endpoints"]
            assert set(eps) == {"trainer_a", "trainer_b", "dead", "replay_shard0"}
            assert eps["trainer_a"]["alive"] and eps["replay_shard0"]["alive"]
            assert not eps["dead"]["alive"] and eps["dead"]["scrape_failures"] == 3
            assert rollup["alive"] == 3 and rollup["expected"] == 4
            age = rollup["age_of_experience"]
            assert age["count"] == 5
            ref = LatencyHistogram(min_s=1e-3, max_s=7200.0, per_decade=10)
            ref.merge(h1)
            ref.merge(h2)
            assert age["buckets_s"] == ref.buckets()
            assert rollup["replay"]["shards_alive"] == 1
            assert rollup["replay"]["requests"] >= 1
            assert [e[0] for e in events] == ["slo_breach"]
        finally:
            agg.close()
            t1.close()
            t2.close()

    def test_rollup_serves_and_never_503s_on_member_death(self):
        t1, _h = _fake_trainer_varz()
        agg = FleetAggregator()
        try:
            agg.add_varz("trainer", t1.url)
            agg.add_varz("dead", "http://127.0.0.1:1/varz")
            agg.scrape_once(now=0.0)
            obs = agg.serve(port=0)
            snap = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{obs.port}/varz", timeout=5.0))
            assert "fleet" in snap and "slo" in snap
            assert not snap["fleet"]["endpoints"]["dead"]["alive"]
            with urllib.request.urlopen(f"http://127.0.0.1:{obs.port}/healthz",
                                        timeout=5.0) as r:
                assert r.status == 200
            prom = urllib.request.urlopen(f"http://127.0.0.1:{obs.port}/metrics",
                                          timeout=5.0).read().decode()
            assert "apex_fleet_scrape_failures" in prom
        finally:
            agg.close()
            t1.close()

    def test_fleet_and_slo_sections_match_doc(self):
        t1, _h = _fake_trainer_varz()
        agg = FleetAggregator()
        try:
            agg.add_varz("trainer", t1.url)
            rollup = agg.scrape_once(now=0.0)
        finally:
            agg.close()
            t1.close()
        doc = _doc_keys("## Fleet rollup schema")
        assert doc and set(doc) == set(rollup), set(doc) ^ set(rollup)
        slo_doc = _doc_keys("## SLO schema")
        status = SloEngine([SloRule("x", "upper", 1.0, lambda r: 0.0)]).status()
        assert slo_doc and set(slo_doc) == set(status), set(slo_doc) ^ set(status)

    def test_timeline_assembly_requires_two_pids(self):
        spans = [
            {"trace_id": 9, "hop": "act", "pid": 1, "t0_s": 1.0, "t1_s": 1.0,
             "dur_ms": 0.0},
            {"trace_id": 9, "hop": "rsvc.add", "pid": 2, "t0_s": 1.1, "t1_s": 1.3,
             "dur_ms": 200.0},
            {"trace_id": 8, "hop": "rsvc.add.client", "pid": 3, "t0_s": 2.0,
             "t1_s": 2.1, "dur_ms": 100.0},
        ]

        def scenario(m):
            agg = m.FleetAggregator()
            agg._fold_traces([dict(s) for s in spans])
            return agg._timelines()

        tl = _both(scenario)
        assert [t["trace_id"] for t in tl] == [9]
        assert tl[0]["pids"] == [1, 2] and tl[0]["hops"] == ["act", "rsvc.add"]


def _snapshots():
    """Fixed endpoint snapshots covering every branch of ``_merge``: a
    trainer (lineage, inference, ring backlog, autopilot, trace spans), a
    replica (latency, versions, exemplars, replies) and two shards."""
    def hist(values):
        h = LatencyHistogram(min_s=1e-3, max_s=7200.0, per_decade=10)
        for v in values:
            h.record(v)
        return h.buckets()

    trainer = {
        "lineage": {"age_at_sample": {"count": 4, "buckets_s": hist((0.1, 0.2, 0.4, 3.0))}},
        "inference": {"rtt": {"count": 5, "p99_ms": 4.5}, "stall_ms": 2.25, "replies": 40,
                      "rtt_exemplars": {"0.01": 77}},
        "xp_transport": {"ring_bytes": 1000},
        "workers": {"0": {"ring_backlog_bytes": 250}, "1": {"ring_backlog_bytes": 600}},
        "autopilot": {"enabled": True, "decisions": 0},
        "learner": {"step": 11, "steps_per_sec": 2.0},
        "trace_spans": {"spans": [{"trace_id": 5, "hop": "learner.sample", "pid": 100,
                                   "t0_s": 1.0, "t1_s": 1.1}]},
    }

    def replica(n):
        return {"serving_net": {
            "latency_buckets": hist((0.002, 0.004, 0.05)[:n]),
            "latency": {"count": n, "p95_ms": 4.0},
            "latency_exemplars": {"0.00398107": 900 + n},
            "by_version": {"3": {"replies": n, "latency_buckets": hist((0.002,) * n)}},
            "replies": 10 * n, "requests": 10 * n,
            "recent_spans": {"spans": [{"trace_id": 5, "hop": "serve.infer", "pid": 200,
                                        "t0_s": 1.05, "t1_s": 1.2}]}}}

    def shard(sid, added):
        return {"op_ms": {"buckets": hist((0.001, 0.003)), "p95_ms": 3.0,
                          "exemplars": {"0.001": 50 + sid}},
                "requests": 3, "replies": 3, "size": added, "capacity": 256,
                "total_added": added, "incarnation": 0, "port": 9000 + sid}

    return trainer, replica, shard


def _rollups(mod, sweeps=3):
    trainer, replica, shard = _snapshots()
    agg = mod.FleetAggregator(window_s=10.0)
    try:
        agg.add_local("trainer", lambda: trainer, kind="trainer")
        agg.add_local("replica0", lambda: replica(agg.sweeps + 1), kind="replica")
        agg.add_local("replay_shard0", lambda: shard(0, 40 * (agg.sweeps + 1)), kind="shard")
        agg.add_local("replay_shard1", lambda: shard(1, 25 * (agg.sweeps + 1)), kind="shard")
        return [agg.scrape_once(now=100.0 + 2.0 * i) for i in range(sweeps)]
    finally:
        agg.close()


def test_rollup_equals_jax_over_the_same_snapshots():
    rollups = _both(_rollups)
    last = rollups[-1]
    assert last["replay"]["shards_alive"] == 2 and last["replay"]["add_qps"] == 32.5
    assert last["replay"]["total_added"] == 40 * 3 + 25 * 3
    assert last["ring_occupancy_max"] == 0.6 and last["autopilot"]["enabled"]
    assert last["serving"]["replicas"] == 1 and last["serving"]["by_version"]["3"]["replies"] == 3
    assert [t["trace_id"] for t in last["traces"]] == [5]


def test_dead_endpoint_marks_only_itself_down():
    def scenario(m):
        trainer, replica, shard = _snapshots()

        def dead():
            raise ConnectionRefusedError("gone")

        agg = m.FleetAggregator()
        try:
            agg.add_local("trainer", lambda: trainer)
            agg.add_local("replica0", lambda: replica(1), kind="replica")
            agg.add_local("replay_shard0", lambda: shard(0, 5), kind="shard")
            agg.add_local("replay_shard1", dead, kind="shard")
            roll = agg.scrape_once(now=1.0)
        finally:
            agg.close()
        return {n: (e["alive"], e["scrape_failures"], e["last_error"])
                for n, e in roll["endpoints"].items()}, roll["replay"]["shards_alive"]

    eps, shards_alive = _both(scenario)
    assert [n for n, e in eps.items() if not e[0]] == ["replay_shard1"]
    assert eps["replay_shard1"][2] == "ConnectionRefusedError: gone" and shards_alive == 1


# -- the aggregator cases of tests/test_fleet.py ---------------------------------


class TestEndpointsDigestRegression:
    def _write(self, path, port, mtime=None):
        doc = {"token": 5, "codec": "off", "total_capacity": 64,
               "shards": [{"id": 0, "host": "127.0.0.1", "port": port, "base": 0,
                           "capacity": 64, "incarnation": 2}]}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        if mtime is not None:
            os.utime(path, (mtime, mtime))

    def test_aggregator_refresh_survives_same_mtime_rewrite(self, tmp_path):
        path = str(tmp_path / "endpoints.json")
        self._write(path, port=1111, mtime=1000.0)
        agg = FleetAggregator(scrape_interval_s=60.0)
        agg.watch_replay_endpoints(path)
        assert agg._eps["replay_shard0"].shard_spec["port"] == 1111
        self._write(path, port=2222, mtime=1000.0)
        agg._refresh_replay_files()
        assert agg._eps["replay_shard0"].shard_spec["port"] == 2222
        assert agg._eps["replay_shard0"].shard_spec["incarnation"] == 2


class TestAggregatorMembershipAdoption:
    def _snapshot(self, members, version=1):
        return {"token": 5, "version": version, "incarnation": 1,
                "members": {d["name"]: d for d in members}}

    def test_members_become_endpoints_and_departures_drop(self):
        from ape_x_dqn_tpu_torch.fleet.registry import member_doc

        def scenario(m):
            agg = m.FleetAggregator(scrape_interval_s=60.0)
            shard = member_doc("replay/shard0", "replay_shard", host="127.0.0.1",
                               port=7001, base=0, capacity=64, incarnation=1)
            replica = member_doc("serving/replica0", "serving_replica", port=8001,
                                 varz_url="http://127.0.0.1:1/varz")
            agg.adopt_membership(self._snapshot([shard, replica], version=2))
            first = ({n: (e.kind, e.url, e.shard_spec) for n, e in agg._eps.items()},
                     dict(agg._membership))
            agg.adopt_membership(self._snapshot([shard], version=3))
            return first, sorted(agg._eps), dict(agg._membership)

        (eps, mem), after, mem2 = _both(scenario)
        assert eps["replay_shard0"][2]["port"] == 7001
        assert eps["serving/replica0"][0] == "replica"
        assert mem["version"] == 2 and mem["members"] == 2
        assert mem["by_kind"] == {"replay_shard": 1, "serving_replica": 1}
        assert after == ["replay_shard0"] and mem2["adopts"] == 2

    def test_draining_surfaced_in_membership_rollup(self):
        from ape_x_dqn_tpu_torch.fleet.registry import member_doc

        agg = FleetAggregator(scrape_interval_s=60.0)
        shard = member_doc("replay/shard1", "replay_shard", host="127.0.0.1", port=7002,
                           base=64, capacity=64, draining=True)
        agg.adopt_membership(self._snapshot([shard]))
        assert agg._membership["draining"] == ["replay/shard1"]
        assert agg._eps["replay_shard1"].shard_spec["id"] == 1

    def test_bind_registry_adopts_in_process(self):
        from ape_x_dqn_tpu_torch.fleet.registry import FleetRegistry, member_doc

        reg = FleetRegistry(token=11, ttl_s=60.0)
        reg._apply("join", member_doc("replay/shard0", "replay_shard", host="127.0.0.1",
                                      port=7003, capacity=64))
        agg = FleetAggregator(scrape_interval_s=60.0, scrape_timeout_s=0.5)
        try:
            agg.bind_registry(reg)
            assert agg._eps["replay_shard0"].shard_spec["token"] == 11
            rollup = agg.scrape_once(now=time.monotonic())
            assert rollup["membership"]["members"] == 1
            # The member left: the next sweep forgets its endpoint.
            reg._apply("leave", {"name": "replay/shard0"})
            rollup = agg.scrape_once(now=time.monotonic())
            assert "replay_shard0" not in rollup["endpoints"]
        finally:
            agg.close()


# -- wire pins (the port's planes, as the JAX oracle pins its own) --------------


class TestTraceWire:
    def test_serve_hello_flags_off_is_preflags_bytes(self):
        from ape_x_dqn_tpu_torch.runtime.net import (
            SERVE_HELLO,
            SERVE_MAGIC,
            SERVE_VERSION_EXT,
            serve_hello_ext_bytes,
        )

        legacy = SERVE_HELLO.pack(SERVE_MAGIC, SERVE_VERSION_EXT) \
            + struct.Struct("<qqqB7x").pack(3, 2, 99, 1)
        assert serve_hello_ext_bytes(3, 2, 99, 1) == legacy

    def test_rsvc_hello_flags_off_is_preflags_bytes(self):
        from ape_x_dqn_tpu_torch.replay.service import RSVC_HELLO, RSVC_MAGIC, RSVC_VERSION

        legacy = struct.Struct("<4sIqqqqB7x").pack(RSVC_MAGIC, RSVC_VERSION, 9, 0, -1, 5, 0)
        assert RSVC_HELLO.pack(RSVC_MAGIC, RSVC_VERSION, 9, 0, -1, 5, 0, 0) == legacy

    def test_preflags_raw_client_still_served(self, shard):
        import socket

        from ape_x_dqn_tpu_torch.replay.service import (
            _RPC,
            OP_DIGEST,
            RSVC_ACK,
            RSVC_MAGIC,
            RSVC_VERSION,
        )
        from ape_x_dqn_tpu_torch.runtime.net import F_RREQ, FrameParser, frame_bytes

        rep, srv = shard
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
        try:
            s.sendall(struct.Struct("<4sIqqqqB7x").pack(RSVC_MAGIC, RSVC_VERSION, 9, 0, -1,
                                                         srv.token, 0))
            s.settimeout(5.0)
            ack = b""
            while len(ack) < RSVC_ACK.size:
                got = s.recv(RSVC_ACK.size - len(ack))
                assert got, "the shard closed before its ack"
                ack += got
            s.sendall(frame_bytes(F_RREQ, 1, [_RPC.pack(1, OP_DIGEST)]))
            parser = FrameParser()
            deadline = time.monotonic() + 5.0
            got = None
            while got is None and time.monotonic() < deadline:
                parser.feed(s.recv(1 << 16))
                got = parser.next()
            assert got is not None and srv.torn_frames == 0
        finally:
            s.close()

    def test_traced_payload_is_prefix_plus_legacy(self):
        from ape_x_dqn_tpu_torch.runtime.net import split_trace, wrap_trace

        body = b"legacy-request-bytes"
        wrapped = wrap_trace(1234, body)
        assert wrapped[8:] == body
        tid, rest = split_trace(wrapped)
        assert tid == 1234 and bytes(rest) == body
        with pytest.raises(ValueError):
            split_trace(b"short")

    def test_untraced_clients_record_no_spans(self, shard):
        from ape_x_dqn_tpu_torch.replay.service import ShardedReplayClient

        rep, srv = shard
        cl = ShardedReplayClient(
            [{"id": 0, "host": "127.0.0.1", "port": srv.port, "base": 0, "capacity": 256,
              "incarnation": srv.incarnation}],
            token=srv.token, codec="off", trace=False, request_timeout_s=5.0)
        try:
            arrays = _chunk()
            cl.add(arrays["prio"], _Batch(arrays), trace_id=999)
            assert cl.spans.snapshot()["spans"] == []
            assert srv.stats()["trace_spans"]["spans"] == []
        finally:
            cl.close()


def _chunk(n=8, seed=0):
    r = np.random.default_rng(seed)
    return {
        "prio": (np.abs(r.normal(size=n)) + 0.1).astype(np.float64),
        "obs": r.integers(0, 255, (n, *OBS), dtype=np.uint8),
        "action": r.integers(0, 2, n).astype(np.int32),
        "reward": r.normal(size=n).astype(np.float32),
        "discount": np.full(n, 0.99, np.float32),
        "next_obs": r.integers(0, 255, (n, *OBS), dtype=np.uint8),
    }


class _Batch:
    def __init__(self, arrays):
        for k, v in arrays.items():
            setattr(self, k, v)


# -- cross-tier traces, through the port's processes ----------------------------

_SERVING_CHILD = r"""
import concurrent.futures, json, os, sys
import numpy as np
from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer
from ape_x_dqn_tpu_torch.serving.batcher import ServedAction


class Stub:
    param_version = 3

    def submit(self, obs):
        f = concurrent.futures.Future()
        f.set_result(ServedAction(1, np.zeros(2, np.float32), 3, 0.0))
        return f


srv = ServingNetServer(Stub()).start()
print(json.dumps({"port": srv.port, "pid": os.getpid()}), flush=True)
sys.stdin.readline()
print(json.dumps(srv.stats()["recent_spans"]), flush=True)
srv.close()
"""


def _reap(procs):
    for p in procs:
        p.terminate()
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=5.0)
        for f in (p.stdout, p.stdin):
            if f is not None:
                f.close()


class TestCrossTierTraceE2E:
    def test_same_trace_id_in_three_pids_across_both_planes(self):
        """One trace id in spans of three processes (this one, a port shard
        CLI and a port replica) over both RPC planes, folded into one
        timeline by the port's aggregator."""
        from ape_x_dqn_tpu_torch.replay.service import ShardClient, ShardedReplayClient
        from ape_x_dqn_tpu_torch.serving.central import CentralInferenceClient

        env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
        tid = 0x7ACE
        shard_proc = subprocess.Popen(
            [sys.executable, "-m", "ape_x_dqn_tpu_torch.replay.service", "--shard-id", "0",
             "--capacity", "256", "--obs-shape", "6", "--token", "5", "--port", "0",
             "--codec", "off"],
            cwd=REPO, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        serve_proc = subprocess.Popen(
            [sys.executable, "-c", _SERVING_CHILD], cwd=REPO, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        cl = inf = None
        try:
            announce = json.loads(readline_within(shard_proc.stdout, 60.0, "the shard child"))
            assert announce["event"] == "replay_shard_listen"
            shard_pid, shard_port = announce["pid"], announce["port"]
            cl = ShardedReplayClient(
                [{"id": 0, "host": "127.0.0.1", "port": shard_port, "base": 0,
                  "capacity": 256, "incarnation": 0}],
                token=5, codec="off", trace=True, request_timeout_s=10.0)
            arrays = _chunk()
            cl.add(arrays["prio"], _Batch(arrays), trace_id=tid)
            batch = cl.sample(4)
            cl.tag_sample_span(tid)
            cl.update_priorities(batch.indices.astype(np.int64), np.ones(4), trace_id=tid)
            sc = ShardClient(0, "127.0.0.1", shard_port, token=5, client_id=42, codec="off")
            shard_stats = sc.shard_stats(timeout=10.0)
            sc.close()
            serving = json.loads(readline_within(serve_proc.stdout, 60.0, "the serving child"))
            inf = CentralInferenceClient("127.0.0.1", serving["port"], wid=1, trace=True)
            inf.select(np.zeros((2, 6), np.uint8), timeout_s=20.0, trace_id=tid)
            serve_proc.stdin.write(b"dump\n")
            serve_proc.stdin.flush()
            replica_spans = json.loads(readline_within(serve_proc.stdout, 60.0,
                                                       "the serving child's span dump"))
            spans = (cl.spans.snapshot()["spans"] + inf.spans.snapshot()["spans"]
                     + shard_stats["trace_spans"]["spans"] + replica_spans["spans"])
            ours = [s for s in spans if s["trace_id"] == tid]
            pids = {s["pid"] for s in ours}
            hops = {s["hop"] for s in ours}
            assert len(pids) >= 3, (pids, hops)
            assert {os.getpid(), shard_pid, serving["pid"]} <= pids
            assert {"rsvc.add.client", "rsvc.add"} <= hops
            assert "rsvc.update" in hops and "rsvc.sample.client" in hops
            assert {"inf.select.client", "serve.infer"} <= hops
            tls = {}
            for name, mod in PKGS.items():
                agg = mod.FleetAggregator()
                agg._fold_traces([dict(s) for s in ours])
                tls[name] = agg._timelines()
            assert tls["torch"] == tls["jax"]
            assert len(tls["torch"]) == 1 and tls["torch"][0]["trace_id"] == tid
            assert len(tls["torch"][0]["pids"]) >= 3
        finally:
            if cl is not None:
                cl.close()
            if inf is not None:
                inf.close()
            _reap((shard_proc, serve_proc))


class TestTraceThroughRouter:
    def test_traced_request_splices_intact_through_router(self):
        import concurrent.futures

        from ape_x_dqn_tpu_torch.serving.batcher import ServedAction
        from ape_x_dqn_tpu_torch.serving.net_server import ServingClient, ServingNetServer
        from ape_x_dqn_tpu_torch.serving.router import ServingRouter

        class _Stub:
            param_version = 1

            def submit(self, obs):
                f = concurrent.futures.Future()
                f.set_result(ServedAction(0, np.zeros(2, np.float32), 1, 0.0))
                return f

        srv = ServingNetServer(_Stub()).start()
        router = ServingRouter(port=0)
        router.set_endpoint(0, "127.0.0.1", srv.port)
        router.start()
        cl = ServingClient("127.0.0.1", router.port, trace=True)
        try:
            cl.act(np.zeros(OBS, np.uint8), timeout=15.0, trace_id=4321)
            deadline = time.monotonic() + 5.0
            spans = []
            while time.monotonic() < deadline and not spans:
                spans = [s for s in srv.stats()["recent_spans"]["spans"]
                         if s["trace_id"] == 4321]
                time.sleep(0.05)
            assert spans and spans[0]["hop"] == "serve.request"
            assert srv.stats()["torn_frames"] == 0
        finally:
            cl.close()
            router.close()
            srv.close()


class TestWorkerTraceSweep:
    def test_trace_chunk_events_lift_into_act_spans(self):
        from ape_x_dqn_tpu_torch.obs.shm_stats import WORKER_SLOTS, WorkerStatsBlock
        from ape_x_dqn_tpu_torch.runtime.process_actors import ProcessActorPool

        blk = WorkerStatsBlock(slots=WORKER_SLOTS)
        try:
            blk.record_event({"t": 12.5, "kind": "trace_chunk", "trace_id": 321, "rows": 8})
            blk.record_event({"t": 13.0, "kind": "trace_span", "trace_id": 321,
                              "hop": "inf.select.client", "pid": blk.pid, "t0_s": 12.9,
                              "t1_s": 13.0, "dur_ms": 100.0})
            blk.record_event({"t": 13.5, "kind": "error", "error": "x"})

            class _Fake:
                _stats_blocks = {3: blk}

            spans = ProcessActorPool.trace_events(_Fake())
            assert len(spans) == 2
            act = next(s for s in spans if s["hop"] == "act")
            assert act["trace_id"] == 321 and act["wid"] == 3 and act["pid"] == blk.pid
            assert any(s["hop"] == "inf.select.client" for s in spans)
        finally:
            blk.close()
            blk.unlink()


# -- interop: each package's aggregator over the other's endpoints --------------


def _replica_varz(jax: bool):
    """A replica's /varz: a net server's stats as the ``serving_net``
    provider, with a few replies recorded."""
    if jax:
        from ape_x_dqn_tpu.obs.exporter import ObsServer
        from ape_x_dqn_tpu.obs.registry import MetricsRegistry
        from ape_x_dqn_tpu.serving.net_server import ServingNetServer
    else:
        from ape_x_dqn_tpu_torch.obs.exporter import ObsServer
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry
        from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer

    srv = ServingNetServer(object())
    for v, dt in ((3, 0.001), (3, 0.002), (4, 0.01)):
        srv._record_reply(v, dt, trace_id=v)
    reg = MetricsRegistry()
    reg.register_provider("serving_net", srv.stats)
    return ObsServer(reg)


def _shard_server(jax: bool, sid: int, rows: int):
    if jax:
        from ape_x_dqn_tpu.replay.buffer import PrioritizedReplay
        from ape_x_dqn_tpu.replay.service import ReplayShardServer
    else:
        from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
        from ape_x_dqn_tpu_torch.replay.service import ReplayShardServer

    rep = PrioritizedReplay(256, OBS)
    a = _chunk(rows, seed=sid)
    rep.add(a["prio"], _Batch(a))
    return ReplayShardServer(rep, sid, token=5, codec="off").start()


def test_each_aggregator_scrapes_the_other_packages_endpoints(tmp_path):
    """Both packages' trainers, shards and replicas in one fleet; each
    package's aggregator scrapes all six (the port's shard client speaks to
    the JAX shard and the JAX client to the port's), and the rollups agree
    on everything but the shards' own request counters, which each scrape
    moves."""
    servers = []
    try:
        jt, _ = _fake_trainer_varz(age_values=(0.5, 1.0), jax=True)
        tt, _ = _fake_trainer_varz(age_values=(2.0, 4.0, 8.0))
        jr, tr = _replica_varz(True), _replica_varz(False)
        js, ts = _shard_server(True, 0, 12), _shard_server(False, 1, 20)
        servers = [jt, tt, jr, tr, js, ts]
        eps = str(tmp_path / "endpoints.json")
        with open(eps, "w") as f:
            json.dump({"token": 5, "codec": "off", "total_capacity": 512, "shards": [
                {"id": s.shard_id, "host": "127.0.0.1", "port": s.port,
                 "base": 256 * s.shard_id, "capacity": 256, "incarnation": s.incarnation}
                for s in (js, ts)]}, f)
        rollups = {}
        for name, mod in PKGS.items():
            agg = mod.FleetAggregator(scrape_timeout_s=5.0)
            try:
                agg.add_varz("trainer_jax", jt.url)
                agg.add_varz("trainer_torch", tt.url)
                agg.add_varz("replica_jax", jr.url, kind="replica")
                agg.add_varz("replica_torch", tr.url, kind="replica")
                agg.watch_replay_endpoints(eps)
                rollups[name] = [agg.scrape_once(now=10.0 + i) for i in range(2)][-1]
            finally:
                agg.close()
        moving = {"requests", "replies", "bytes_in", "bytes_out", "logical_bytes_in",
                  "op_buckets", "op_p95_ms", "op_exemplars"}
        for r in rollups.values():
            assert r["alive"] == r["expected"] == 6
            assert r["replay"]["shards_alive"] == 2 and r["replay"]["total_added"] == 32
            assert r["age_of_experience"]["count"] == 5 and r["serving"]["count"] == 6
            assert r["serving"]["replicas"] == 2
            assert r["serving"]["by_version"]["3"]["replies"] == 4
        j, t = rollups["jax"], rollups["torch"]
        for key in ("age_of_experience", "inference", "ring_occupancy_max", "alive",
                    "expected"):
            assert t[key] == j[key], key
        assert {k: v for k, v in t["serving"].items() if k != "qps"} \
            == {k: v for k, v in j["serving"].items() if k != "qps"}
        assert {k: v for k, v in t["replay"].items() if k not in moving} \
            == {k: v for k, v in j["replay"].items() if k not in moving}
    finally:
        for s in servers:
            s.close()


def test_obs_top_fleet_renders_the_ports_rollup_with_autopilot_row():
    from ape_x_dqn_tpu_torch.autopilot import AutopilotController
    from ape_x_dqn_tpu_torch.config import AutopilotConfig

    ctl = AutopilotController(AutopilotConfig(enabled=True))
    trainer, _, _ = _snapshots()
    replica = _replica_varz(False)
    agg = FleetAggregator()
    try:
        agg.add_local("trainer", lambda: {**trainer, "autopilot": ctl.state()})
        agg.add_varz("replica0", replica.url, kind="replica")
        agg.scrape_once()
        obs = agg.serve(port=0)
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "obs_top.py"), "--fleet",
             f"http://127.0.0.1:{obs.port}", "--once"],
            capture_output=True, text=True, timeout=60, cwd=REPO)
    finally:
        agg.close()
        replica.close()
    assert out.returncode == 0, out.stderr
    assert "-- autopilot" in out.stdout and "(0 actions, 0 decisions)" in out.stdout
    assert "no data" not in out.stdout and "replica0" in out.stdout
