"""The flight-data recorder against the JAX package.

Twins of ``tests/test_timeline.py``: the ``APXL`` framing, commit, adopt
and prune discipline, delta compaction that stays equal to the live
``_BucketWindow``, the SLO rebuild, the concurrent scrape plane, the
per-version serving split, the Prometheus spellings and ``tools/obs_diff``
over the port's timelines.  The same sweeps go into both packages' stores:
the records are equal but for ``wall``, each package reads the other's
segments, a writer SIGKILLed mid-append leaves a torn tail that both adopt,
and rotation, pruning and ``rebuild_slo`` agree.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import ape_x_dqn_tpu.obs.fleet as jfleet
import ape_x_dqn_tpu.obs.timeline as jtl
import ape_x_dqn_tpu_torch.obs.fleet as tfleet
import ape_x_dqn_tpu_torch.obs.timeline as ttl
from ape_x_dqn_tpu_torch.obs.fleet import (
    FleetAggregator,
    SloEngine,
    SloRule,
    _BucketWindow,
    _endpoints_down,
)
from ape_x_dqn_tpu_torch.obs.timeline import TimelineStore, read_segment, read_timeline
from ape_x_dqn_tpu_torch.runtime.net import TIMELINE_MAGIC
from ape_x_dqn_tpu_torch.utils.metrics import bucket_percentile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jtl, jfleet), "torch": (ttl, tfleet)}


def _doc_keys(section_header):
    from ape_x_dqn_tpu.analysis.metrics_doc import doc_section_keys

    return doc_section_keys(section_header, os.path.join(REPO, "docs", "METRICS.md"))


def _rollup(i, *, buckets=None, alive=5, down=0):
    """A minimal fleet rollup for sweep ``i`` with cumulative counters."""
    buckets = buckets if buckets is not None else {"0.001": 3 * (i + 1), "0.01": i + 1}
    return {
        "alive": alive, "expected": alive + down,
        "endpoints": {f"ep{j}": {"alive": j >= down} for j in range(alive + down)},
        "scrapes": 5 * (i + 1), "scrape_failures": down * (i + 1),
        "serving": {"replicas": 2, "count": sum(buckets.values()), "qps": 10.0,
                    "latency_buckets": dict(buckets),
                    "window": {"count": 1, "p99_ms": 1.0},
                    "exemplars": {"0.001": 1000 + i}},
        "replay": {"shards_alive": 2, "total_added": 11 * (i + 1), "add_qps": 11.0,
                   "occupancy": 0.25, "op_buckets": {"0.001": 11 * (i + 1)},
                   "op_exemplars": {"0.001": 2000 + i}},
        "age_of_experience": {"count": 4 * (i + 1), "buckets_s": {"0.1": 4 * (i + 1)},
                              "window": {"count": 4, "p95_s": 0.1}},
        "inference": {"rtt_exemplars": {"0.01": 3000 + i}},
        "ring_occupancy_max": 0.5,
    }


def _no_wall(records):
    return [{k: v for k, v in r.items() if k != "wall"} for r in records]


# -- the store --------------------------------------------------------------------


class TestTimelineStore:
    def test_append_compacts_deltas_and_roundtrips(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        for i in range(3):
            st.append_sweep(_rollup(i), now=100.0 + i)
        st.close()
        doc = read_timeline(str(tmp_path))
        assert doc["torn"] == 0 and len(doc["records"]) == 3
        r0, r1, _ = doc["records"]
        assert r0["counters"]["replay_added"] == 11 and r1["counters"]["replay_added"] == 11
        assert r0["hist"]["serving_s"] == {"0.001": 3, "0.01": 1}
        assert r1["hist"]["serving_s"] == {"0.001": 3, "0.01": 1}
        assert r1["gauges"]["alive"] == 5
        assert r1["exemplars"]["replay_op"] == {"0.001": 2001}

    def test_records_carry_registered_magic(self, tmp_path):
        st = TimelineStore(str(tmp_path), compress=False)
        st.append_sweep(_rollup(0), now=1.0)
        st.close()
        seg = sorted(p for p in os.listdir(tmp_path) if p.endswith(".seg"))[0]
        with open(tmp_path / seg, "rb") as f:
            assert f.read(4) == TIMELINE_MAGIC == b"APXL"

    def test_torn_tail_dropped_at_frame_boundary(self, tmp_path):
        st = TimelineStore(str(tmp_path), compress=False)
        for i in range(4):
            st.append_sweep(_rollup(i), now=10.0 + i)
        path = st._active_path()
        st.close()
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 7)
        for mod in (ttl, jtl):
            recs, torn = mod.read_segment(path)
            assert len(recs) == 3 and torn == 1
        with open(path, "r+b") as f:
            f.seek(20)
            f.write(b"\xff")
        for mod in (ttl, jtl):
            recs2, torn2 = mod.read_segment(path)
            assert len(recs2) < 3 and torn2 >= 1

    def test_unclean_shutdown_tail_is_adopted(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        for i in range(5):
            st.append_sweep(_rollup(i), now=50.0 + i)
        st._f.flush()
        del st
        st2 = TimelineStore(str(tmp_path))
        assert st2.adopted_records == 5 and len(st2.records()) == 5
        st2.append_sweep(_rollup(5), now=55.0)
        last = st2.records()[-1]
        assert last["counters"]["replay_added"] == 11
        assert last["hist"]["serving_s"] == {"0.001": 3, "0.01": 1}
        st2.close()

    def test_rotation_and_generation_pruning_bound_disk(self, tmp_path):
        st = TimelineStore(str(tmp_path), max_bytes=8192, segment_bytes=2048,
                           compress=False)
        for i in range(200):
            st.append_sweep(_rollup(i), now=1000.0 + i)
        assert st.rotations > 0 and st.prunes > 0
        total = sum(os.path.getsize(tmp_path / p) for p in os.listdir(tmp_path)
                    if p.endswith(".seg"))
        assert total <= 8192 + 2048
        ts = [r["t"] for r in read_timeline(str(tmp_path))["records"]]
        assert ts == sorted(ts) and ts[0] > 1000.0
        st.close()

    def test_windowed_percentile_bit_consistent_with_live_window(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        win = _BucketWindow(window_s=60.0)
        for i in range(30):
            cum = {"0.001": 5 * (i + 1), "0.01": 2 * (i + 1), "0.1": i // 3}
            now = 500.0 + i * 0.3
            win.feed(cum, now)
            st.append_sweep(_rollup(i, buckets=cum), now=now)
        t1 = 500.0 + 29 * 0.3
        for q in (50, 90, 99):
            assert st.percentile("serving_s", q, t1 - 60.0, t1) == win.percentile(q)
        mid = st.merged_buckets("serving_s", 502.0, 505.0)
        assert st.percentile("serving_s", 99, 502.0, 505.0) == bucket_percentile(mid, 99)
        st.close()

    def test_rate_windows(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        for i in range(10):
            st.append_sweep(_rollup(i), now=100.0 + i)
        assert st.rate("replay_added", 5.0, now=109.0) == pytest.approx(66 / 5.0)
        assert st.rate("nonexistent", 5.0, now=109.0) == 0.0
        assert st.rate("replay_added", 5.0, now=200.0) is None
        st.close()
        empty = TimelineStore(str(tmp_path / "empty"))
        assert empty.rate("replay_added", 5.0) is None
        empty.close()

    def test_exemplar_lookup_newest_and_by_bucket(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        for i in range(4):
            st.append_sweep(_rollup(i), now=10.0 + i)
        assert st.exemplar("replay_op") == 2003
        assert st.exemplar("replay_op", edge="0.001") == 2003
        assert st.exemplar("serving", edge="0.001") == 1003
        assert st.exemplar("serving", edge="99") is None
        assert [v for _, v in st.series("alive")] == [5.0] * 4
        st.close()

    def test_stats_match_doc(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        st.append_sweep(_rollup(0), now=1.0)
        assert set(st.stats()) == set(_doc_keys("## Timeline schema"))
        st.close()

    def test_bad_geometry_rejected(self, tmp_path):
        for mod in (ttl, jtl):
            with pytest.raises(ValueError, match="0 < segment_bytes <= max_bytes"):
                mod.TimelineStore(str(tmp_path), max_bytes=10, segment_bytes=20)


# -- both packages on the same sweeps ---------------------------------------------


def _sweeps(root, mod, n, status_fn=None, **kw):
    st = mod.TimelineStore(str(root), **kw)
    for i in range(n):
        roll = _rollup(i, down=i % 2)
        st.append_sweep(roll, status_fn(roll, 100.0 + i) if status_fn else None,
                        now=100.0 + i)
    return st


def test_records_equal_but_wall_and_each_reads_the_other(tmp_path):
    stores = {name: _sweeps(tmp_path / name, mods[0], 12) for name, mods in PKGS.items()}
    for st in stores.values():
        st.close()
    docs = {(writer, reader): mods[0].read_timeline(str(tmp_path / writer))
            for writer in PKGS for reader, mods in PKGS.items()}
    ref = _no_wall(docs[("jax", "jax")]["records"])
    assert len(ref) == 12
    for doc in docs.values():
        assert _no_wall(doc["records"]) == ref and doc["torn"] == 0
    # Segment bytes differ only in the wall stamp: with it equal, equal.
    a, b = (read_segment(str(tmp_path / n / "tl_00000001.seg"))[0] for n in PKGS)
    assert _no_wall(a) == _no_wall(b)
    # Each store reopens the other's directory and adopts nothing (all
    # committed) with the same tail and windowed answers.
    for writer in PKGS:
        answers = {}
        for reader, mods in PKGS.items():
            st = mods[0].TimelineStore(str(tmp_path / writer))
            answers[reader] = (st.adopted_records, len(st.records()),
                               st.percentile("serving_s", 99, 100.0, 111.0),
                               st.rate("replay_added", 5.0, now=111.0),
                               st.exemplar("serving"), st.series("expected"))
            st.close()
        assert answers["torch"] == answers["jax"]


def test_rotation_and_pruning_agree(tmp_path):
    out = {}
    for name, mods in PKGS.items():
        st = _sweeps(tmp_path / name, mods[0], 120, max_bytes=8192, segment_bytes=2048,
                     compress=False)
        st.close()
        stats = st.stats()
        with open(tmp_path / name / "MANIFEST.json") as f:
            manifest = json.load(f)
        # Bytes may differ by a digit or two of each record's wall stamp.
        assert stats["bytes"] <= 8192 + 2048
        out[name] = ({k: stats[k] for k in ("gen", "segments", "records", "appends",
                                            "rotations", "prunes")},
                     [(s["gen"], s["file"], s["records"], s["t0"], s["t1"])
                      for s in manifest["segments"]],
                     sorted(p for p in os.listdir(tmp_path / name)))
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["prunes"] > 0


_WRITER = r"""
import os, sys, time
pkg, root, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
mod = __import__(pkg + ".obs.timeline", fromlist=["TimelineStore"])
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_timeline import _rollup
st = mod.TimelineStore(root, compress=False)
for i in range(n):
    st.append_sweep(_rollup(i), now=100.0 + i)


class HalfWrite:
    # The next frame goes out in two halves, the process SIGKILLed between.
    def __init__(self, f):
        self.f = f

    def write(self, b):
        self.f.write(b[: len(b) // 2])
        self.f.flush()
        print("torn", flush=True)
        time.sleep(600)

    def __getattr__(self, name):
        return getattr(self.f, name)


st._f = HalfWrite(st._f)
st.append_sweep(_rollup(n), now=100.0 + n)
"""


@pytest.mark.parametrize("writer", ["ape_x_dqn_tpu", "ape_x_dqn_tpu_torch"])
def test_sigkilled_writer_leaves_a_tail_both_packages_adopt(writer, tmp_path):
    root = str(tmp_path / "tl")
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-c", _WRITER, writer, root, "6"], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert line.strip() == "torn", proc.stderr.read()
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    adopted = {}
    for name, (mod, _f) in PKGS.items():
        copy = tmp_path / f"copy_{name}"
        subprocess.run(["cp", "-r", root, str(copy)], check=True)
        st = mod.TimelineStore(str(copy))
        recs = st.records()
        adopted[name] = (st.adopted_records, st.torn_records, _no_wall(recs))
        st.close()
        # Committed now: a second reopen adopts nothing and reads the same.
        st = mod.TimelineStore(str(copy))
        assert st.adopted_records == 0 and _no_wall(st.records()) == _no_wall(recs)
        st.close()
    # The same records adopted; the port counts the one torn tail once,
    # where the JAX store counts it twice (it reads the adopted segment
    # again to seed its tail).
    assert adopted["torch"][::2] == adopted["jax"][::2]
    assert (adopted["torch"][0], adopted["torch"][1], len(adopted["torch"][2])) == (6, 1, 6)
    assert adopted["jax"][1] == 2


# -- the SLO rebuild ----------------------------------------------------------------


def _alive_engine(mod, events):
    return mod.SloEngine([mod.SloRule("endpoints_alive", "upper", 0.0, mod._endpoints_down)],
                         window_s=8.0, burn_threshold=0.5, clear_threshold=0.1,
                         min_samples=3, emit=lambda name, **f: events.append(name))


class TestSloRebuild:
    def _engine(self, events):
        return _alive_engine(tfleet, events)

    def test_rebuild_restores_breach_without_events(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        ev1: list = []
        eng1 = self._engine(ev1)
        now = 100.0
        for i in range(6):
            roll = _rollup(i, alive=4, down=1)
            st.append_sweep(roll, eng1.evaluate(roll, now=now), now=now)
            now += 0.5
        assert eng1.rules[0].state == "breach" and ev1 == ["slo_breach"]
        st._f.flush()
        del st
        ev2: list = []
        eng2 = self._engine(ev2)
        st2 = TimelineStore(str(tmp_path))
        assert st2.rebuild_slo(eng2, now=now) == 1 and ev2 == []
        rule = eng2.rules[0]
        assert rule.state == "breach" and len(rule._window) == 6 and st2.rebuilds == 1
        for _ in range(20):
            eng2.evaluate(_rollup(0, alive=5), now=now)
            now += 0.5
        assert ev2 == ["slo_clear"] and rule.state == "ok"
        st2.close()

    def test_rebuild_on_empty_timeline_is_noop(self, tmp_path):
        st = TimelineStore(str(tmp_path))
        ev: list = []
        eng = self._engine(ev)
        assert st.rebuild_slo(eng) == 0 and ev == [] and eng.rules[0].state == "ok"
        st.close()


def test_rebuild_slo_restores_a_live_breach_in_both_packages(tmp_path):
    """A breach recorded by one package's store rebuilds in either
    package's engine, with the same window and state."""
    out = {}
    for writer, (wmod, wfleet) in PKGS.items():
        ev: list = []
        eng = _alive_engine(wfleet, ev)
        st = wmod.TimelineStore(str(tmp_path / writer))
        for i in range(6):
            roll = _rollup(i, alive=4, down=1)
            st.append_sweep(roll, eng.evaluate(roll, now=100.0 + 0.5 * i),
                            now=100.0 + 0.5 * i)
        st.close()
        for reader, (rmod, rfleet) in PKGS.items():
            ev2: list = []
            eng2 = _alive_engine(rfleet, ev2)
            st2 = rmod.TimelineStore(str(tmp_path / writer))
            filled = st2.rebuild_slo(eng2, now=103.0)
            st2.close()
            out[(writer, reader)] = (filled, ev2, eng2.rules[0].state,
                                     list(eng2.rules[0]._window), eng2.rules[0].last_value)
    assert len(set(map(repr, out.values()))) == 1
    filled, ev2, state, window, _ = out[("torch", "torch")]
    assert (filled, ev2, state, len(window)) == (1, [], "breach", 6)


# -- the concurrent scrape plane ------------------------------------------------------


class TestConcurrentScrape:
    def test_hung_endpoint_does_not_stretch_the_sweep(self):
        hang = threading.Event()
        calls = {"healthy": 0}

        def wedged():
            hang.wait(20.0)
            return {}

        def healthy():
            calls["healthy"] += 1
            return {"replay_service": {"requests": 1}}

        agg = FleetAggregator(scrape_timeout_s=0.5, scrape_workers=4)
        try:
            agg.add_local("stuck", wedged, kind="trainer")
            for i in range(3):
                agg.add_local(f"ok{i}", healthy, kind="trainer")
            t0 = time.monotonic()
            agg.scrape_once()
            assert time.monotonic() - t0 < 2.0
            roll = agg.rollup()
            assert roll["alive"] == 3
            assert "ScrapeDeadline" in roll["endpoints"]["stuck"]["last_error"]
            t0 = time.monotonic()
            agg.scrape_once()
            assert time.monotonic() - t0 < 2.0
            assert "ScrapeStuck" in agg.rollup()["endpoints"]["stuck"]["last_error"]
            assert calls["healthy"] == 6
        finally:
            hang.set()
            agg.close()

    def test_attach_timeline_records_sweeps_and_lifts_windows(self, tmp_path):
        agg = FleetAggregator(scrape_timeout_s=1.0, window_s=30.0)
        try:
            agg.add_local("shard0", lambda: {"requests": 5, "total_added": 7, "size": 7,
                                             "capacity": 100}, kind="shard")
            st = TimelineStore(str(tmp_path))
            agg.attach_timeline(st)
            agg.scrape_once(now=10.0)
            agg.scrape_once(now=10.5)
            recs = st.records()
            assert len(recs) == 2 and recs[0]["gauges"]["alive"] == 1
            assert agg.rollup()["replay"]["window"]["add_qps"] >= 0.0
        finally:
            agg.close()
        # close() committed the segment: nothing left to adopt.
        assert TimelineStore(str(tmp_path)).adopted_records == 0


def test_aggregator_timeline_matches_jax_over_the_same_sweeps(tmp_path):
    """Both aggregators, fixed local snapshots, injected clocks: the
    timeline records (but ``wall``) and the lifted windows agree."""
    out = {}
    for name, (tmod, fmod) in PKGS.items():
        agg = fmod.FleetAggregator(window_s=4.0)
        try:
            agg.add_local("shard0", lambda: {"total_added": 10 * (agg.sweeps + 1), "size": 5,
                                             "capacity": 100, "requests": 1}, kind="shard")
            agg.attach_timeline(tmod.TimelineStore(str(tmp_path / name)))
            rolls = [agg.scrape_once(now=20.0 + i) for i in range(6)]
            recs = agg.timeline.records()
        finally:
            agg.close()
        out[name] = ([r["replay"].get("window") for r in rolls], _no_wall(recs))
    assert out["torch"] == out["jax"]


# -- per-version serving and the Prometheus spellings (the port's modules) ------------


class TestPerVersionServing:
    def test_net_server_splits_stats_by_param_version(self):
        from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer

        class _Stub:
            def infer(self, obs):
                raise NotImplementedError

        srv = ServingNetServer(_Stub())
        for v, dt in ((3, 0.001), (3, 0.002), (4, 0.1)):
            srv._record_reply(v, dt, trace_id=v * 10)
        stats = srv.stats()
        assert stats["by_version"]["3"]["replies"] == 2
        assert stats["by_version"]["4"]["replies"] == 1
        assert stats["by_version"]["4"]["latency"]["p50_ms"] \
            > stats["by_version"]["3"]["latency"]["p50_ms"]
        assert stats["by_version"]["3"]["latency_buckets"]
        assert 40 in stats["latency_exemplars"].values()

    def test_version_rows_are_bounded(self):
        from ape_x_dqn_tpu_torch.serving.net_server import _MAX_VERSIONS, ServingNetServer

        srv = ServingNetServer(object())
        for v in range(10):
            srv._record_reply(v, 0.001, trace_id=0)
        stats = srv.stats()
        assert len(stats["by_version"]) == _MAX_VERSIONS
        assert set(stats["by_version"]) == {"6", "7", "8", "9"}


class TestPrometheusExposition:
    def test_nan_and_inf_spellings(self):
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry

        r = MetricsRegistry(prefix="apex")
        r.gauge("nan_g").set(float("nan"))
        r.gauge("inf_g").set(float("inf"))
        r.gauge("ninf_g").set(float("-inf"))
        text = r.prometheus_text()
        assert "apex_nan_g NaN" in text and "apex_inf_g +Inf" in text
        assert "apex_ninf_g -Inf" in text and "apex_nan_g nan" not in text

    def test_help_text_is_escaped(self):
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry

        r = MetricsRegistry(prefix="apex")
        r.counter("c", help="line one\nline two \\ backslash").inc()
        help_line = next(ln for ln in r.prometheus_text().splitlines()
                         if ln.startswith("# HELP apex_c"))
        assert "line one\\nline two \\\\ backslash" in help_line

    def test_summary_emits_sum_and_ordered_quantiles(self):
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry

        r = MetricsRegistry(prefix="apex")
        h = r.histogram("lat")
        for dt in (0.001, 0.002, 0.005, 0.05):
            h.observe(dt)
        lines = r.prometheus_text().splitlines()
        qs = [float(ln.split()[-1]) for ln in lines if "apex_lat{quantile=" in ln]
        assert qs == sorted(qs) and len(qs) == 3
        sum_line = next(ln for ln in lines if ln.startswith("apex_lat_sum "))
        assert float(sum_line.split()[-1]) == pytest.approx(0.058)
        assert lines.index(sum_line) < lines.index(
            next(ln for ln in lines if ln.startswith("apex_lat_count")))

    def test_provider_nan_leaf_is_spelled_not_crashed(self):
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry

        r = MetricsRegistry(prefix="apex")
        r.register_provider("p", lambda: {"bad": float("nan"), "good": 1.0})
        text = r.prometheus_text()
        assert "apex_p_good 1" in text and "apex_p_bad NaN" in text

    def test_metrics_endpoint_serves_the_exposition(self):
        import urllib.request

        from ape_x_dqn_tpu_torch.obs.exporter import ObsServer
        from ape_x_dqn_tpu_torch.obs.registry import MetricsRegistry

        r = MetricsRegistry(prefix="apex")
        r.gauge("spiky").set(float("inf"))
        r.histogram("lat").observe(0.003)
        srv = ObsServer(r, port=0)
        try:
            with urllib.request.urlopen(f"{srv.url}/metrics", timeout=5.0) as resp:
                assert resp.headers["Content-Type"].startswith("text/plain")
                text = resp.read().decode()
            assert "apex_spiky +Inf" in text
            assert "apex_lat_sum" in text and "apex_lat_count 1" in text
            assert text.endswith("\n")
        finally:
            srv.close()


# -- tools/obs_diff.py and obs_top --timeline over the port's timelines ---------------


def _tools():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools import obs_diff

    return obs_diff


class TestObsDiff:
    def _mk(self, tmp_path, name, n=10, lat_edge="0.001"):
        st = TimelineStore(str(tmp_path / name))
        for i in range(n):
            st.append_sweep(
                _rollup(i, buckets={lat_edge: 5 * (i + 1)}),
                {"rules": {"r": {"state": "ok", "kind": "upper", "bound": 0.0, "value": 0.0,
                                 "burn": 0.0, "samples": 5, "breaches": 0, "clears": 0}}},
                now=100.0 + i)
        st.close()
        return str(tmp_path / name)

    def test_diff_flags_latency_regression_only(self, tmp_path):
        obs_diff = _tools()
        a = self._mk(tmp_path, "a", lat_edge="0.001")
        b = self._mk(tmp_path, "b", lat_edge="0.1")
        report = obs_diff.diff(obs_diff.load_side(a), obs_diff.load_side(b))
        assert not report["ok"] and "serving_p99_ms" in report["regressions"]
        self_report = obs_diff.diff(obs_diff.load_side(a), obs_diff.load_side(a))
        assert self_report["ok"] and not self_report["regressions"]
        assert "serving_p99_ms" in [r["metric"] for r in self_report["rows"]]

    def test_load_side_accepts_demo_artifact_wrapper(self, tmp_path):
        obs_diff = _tools()
        a = self._mk(tmp_path, "a")
        summary = obs_diff.load_side(a)
        demo = tmp_path / "demo.json"
        demo.write_text(json.dumps({"ok": True, "timeline_summary": summary}))
        assert obs_diff.load_side(str(demo)) == summary
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"unrelated": 1}))
        with pytest.raises(ValueError):
            obs_diff.load_side(str(bad))

    def test_render_is_line_oriented(self, tmp_path):
        obs_diff = _tools()
        a = self._mk(tmp_path, "a")
        out = obs_diff.render(obs_diff.diff(obs_diff.load_side(a), obs_diff.load_side(a)))
        assert out.splitlines()[0].startswith("== obs_diff ==") and "OK" in out.splitlines()[0]

    def test_diff_of_the_ports_run_against_the_jax_run_is_clean(self, tmp_path):
        obs_diff = _tools()
        a = self._mk(tmp_path, "port")
        st = jtl.TimelineStore(str(tmp_path / "jax"))
        for rec in read_timeline(a)["records"]:
            st._append(rec, rec["t"])
        st.close()
        report = obs_diff.diff(obs_diff.load_side(a), obs_diff.load_side(str(tmp_path / "jax")))
        assert report["ok"] and not report["regressions"]

    def test_obs_top_timeline_renders_the_ports_timeline(self, tmp_path):
        a = self._mk(tmp_path, "a")
        out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_top.py"),
                              "--timeline", a, "--once"], capture_output=True, text=True,
                             timeout=60, cwd=REPO)
        assert out.returncode == 0, out.stderr
        assert "no data" not in out.stdout and "serving qps" in out.stdout
