"""The port's observability layer (``ape_x_dqn_tpu_torch/obs/``) against the
JAX package's (``ape_x_dqn_tpu/obs/``), on the CPU.

Twins ``tests/test_obs.py`` and the obs parts of
``tests/test_metrics_edge.py``:

  * the registry: the same instruments and values render byte-equal
    Prometheus text and ``/varz`` JSON in both packages (also as served
    by both exporters), under a fixed clock; ``Health`` status and merge;
  * the exporter's endpoints, the ``?trace=1`` hook and the ``/healthz``
    503 path;
  * ``WorkerStatsBlock``: a block written by one package is read by the
    other, byte for byte, with a torn event slot and after its writer
    process was SIGKILLed;
  * ``FlightRecorder`` dumps and ``write_postmortem`` files equal up to
    their timestamps, the SIGTERM dump, the shm mirror;
  * ``LineageTracker``: one event sequence through both trackers gives
    equal histograms and spans;
  * the ``obs`` config section, ``TraceOnDemand`` and ``utils.profiling.
    trace`` on the CPU;
  * a tiny thread run of the port (the periodic core keys and the
    supervisor section match ``docs/METRICS.md``; the exporter scraped,
    ``tools/obs_top.py --varz --once`` over it, a ``/varz?trace=1``
    capture reaching ``done``, lineage spans) and a 2-worker process run
    (a SIGKILLed worker's post-mortem, the respawn on ``/varz``);
  * ``serve --obs-port``.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import signal
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from _torch_harness import pinned_cores, port_deadline, readline_within  # noqa: F401 — port_deadline is autouse

from ape_x_dqn_tpu import config as jconfig
from ape_x_dqn_tpu.analysis.metrics_doc import doc_section_keys
from ape_x_dqn_tpu.obs import exporter as jexporter
from ape_x_dqn_tpu.obs import lineage as jlineage
from ape_x_dqn_tpu.obs import recorder as jrecorder
from ape_x_dqn_tpu.obs import registry as jregistry
from ape_x_dqn_tpu.obs import shm_stats as jshm
from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch.obs import exporter as texporter
from ape_x_dqn_tpu_torch.obs import lineage as tlineage
from ape_x_dqn_tpu_torch.obs import recorder as trecorder
from ape_x_dqn_tpu_torch.obs import registry as tregistry
from ape_x_dqn_tpu_torch.obs import shm_stats as tshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRIES = {"torch": tregistry, "jax": jregistry}
BLOCKS = {"torch": tshm, "jax": jshm}
PACKAGES = {"torch": "ape_x_dqn_tpu_torch", "jax": "ape_x_dqn_tpu"}


@pytest.fixture
def frozen_clock(monkeypatch):
    """``time.monotonic`` (and ``time.time``) fixed: rates, ages and the
    snapshot's ``t_mono`` then read the same in both packages."""
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)


def _populate(reg_mod):
    r = reg_mod.MetricsRegistry()
    r.counter("served", help="requests served").inc(5)
    r.counter("learner/host_syncs", help="a\\nmultiline \\\\ help").inc(2.5)
    r.gauge("depth").set(3)
    r.gauge("rss").set_fn(lambda: 1234567.0)
    r.gauge("nan").set(float("nan"))
    r.gauge("inf").set(float("-inf"))
    r.gauge("broken").set_fn(lambda: 1 / 0)
    h = r.histogram("lat", help="latency")
    for v in (0.0001, 0.002, 0.02, 0.02, 0.5, 300.0):
        h.observe(v)
    r.histogram("empty", min_s=1e-2, max_s=6e4, per_decade=10)
    r.register_provider("xp", lambda: {"mb_s": 1.5, "w": {"0": 2, "ok": True},
                                        "name": "shm", "nested": {"a": {"b": 7}}})
    r.register_provider("bad", lambda: 1 / 0)
    return r


# -- the registry --------------------------------------------------------------


def test_prometheus_text_byte_equal_to_jax(frozen_clock):
    texts = {k: _populate(m).prometheus_text() for k, m in REGISTRIES.items()}
    assert texts["torch"] == texts["jax"]
    assert "apex_served_total 5" in texts["torch"]
    assert 'apex_lat{quantile="0.99"}' in texts["torch"]
    assert "apex_nan NaN" in texts["torch"] and "apex_inf -Inf" in texts["torch"]


def test_varz_snapshot_byte_equal_to_jax(frozen_clock):
    snaps = {k: json.dumps(_populate(m).snapshot(), default=str)
             for k, m in REGISTRIES.items()}
    assert snaps["torch"] == snaps["jax"]
    snap = json.loads(snaps["torch"])
    assert "ZeroDivisionError" in snap["bad"]["error"]
    assert snap["lat"]["count"] == 6 and snap["lat"]["buckets"]


def test_exporters_serve_the_same_bytes(frozen_clock):
    servers = {"torch": texporter.ObsServer(_populate(tregistry), port=0),
               "jax": jexporter.ObsServer(_populate(jregistry), port=0)}
    try:
        got = {k: (urllib.request.urlopen(f"{s.url}/metrics").read(),
                   urllib.request.urlopen(f"{s.url}/varz").read())
               for k, s in servers.items()}
    finally:
        for s in servers.values():
            s.close()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_registry_instruments_behave_alike(pkg):
    r = REGISTRIES[pkg].MetricsRegistry()
    c = r.counter("chunks")
    assert r.counter("chunks") is c
    c.inc(2)
    assert c.value == 2.0
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("chunks")
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    r.gauge("learner/loss").set(1)
    assert "apex_learner_loss 1" in r.prometheus_text()


def test_instrument_merges_equal_jax(frozen_clock):
    out = {}
    for k, m in REGISTRIES.items():
        c1, c2 = m.Counter(), m.Counter()
        c1.inc(3)
        c2.inc(4)
        c1.merge(c2)
        g1, g2 = m.Gauge(), m.Gauge()
        g1.set(0.4)
        g2.set_fn(lambda: 0.9)
        g1.merge(g2)
        h1, h2 = m.Histogram(), m.Histogram()
        h1.observe(0.01)
        h2.observe(0.1)
        h1.merge(h2)
        out[k] = (c1.snapshot(), g1.snapshot(), h1.snapshot())
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["total"] == 7 and out["torch"][1] == 0.9


def test_health_status_and_merge_equal_jax(monkeypatch):
    clock = itertools.count(100.0, 0.5)
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    out = {}
    for k, m in REGISTRIES.items():
        clock = itertools.count(100.0, 0.5)
        a, b = m.Health(stale_after_s=1.0), m.Health(stale_after_s=5.0)
        a.beat("learner")
        a.register("pump", lambda: 0.1)
        a.register("dead", lambda: 1 / 0)
        a.register("tight", lambda: 2.0, stale_after_s=1.5)
        b.beat("learner")
        b.beat("ingest")
        b.register("tight", lambda: 2.0, stale_after_s=3.0)
        a.merge(b)
        out[k] = a.status()
    assert out["torch"] == out["jax"]
    st = out["torch"]
    assert st["status"] == "degraded"
    assert not st["components"]["dead"]["ok"] and st["components"]["pump"]["ok"]
    assert not st["components"]["tight"]["ok"]   # the tighter bound won


def test_health_beat_goes_stale():
    h = tregistry.Health(stale_after_s=0.05)
    h.beat("learner")
    assert h.status()["status"] == "ok"
    time.sleep(0.08)
    st = h.status()
    assert st["status"] == "degraded" and not st["components"]["learner"]["ok"]


# -- the exporter --------------------------------------------------------------


def test_endpoints_and_trace_hook():
    r = tregistry.MetricsRegistry()
    r.gauge("step").set(9)
    h = tregistry.Health(stale_after_s=60.0)
    h.beat("learner")
    calls = []

    def hook(steps=None):
        calls.append(steps)
        return {"state": "capturing", "steps": steps}

    srv = texporter.ObsServer(r, h, port=0, trace_hook=hook)
    try:
        base = srv.url
        assert "apex_step 9" in urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert json.load(urllib.request.urlopen(f"{base}/varz"))["step"] == 9.0
        hz = urllib.request.urlopen(f"{base}/healthz")
        assert hz.status == 200 and json.load(hz)["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope")
        assert ei.value.code == 404
        varz = json.load(urllib.request.urlopen(f"{base}/varz?trace=1&steps=32"))
        assert varz["trace"]["state"] == "capturing" and calls == [32]
    finally:
        srv.close()
    bare = texporter.ObsServer(r, port=0)
    try:
        varz = json.load(urllib.request.urlopen(f"{bare.url}/varz?trace=1"))
        assert varz["trace"]["state"] == "unavailable"
        assert json.load(urllib.request.urlopen(f"{bare.url}/healthz"))["status"] == "ok"
    finally:
        bare.close()


def test_healthz_503_when_degraded():
    h = tregistry.Health(stale_after_s=0.01)
    h.beat("learner")
    h.register("supervisor", lambda: float("inf"))   # a wedged run
    time.sleep(0.03)
    srv = texporter.ObsServer(tregistry.MetricsRegistry(), h, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{srv.url}/healthz")
        assert ei.value.code == 503
        body = json.load(ei.value)
        assert body["status"] == "degraded"
        assert body["components"]["supervisor"] == {"age_s": 1e12, "ok": False}
    finally:
        srv.close()


# -- the stats block -----------------------------------------------------------


def _blocks(writer, depth=4):
    """(creator of ``writer``'s package, attached writer of the same
    package, reader of the other package)."""
    reader = "jax" if writer == "torch" else "torch"
    blk = BLOCKS[writer].WorkerStatsBlock(slots=tshm.WORKER_SLOTS, event_depth=depth)
    w = BLOCKS[writer].WorkerStatsBlock(name=blk.name, create=False)
    r = BLOCKS[reader].WorkerStatsBlock(name=blk.name, create=False)
    return blk, w, r


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_stats_block_crosses_packages(writer):
    blk, w, r = _blocks(writer)
    try:
        w.update(env_steps=128, eps_mean=0.25, chunks=3)
        for i in range(7):
            w.record_event({"kind": "collect", "i": i})
        snap = r.snapshot()
        assert snap["env_steps"] == 128.0 and snap["eps_mean"] == 0.25
        assert snap["pid"] == os.getpid() and snap["seq"] == 1
        events, torn = r.recent_events()
        assert [e["i"] for e in events] == [3, 4, 5, 6] and torn == 0   # depth 4 wraps
        assert r.slot_names == list(tshm.WORKER_SLOTS)
    finally:
        for b in (w, r):
            b.close()
        blk.close()
        blk.unlink()


def test_stats_block_bytes_equal_across_packages(frozen_clock):
    bufs = {}
    for pkg, mod in BLOCKS.items():
        blk = mod.WorkerStatsBlock(slots=tshm.WORKER_SLOTS, event_depth=8)
        try:
            w = mod.WorkerStatsBlock(name=blk.name, create=False)
            w.update(env_steps=7, transitions=96, param_version=3, collect_s=0.5)
            for i in range(11):
                w.record_event({"kind": "trace_chunk", "trace_id": i + 1, "rows": 32})
            w.add("chunks", 2)
            w.heartbeat()
            bufs[pkg] = bytes(blk._shm.buf[:blk._events_off + 8 * 256])
            w.close()
        finally:
            blk.close()
            blk.unlink()
    assert bufs["torch"][:4] == b"APXO"
    assert struct.unpack_from("<I", bufs["torch"], 4)[0] == 1
    assert bufs["torch"] == bufs["jax"]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_torn_event_slot_counted_across_packages(writer):
    blk, w, r = _blocks(writer, depth=2)
    try:
        w.record_event({"kind": "good"})
        w.record_event({"kind": "mangled"})
        struct.pack_into("<I", blk._shm.buf, blk._events_off + 256, 3)  # cut the JSON
        events, torn = r.recent_events()
        assert [e["kind"] for e in events] == ["good"] and torn == 1
        w.record_event({"kind": "x" * 400})   # longer than a slot: truncated, torn
        events, torn = r.recent_events()
        assert torn == 2 and events == []
    finally:
        for b in (w, r):
            b.close()
        blk.close()
        blk.unlink()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_sigkilled_writer_block_read_by_other_package(writer):
    """A writer process of one package killed mid-stream: the other
    package's reader sees its last slots and events (the child is
    stdlib-only)."""
    reader = "jax" if writer == "torch" else "torch"
    blk = BLOCKS[reader].WorkerStatsBlock(slots=tshm.WORKER_SLOTS, event_depth=32)
    child = subprocess.Popen([sys.executable, "-c", f"""
import sys, time
sys.path.insert(0, {REPO!r})
from {PACKAGES[writer]}.obs.shm_stats import WorkerStatsBlock
w = WorkerStatsBlock(name={blk.name!r}, create=False)
i = 0
stop_at = time.monotonic() + 300.0   # until SIGKILLed, or orphaned for 300 s
while time.monotonic() < stop_at:
    i += 1
    w.update(env_steps=i, chunks=i * 2)
    w.record_event({{"kind": "tick", "i": i}})
    time.sleep(0.002)
"""])
    try:
        deadline = time.monotonic() + 30.0
        while blk.snapshot()["env_steps"] < 10 and time.monotonic() < deadline:
            time.sleep(0.02)
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=10.0)
        snap = blk.snapshot()
        assert snap["env_steps"] >= 10 and snap["pid"] == child.pid
        assert snap["chunks"] == 2 * snap["env_steps"]
        events, torn = blk.recent_events()
        assert events and events[-1]["i"] == int(snap["events_written"])
        assert torn <= 1
    finally:
        if child.poll() is None:
            child.kill()
        blk.close()
        blk.unlink()


# -- the flight recorder -------------------------------------------------------


def test_recorder_dumps_equal_jax_up_to_timestamps(tmp_path):
    dumps = {}
    for pkg, mod in (("torch", trecorder), ("jax", jrecorder)):
        rec = mod.FlightRecorder("trainer", depth=3)
        rec.add_snapshot_provider("state", lambda: {"x": 1})
        rec.add_snapshot_provider("bad", lambda: 1 / 0)
        for i in range(5):
            rec.record("tick", i=i)
        path = rec.dump(str(tmp_path / pkg), "fault", extra={"why": "test"})
        assert path and rec.dumped == [path]
        assert os.path.basename(path).startswith(f"trainer-pid{os.getpid()}-fault-")
        assert not [f for f in os.listdir(tmp_path / pkg) if f.endswith(".tmp")]
        with open(path) as f:
            data = json.load(f)
        for k in ("wall_time", "t_mono"):
            data.pop(k)
        for e in data["events"]:
            e.pop("t")
        dumps[pkg] = data
    assert dumps["torch"] == dumps["jax"]
    assert [e["i"] for e in dumps["torch"]["events"]] == [2, 3, 4]
    assert "ZeroDivisionError" in dumps["torch"]["snapshots"]["bad"]["error"]


def test_write_postmortem_equal_jax(tmp_path):
    files = {}
    for pkg, mod in (("torch", trecorder), ("jax", jrecorder)):
        path = mod.write_postmortem(str(tmp_path / pkg), "worker3", "salvage",
                                    {"stats": {"env_steps": 9}, "events": [{"kind": "a"}]})
        assert os.path.basename(path).startswith("worker3-salvage-")
        with open(path) as f:
            data = json.load(f)
        data.pop("wall_time")
        files[pkg] = data
    assert files["torch"] == files["jax"]
    assert trecorder.write_postmortem("", "w", "salvage", {}) is None


def test_recorder_mirrors_into_the_stats_block():
    blk = tshm.WorkerStatsBlock(slots=tshm.WORKER_SLOTS, event_depth=16)
    try:
        w = tshm.WorkerStatsBlock(name=blk.name, create=False)
        rec = trecorder.FlightRecorder("worker0", depth=4, shm_sink=w)
        for i in range(6):
            rec.record("trace_chunk", trace_id=i + 1, rows=8)
        events, torn = jshm.WorkerStatsBlock(name=blk.name, create=False).recent_events()
        assert [e["trace_id"] for e in events] == [1, 2, 3, 4, 5, 6] and torn == 0
        assert [e["trace_id"] for e in rec.events()] == [3, 4, 5, 6]
        w.close()
    finally:
        blk.close()
        blk.unlink()


def test_recorder_never_raises_and_sigterm_is_main_thread_only(tmp_path):
    rec = trecorder.FlightRecorder()
    assert rec.dump("", "fault") is None
    assert rec.dump("/proc/definitely/not/writable", "fault") is None
    out = []
    t = threading.Thread(target=lambda: out.append(rec.install_sigterm(str(tmp_path))))
    t.start()
    t.join(timeout=10)
    assert out == [False]
    prev = signal.getsignal(signal.SIGTERM)
    assert rec.install_sigterm(str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is not prev
    assert rec.restore_sigterm() and signal.getsignal(signal.SIGTERM) is prev
    assert not rec.restore_sigterm()


def test_sigterm_dumps_in_a_real_process(tmp_path):
    child = subprocess.Popen([sys.executable, "-c", f"""
import sys, time
sys.path.insert(0, {REPO!r})
from ape_x_dqn_tpu_torch.obs.recorder import FlightRecorder
r = FlightRecorder("t")
r.record("alive")
assert r.install_sigterm({str(tmp_path)!r})
print("ready", flush=True)
time.sleep(60)
"""], stdout=subprocess.PIPE)
    try:
        assert readline_within(child.stdout, 60.0, "the recorder child").strip() == b"ready"
        child.terminate()
        assert child.wait(timeout=15.0) != 0   # died of the chained SIGTERM
        files = [f for f in os.listdir(tmp_path) if "sigterm" in f and f.endswith(".json")]
        assert files
        with open(os.path.join(tmp_path, files[0])) as f:
            assert json.load(f)["events"][0]["kind"] == "alive"
    finally:
        if child.poll() is None:
            child.kill()


# -- lineage -------------------------------------------------------------------


def _lineage_run(mod, monkeypatch):
    clock = itertools.count(500.0, 0.125)
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    events = []
    tr = mod.LineageTracker(64, emit=lambda name, **kw: events.append((name, kw)),
                            max_open_traces=2)
    rng = np.random.default_rng(3)
    for step in range(40):
        lo = (step * 8) % 64
        tr.on_ingest(np.arange(lo, lo + 8), t_act=499.0 + step * 0.1,
                     trace_id=(step % 3 == 0) * (step + 1), wid=step % 2)
        idx = rng.integers(0, 64, 16)
        tr.on_sample(idx)
        if step % 5 == 4:
            tr.on_trained(idx)
        tr.trace_ids_for(idx)
    tr.on_ingest(np.arange(4), t_act=1e9, trace_id=99)   # a clock ahead: clamped
    return tr.summary(), events, tr.trace_ids_for(np.arange(64))


def test_lineage_tracker_equal_to_jax(monkeypatch):
    got = {k: _lineage_run(m, monkeypatch) for k, m in (("torch", tlineage),
                                                        ("jax", jlineage))}
    assert got["torch"] == got["jax"]
    summary, events, _ = got["torch"]
    assert summary["traces_completed"] > 0 and summary["traces_abandoned"] > 0
    assert summary["clock_skew_clamped"] == 1
    assert summary["age_at_sample"]["count"] > 0
    for name, span in events:
        assert name == "lineage_span"
        ts = [span[k] for k in tlineage.SPAN_ORDER]
        assert ts == sorted(ts)


def test_a_sample_stamped_before_an_overwriting_ingest_is_not_its_first_sample(monkeypatch):
    """The learner stamps a sampled batch, then an actor's chunk overwrites
    the sampled slots before the learner takes the lock (a preemption that a
    loaded machine shows: test_thread_run_lineage_spans_and_ages failed so
    under `taskset -c 0-2`).  The port does not count that batch as the new
    trace's first sample, so its span stays monotone; the reference does,
    and stamps its first sample before its ingest (not edited)."""
    clock = itertools.count(100.0, 1.0)
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    spans = {}
    for name, mod in (("torch", tlineage), ("jax", jlineage)):
        events = []
        tr = mod.LineageTracker(8, emit=lambda _n, **kw: events.append(kw))
        tr.on_ingest(np.arange(4), trace_id=1)
        real = tr._lock
        overwrite = [lambda tr=tr: tr.on_ingest(np.arange(4), trace_id=2)]

        class IngestFirst:
            def __enter__(self):
                if overwrite:
                    overwrite.pop()()
                return real.__enter__()

            def __exit__(self, *exc):
                return real.__exit__(*exc)

        tr._lock = IngestFirst()
        tr.on_sample(np.arange(4))   # stamped before trace 2's ingest, locked after it
        tr._lock = real
        tr.on_sample(np.arange(4))
        tr.on_trained(np.arange(4))
        assert [e["trace_id"] for e in events] == [2] and tr.abandoned_count == 1
        spans[name] = [events[0][k] for k in tlineage.SPAN_ORDER]
    assert spans["torch"] == sorted(spans["torch"])
    t_act, t_ingest, t_first_sample, _ = spans["jax"]
    assert t_first_sample < t_ingest


def test_lineage_age_counts_untraced_samples_and_recycling_abandons():
    tr = tlineage.LineageTracker(32)
    tr.on_ingest(np.arange(16))            # trace id 0: ages only
    tr.on_sample(np.arange(8))
    assert tr.age_hist.count == 8 and tr.summary()["traces_open"] == 0
    tr.on_ingest(np.arange(8), trace_id=7)
    tr.on_ingest(np.arange(4))             # the ring lapped half its slots
    assert tr.abandoned_count == 1 and tr.summary()["traces_open"] == 0


# -- config --------------------------------------------------------------------


def test_obs_config_matches_jax_fields():
    import dataclasses

    port = {f.name: f.default for f in dataclasses.fields(tconfig.ObsConfig)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(jconfig.ObsConfig)}
    # Every field, the fleet_* and timeline_* ones too, with JAX's default;
    # none is refused by name any more.
    assert port == jax_fields
    assert not any(k.startswith("obs.") for k in tconfig._NOT_PORTED)
    cfg = tconfig.load_config(None, ["obs.export_port=0", "obs.postmortem_dir=none",
                                     "obs.trace_sample_rate=0.5"])
    assert (cfg.obs.export_port, cfg.obs.postmortem_dir) == (0, None)


@pytest.mark.parametrize("key", ["obs.fleet_port=1", "obs.timeline_dir=x",
                                 "obs.fleet_slo_age_p95_ms=5"])
def test_fleet_and_timeline_keys_refused_by_name(key, tmp_path):
    """These keys load now (obs/fleet.py and obs/timeline.py are ported),
    from an override and from a native JSON file alike, with the value the
    JAX config gives them; a misspelt neighbour is still refused by its
    name."""
    name, value = key.split("=")
    field = name.split(".")[1]
    want = getattr(jconfig.apply_overrides(jconfig.ApexConfig(), [key]).obs, field)
    assert getattr(tconfig.load_config(None, [key]).obs, field) == want
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"obs": {field: want}}))
    assert getattr(tconfig.load_config(str(path)).obs, field) == want
    with pytest.raises(ValueError, match=f"{name}x"):
        tconfig.load_config(None, [f"{name}x={value}"])
    path.write_text(json.dumps({"obs": {f"{field}x": want}}))
    with pytest.raises(ValueError, match=f"{field}x"):
        tconfig.load_config(str(path))


# -- traces on the CPU ---------------------------------------------------------


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from ape_x_dqn_tpu_torch.obs.trace import summarize
    from ape_x_dqn_tpu_torch.utils.profiling import TRACE_FILE, trace

    with trace(str(tmp_path)) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    s = summarize(str(tmp_path / TRACE_FILE))
    assert s["device_events"] == 0 and s["idle_share"] is None
    assert s["sampler_kernels"] == 0 and s["graph_replays"] == 0
    with trace(str(tmp_path), enabled=False) as off:
        assert off is None


def _chrome(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_trace_summary_reads_the_device_timeline_of_a_chrome_trace(tmp_path):
    """The summary of a Chrome trace as the profiler writes it on a card
    (times in µs): device work only (kernels, copies, memsets; not the
    annotations drawn on the device's rows), busy time as the union of its
    intervals, and a sampler kernel counted in the window only when its
    launch is in the trace too; the child process gives the same."""
    from ape_x_dqn_tpu_torch.obs.trace import (SAMPLER_KERNEL, summarize,
                                                 summarize_events, summarize_in_child)

    events = [
        # A sampler kernel of a call launched before the trace began.
        _chrome("kernel", f"void {SAMPLER_KERNEL}<1024>", 100.0, 5.0, 7),
        _chrome("cuda_runtime", "cudaGraphLaunch", 110.0, 3.0, 8),
        _chrome("kernel", f"void {SAMPLER_KERNEL}<1024>", 120.0, 5.0, 8),
        _chrome("kernel", "gemm", 124.0, 9.0, 8),           # overlaps the sampler
        _chrome("cuda_runtime", "cudaGraphLaunch", 130.0, 3.0, 9),
        _chrome("gpu_memcpy", "Memcpy DtoH", 140.0, 20.0, 9),
        _chrome("cuda_driver", "cuLaunchKernel", 165.0, 1.0, 10),
        _chrome("gpu_memset", "Memset", 170.0, 30.0, 10),
        _chrome("gpu_user_annotation", "step", 100.0, 500.0, 0),
        _chrome("cuda_runtime", "cudaEventRecord", 171.0, 1.0, 11),
        _chrome("cpu_op", "aten::add", 90.0, 1.0, 0),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 110.0, "id": 8},
    ]
    s = summarize_events(events)
    assert s["device_events"] == 5
    assert s["device_busy_ms"] == pytest.approx((5 + 13 + 20 + 30) / 1e3)
    assert s["device_span_ms"] == pytest.approx(100 / 1e3)
    assert s["idle_share"] == pytest.approx(1 - 68 / 100)
    assert s["sampler_kernels"] == 2 and s["sampler_kernels_launched_in_window"] == 1
    assert s["graph_replays"] == 2
    # Launch 8's first kernel starts 10 µs after it, launch 9's copy 10 µs
    # after, launch 10's memset 5 µs after: no device clock lead.
    assert s["device_clock_lead_ms"] == pytest.approx(-0.005)
    assert [op["name"] for op in s["top_device_ms"]][:2] == ["Memset", "Memcpy DtoH"]
    assert s["top_device_ms"][-1] == {"name": "gemm", "ms": pytest.approx(0.009), "count": 1}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert summarize(str(path)) == s
    assert summarize_in_child(str(path)) == json.loads(json.dumps(s))
    path.write_text("{not json")
    with pytest.raises(RuntimeError, match="trace summary exited"):
        summarize_in_child(str(path))


def test_trace_on_demand_reaches_done_on_the_cpu(tmp_path):
    """The learner's ticks start the capture at the first boundary after the
    trigger and stop it ``steps`` later; the trace and summary are written
    off the learner's thread."""
    import torch

    from ape_x_dqn_tpu_torch.obs.trace import TraceOnDemand

    step = [0]
    beats = []
    tracer = TraceOnDemand(steps=20, out_dir=str(tmp_path),
                           counters_fn=lambda: {"learner_steps": step[0]},
                           beat_fn=lambda: beats.append(step[0]))
    tracer.tick(0)   # nothing armed: a no-op
    first = tracer.trigger()
    assert first["state"] == "capturing"
    assert tracer.trigger()["state"] == "already-running"
    x = torch.ones(32, 32)
    deadline = time.monotonic() + 60.0
    while tracer.status()["state"] == "capturing" and time.monotonic() < deadline:
        x = (x @ x).clamp(max=1.0)
        step[0] += 1
        tracer.tick(step[0])
    rec = tracer.status()
    assert rec["state"] == "done", rec
    # The profiler started at step 1 and stopped at step 21: beats around both.
    assert beats == [1, 1, 21, 21]
    assert rec["steps_traced"] == 20 and rec["counters"]["learner_steps"] == 20
    assert rec["summary"]["device_events"] == 0
    assert set(rec["cost"]) == {"start_ms", "stop_ms", "export_ms", "trace_bytes",
                                "summary_ms"}
    assert rec["cost"]["trace_bytes"] > 0
    with open(os.path.join(first["logdir"], "summary.json")) as f:
        assert json.load(f)["steps_requested"] == 20
    assert os.path.exists(os.path.join(first["logdir"], "trace.json"))
    # Closed while armed: the capture ends in an error, and the next arms.
    tracer.trigger()
    tracer.close()
    assert tracer.status()["state"] == "error"
    assert tracer.trigger()["state"] == "capturing"


def test_train_cli_profile_and_tensorboard_dirs(tmp_path):
    """``train --profile-dir`` writes the run's Chrome trace,
    ``--tensorboard-dir`` its scalars; ``--profile-port`` is refused by
    name."""
    from ape_x_dqn_tpu_torch import train
    from ape_x_dqn_tpu_torch.replay.buffer import NotPortedError

    with pytest.raises(NotPortedError, match="--profile-port"):
        train.main(["--device", "cpu", "--profile-port", "9999"])
    out = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(out):
        rc = train.main(["--device", "cpu", "--mode", "sync", "--steps", "4",
                         "--log-every", "2", "--set", "env.name=chain:6",
                         "--set", "network=mlp", "--set", "learner.min_replay_mem_size=32",
                         "--set", "replay.capacity=512", "--set", "actor.num_actors=2",
                         "--profile-dir", str(tmp_path / "prof"),
                         "--tensorboard-dir", str(tmp_path / "tb")])
    assert rc == 0
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))


def test_tensorboard_sink_off_where_the_package_is_missing(monkeypatch, capsys):
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricLogger(stream=io.StringIO(), tensorboard_dir="/nonexistent/tb")
    assert "TensorBoard sink unavailable" in capsys.readouterr().err
    assert log.emit(step=1, x=2.0)["x"] == 2.0
    log.close()


# -- the port's runs on the CPU -------------------------------------------------


def _scrape(url: str):
    try:
        r = urllib.request.urlopen(url, timeout=10)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _tiny_cfg(**over):
    cfg = tconfig.ApexConfig()
    cfg.network = "mlp"
    cfg.env.name = "chain:6"
    cfg.actor.num_actors = 4
    cfg.actor.T = 100_000
    cfg.actor.flush_every = 8
    cfg.actor.sync_every = 16
    cfg.learner.min_replay_mem_size = 256
    cfg.learner.publish_every = 5
    cfg.learner.optimizer = "adam"
    cfg.learner.learning_rate = 1e-3
    cfg.replay.capacity = 4096
    cfg.obs.trace_sample_rate = 1.0
    cfg.obs.export_port = 0
    for k, v in over.items():
        section, field = k.split("__")
        setattr(getattr(cfg, section), field, v)
    return cfg.validate()


@pytest.fixture(scope="module")
def tiny_thread_run(tmp_path_factory):
    """A small thread-actor run of the port's host path, scraped while it
    trains: the endpoints, ``obs_top --varz --once`` and a ``/varz?trace=1``
    capture.  The run's step budget is open-ended and the fixture stops it
    once every scrape and the capture are done, so a learner that outruns
    the ``obs_top`` subprocess under load cannot close the exporter first;
    ``steps`` is the count the run reached."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    import torch

    cfg = _tiny_cfg(obs__trace_dir=str(tmp_path_factory.mktemp("traces")),
                    obs__trace_steps=30)
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny; the actor thread and the prefetch run beside it
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=buf), log_every=80, device="cpu")
    out, err = {}, []

    def run():
        try:
            out["final"] = pipe.run(learner_steps=10**9)
        except BaseException as e:  # noqa: BLE001 — asserted below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    url = pipe.obs_server.url
    deadline = time.monotonic() + 120.0
    while pipe.learner_step < 20 and time.monotonic() < deadline and not err:
        time.sleep(0.02)
    out["metrics"] = _scrape(f"{url}/metrics")
    out["healthz"] = _scrape(f"{url}/healthz")
    out["top"] = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_top.py"),
                                 "--varz", url, "--once"],
                                capture_output=True, text=True, timeout=60)
    out["trigger"] = json.loads(_scrape(f"{url}/varz?trace=1")[1])["trace"]
    while pipe.trace_on_demand.status()["state"] == "capturing" \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    out["trace"] = pipe.trace_on_demand.status()
    out["varz"] = json.loads(_scrape(f"{url}/varz")[1])
    pipe.stop_event.set()
    t.join(timeout=120)
    torch.set_num_threads(threads)
    assert not t.is_alive() and not err, err
    out["closed"] = pipe.obs_server is None
    out["lines"] = [json.loads(line) for line in buf.getvalue().splitlines()]
    out["pipe"], out["steps"] = pipe, pipe.learner_step
    return out


def test_thread_run_periodic_core_keys_match_doc(tiny_thread_run):
    doc = set(doc_section_keys("## Periodic record core keys"))
    assert doc
    record = tiny_thread_run["final"]
    assert not doc - set(record), doc - set(record)
    assert {"seq", "pid"} <= set(record)


def test_thread_run_supervisor_section_matches_doc(tiny_thread_run):
    doc = doc_section_keys("## Supervisor schema")
    assert doc
    assert set(doc) == set(tiny_thread_run["final"]["supervisor"])
    pipe = tiny_thread_run["pipe"]
    snap = pipe.obs_registry.snapshot()
    for name in ("supervisor/respawns", "supervisor/quarantines",
                 "supervisor/degradations", "supervisor/fallback_restores"):
        assert name in snap, name
    assert snap["supervisor"]["watchdog"] == "ok"
    assert "apex_supervisor_respawns_total 0" in pipe.obs_registry.prometheus_text()


def test_thread_run_endpoints_and_obs_top(tiny_thread_run):
    code, body = tiny_thread_run["metrics"]
    assert code == 200
    text = body.decode()
    for series in ("apex_learner_host_syncs_total", "apex_host_rss_bytes",
                   "apex_learner_step", "apex_supervisor_respawns_total",
                   "apex_lineage_traces_completed"):
        assert series in text, series
    code, body = tiny_thread_run["healthz"]
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok", health
    assert {"learner", "ingest", "supervisor"} <= set(health["components"])
    top = tiny_thread_run["top"]
    assert top.returncode == 0, top.stderr
    assert top.stdout.startswith("== apex-tpu obs_top ==") and "no data" not in top.stdout
    assert "age of experience" in top.stdout
    varz = tiny_thread_run["varz"]
    assert varz["learner"]["step"] > 0 and "stage_us" in varz
    assert tiny_thread_run["closed"]


def test_thread_run_trace_on_demand_reaches_done(tiny_thread_run):
    assert tiny_thread_run["trigger"]["state"] == "capturing"
    rec = tiny_thread_run["trace"]
    assert rec["state"] == "done", rec
    assert rec["trace_started"] and rec["steps_traced"] == 30
    assert rec["counters"]["learner_steps"] == 30
    assert rec["counters"]["sampler_launches"] == 0   # the host path samples on the CPU
    assert os.path.exists(os.path.join(rec["logdir"], "trace.json"))


def test_thread_run_lineage_spans_and_ages(tiny_thread_run):
    spans = [r for r in tiny_thread_run["lines"] if r.get("event") == "lineage_span"]
    assert spans
    for s in spans:
        ts = [s[k] for k in tlineage.SPAN_ORDER]
        assert ts == sorted(ts)
    assert all("seq" in r and "pid" in r for r in tiny_thread_run["lines"])
    lineage = tiny_thread_run["final"]["lineage"]
    # Every sampled row is counted: one batch per learner step.
    assert lineage["age_at_sample"]["count"] == tiny_thread_run["steps"] * 32
    assert lineage["traces_completed"] == len(spans)


@pytest.fixture
def two_cores():
    """Two usable cores: spawned workers inherit them and take one intra-op
    thread each (process_actors.worker_threads)."""
    with pinned_cores(2):   # this xdist worker's own pair (_torch_harness)
        yield


def test_process_run_sigkill_postmortem_and_respawn(tmp_path, two_cores):
    """Two worker processes on the host path: spans from real workers; one
    worker SIGKILLed leaves a post-mortem with its salvaged events, is
    respawned, and ``supervisor/respawns`` reads 1 on ``/varz``; no
    ``/dev/shm`` segment of the run is left."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    pm_dir = str(tmp_path / "postmortem")
    cfg = _tiny_cfg(actor__mode="process", actor__num_workers=2, actor__T=10_000_000,
                    actor__respawn_min_interval_s=0.05, learner__total_steps=10**9,
                    replay__capacity=8192, obs__postmortem_dir=pm_dir,
                    supervisor__respawn_backoff_base_s=0.05,
                    supervisor__respawn_jitter=0.0)
    buf = io.StringIO()
    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=buf), log_every=100, device="cpu")
    err = []

    def run():
        try:
            pipe.run()
        except BaseException as e:  # noqa: BLE001 — asserted below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    url = pipe.obs_server.url
    try:
        deadline = time.monotonic() + 240.0
        while pipe._lineage.completed_count == 0 and time.monotonic() < deadline:
            assert not err, err
            time.sleep(0.1)
        assert pipe._lineage.completed_count > 0
        pool = pipe.worker.pool
        while time.monotonic() < deadline:   # worker 0 has collected
            workers = json.loads(_scrape(f"{url}/varz")[1])["workers"]
            if workers.get("0", {}).get("env_steps", 0) > 0:
                break
            time.sleep(0.1)
        assert set(workers) == {"0", "1"} and workers["0"]["alive"]
        killed = pool._procs[0].pid
        os.kill(killed, signal.SIGKILL)
        while time.monotonic() < deadline and not (
                os.path.isdir(pm_dir) and os.listdir(pm_dir)
                and pool.restarts >= 1 and pool._procs[0].is_alive()):
            time.sleep(0.1)
        varz = json.loads(_scrape(f"{url}/varz")[1])
        assert varz["supervisor/respawns"]["total"] == 1.0
        assert pool._procs[0].pid != killed
    finally:
        pipe.stop_event.set()
        t.join(timeout=120)
    assert not t.is_alive() and not err, err
    files = [f for f in os.listdir(pm_dir) if f.endswith(".json")]
    assert len(files) == 1 and files[0].startswith("worker0-salvage-")
    with open(os.path.join(pm_dir, files[0])) as f:
        pm = json.load(f)
    assert pm["reason"] == "salvage" and pm["worker"] == 0 and pm["attempt"] == 0
    assert pm["stats"]["pid"] == killed and pm["stats"]["env_steps"] > 0
    assert pm["events"] and pm["events"][0]["kind"] == "spawn"
    assert any(e["kind"] == "trace_chunk" for e in pm["events"])
    spans = [json.loads(line) for line in buf.getvalue().splitlines()
             if '"lineage_span"' in line]
    assert spans and all(s["wid"] in (0, 1) for s in spans)
    for s in spans:
        assert s["t_act"] < s["t_ingest"] <= s["t_first_sample"] <= s["t_trained"]
    leftover = [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
    assert not leftover, leftover


def test_serve_obs_port_mounts_the_exporter(tmp_path):
    """``serve --attach --obs-port 0``: one exporter over the trainer's
    registry and the server's stats, with the serving batcher on
    ``/healthz``."""
    from ape_x_dqn_tpu_torch import serve

    metrics = tmp_path / "m.jsonl"
    rc, out = [], {}

    def main():
        rc.append(serve.main(["--attach", "--obs-port", "0", "--clients", "1",
                              "--duration", "6", "--metrics-every", "1",
                              "--metrics-file", str(metrics), "--device", "cpu",
                              "--steps", "100000", "--set", "env.name=chain:6",
                              "--set", "network=mlp", "--set", "replay.capacity=5000",
                              "--set", "learner.min_replay_mem_size=200",
                              "--set", "obs.export_port=0"]))

    t = threading.Thread(target=main, daemon=True)
    t.start()
    deadline = time.monotonic() + 60.0
    urls = []
    while time.monotonic() < deadline and not out:
        if metrics.exists():
            urls = [rec["url"] for rec in map(json.loads, metrics.read_text().splitlines())
                    if rec.get("event") == "obs_exporter"]
        if len(urls) == 2:   # the trainer's own, then serve's on its port
            url = urls[-1]
            while time.monotonic() < deadline:
                varz = json.loads(_scrape(f"{url}/varz")[1])
                if varz.get("learner", {}).get("step", 0) > 0 \
                        and varz["serving"].get("served_total", 0) > 0:
                    out["varz"] = varz
                    out["healthz"] = _scrape(f"{url}/healthz")
                    break
                time.sleep(0.2)
        time.sleep(0.1)
    t.join(timeout=60)
    assert not t.is_alive() and rc == [0]
    assert "varz" in out, urls
    code, body = out["healthz"]
    health = json.loads(body)
    assert code == 200 and {"serving_batcher", "learner"} <= set(health["components"])
