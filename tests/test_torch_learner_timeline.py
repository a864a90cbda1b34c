"""The learner's timeline: ``utils/profiling.StageTimer``'s span ring and
call records, ``runtime/graphed_call.StreamClock``'s events on the learner
stream, the serving tier's queue waits, and the benchmark readers that read
them (``benchmark/timeline.py``, ``benchmark/metrics/``).

* Spans nest (each records its parent); a span's self time is its
  duration less its children's, and thread time with no span open is
  ``other``; the ring keeps the newest ``capacity`` spans.
* An idle gap of the stream is charged to the spans open over the host
  time it lasted: wholly to one span that covers it, split by overlap
  between two.
* The clock reads pieces (start to end) and gaps (end to start) into the
  call they were issued in, and reads no event the pacer has not waited
  for (fake events stand in for CUDA's).
* A call a profiler touched is ``profiled``, and it and the call after it
  are left out; each span but the per-replay ones is an ``apex.<name>``
  range while a profiler runs, and none opens a range otherwise.
* Each new reader on a hand-built context, and a CPU run of a cell that
  reads them (the device's two read nothing on the CPU, where no stream
  events exist).
* The runtime's ``learner_timeline`` section, and the trace summary's
  per-call device spans beside the events' (the clock cross-check).
"""

from __future__ import annotations

import io
import json
import threading

import pytest
import torch

from ape_x_dqn_tpu_torch import config as tconfig
from ape_x_dqn_tpu_torch.obs import trace as otrace
from ape_x_dqn_tpu_torch.runtime import graphed_call
from ape_x_dqn_tpu_torch.utils import profiling
from ape_x_dqn_tpu_torch.utils.profiling import OTHER, StageTimer
from benchmark import harness

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse


class _Clock:
    """A host clock the test sets (s)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _timer(monkeypatch, capacity: int = profiling.SPAN_CAPACITY):
    clock = _Clock()
    timer = StageTimer(capacity=capacity, clock=clock)
    monkeypatch.setattr(profiling, "_current", timer)
    return timer, clock


def _span(timer, clock, name, t0, t1, body=None):
    clock.t = t0
    with timer.stage(name) as span:
        if body is not None:
            body(span)
        clock.t = t1
    return span


# -- spans ------------------------------------------------------------------

def test_spans_nest_and_self_time_is_the_span_less_its_children(monkeypatch):
    timer, clock = _timer(monkeypatch)
    tid = threading.get_ident()

    def body(call):
        _span(timer, clock, "ingest", 2.0, 3.0)
        _span(timer, clock, "replay", 4.0, 6.0,
              lambda s: _span(timer, clock, "pace_wait", 4.5, 5.0))

    _span(timer, clock, "call", 1.0, 7.0, body)
    spans = timer.spans()
    assert [(n, t0, t1) for n, t0, t1, _, _ in spans] == [
        ("call", 1.0, 7.0), ("ingest", 2.0, 3.0), ("replay", 4.0, 6.0), ("pace_wait", 4.5, 5.0)]
    ids = {n: i for n, _, _, _, i in spans}
    parents = {n: p for n, _, _, p, _ in spans}
    assert parents == {"call": -1, "ingest": ids["call"], "replay": ids["call"],
                       "pace_wait": ids["replay"]}
    # Self times over the whole stretch; no span open before and after: other.
    assert timer.charge(0.0, 8.0, tid) == pytest.approx(
        {OTHER: 2.0, "call": 3.0, "ingest": 1.0, "replay": 1.5, "pace_wait": 0.5})
    # Another thread's spans are not this thread's.
    assert timer.charge(0.0, 8.0, tid + 1) == {OTHER: 8.0}
    # The totals behind stage_us still count every span.
    assert timer.us_per_call() == pytest.approx(
        {"call": 6e6, "ingest": 1e6, "replay": 2e6, "pace_wait": 0.5e6})
    rec = timer.finished_calls()[0]
    assert rec["host_ms"] == pytest.approx({"ingest": 1e3, "replay": 2e3, "pace_wait": 0.5e3})
    assert (rec["t0"], rec["t1"], rec["profiled"]) == (1.0, 7.0, False)


def test_the_span_ring_keeps_the_newest_capacity_spans(monkeypatch):
    timer, clock = _timer(monkeypatch, capacity=8)
    for i in range(20):
        _span(timer, clock, f"s{i}", float(i), i + 0.5)
    spans = timer.spans()
    assert len(timer._ids) == 8 and len(spans) == 8
    assert [n for n, *_ in spans] == [f"s{i}" for i in range(12, 20)]
    tid = threading.get_ident()
    # What the ring no longer holds counts as other; what it holds, as itself.
    assert timer.charge(3.0, 3.5, tid) == {OTHER: 0.5}
    assert timer.charge(15.25, 15.75, tid) == pytest.approx({"s15": 0.25, OTHER: 0.25})


@pytest.mark.parametrize("a,b,want", [
    (2.2, 2.8, {"ingest": 0.6}),                          # one span covers the gap
    (2.5, 4.5, {"ingest": 0.5, "call": 1.0, "replay": 0.5}),  # split by overlap
    (6.5, 7.5, {"call": 0.5, OTHER: 0.5}),
])
def test_a_gap_is_charged_to_the_spans_over_its_host_time(monkeypatch, a, b, want):
    timer, clock = _timer(monkeypatch)

    def body(call):
        _span(timer, clock, "ingest", 2.0, 3.0)
        _span(timer, clock, "replay", 4.0, 6.0)

    _span(timer, clock, "call", 1.0, 7.0, body)
    assert timer.charge(a, b, threading.get_ident()) == pytest.approx(want)
    # The same through a reading: a gap of (b - a) s before a piece issued at b.
    rec = profiling._call_record(99, threading.get_ident(), 0.0, False)
    rec["marks"], rec["read"] = 3, 1
    timer.device_reading(rec, True, True, 0, (b - a) * 1e3, b, threading.get_ident())
    assert rec["idle_by_span"] == pytest.approx({k: v * 1e3 for k, v in want.items()})
    assert rec["gap_ms"] == pytest.approx((b - a) * 1e3) and rec["lead_gap_ms"] == 0.0


# -- the stream's clock -----------------------------------------------------

class _Events:
    """Fake CUDA events: ``record`` stamps the device time the test set (ms);
    ``elapsed_time`` refuses an event no ``synchronize`` has passed."""

    def __init__(self):
        self.device_ms = 0.0
        self.serial = 0
        self.synced = -1
        self.made = 0
        events = self

        class Event:
            def __init__(self, enable_timing=False, blocking=False):
                assert enable_timing and blocking
                events.made += 1

            def record(self, stream=None):
                self.t, self.n = events.device_ms, events.serial
                events.serial += 1

            def synchronize(self):
                events.synced = max(events.synced, self.n)

            def elapsed_time(self, other):
                assert self.n <= events.synced and other.n <= events.synced, "read unsynced"
                return other.t - self.t

        self.Event = Event


def _fake_cuda(monkeypatch) -> _Events:
    events = _Events()
    monkeypatch.setattr(torch.cuda, "Event", events.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return events


def test_the_clock_reads_pieces_and_gaps_into_their_call(monkeypatch):
    timer, clock = _timer(monkeypatch)
    ev = _fake_cuda(monkeypatch)
    sc = graphed_call.StreamClock()
    tid = threading.get_ident()
    clock.t = 0.0
    call = timer.stage("call").__enter__()
    # Ingest: eager work on the stream from 1000 to 1200 device ms.
    clock.t = 1.0
    ing = timer.stage("ingest").__enter__()
    ev.device_ms = 1000.0
    with sc.piece(None):
        ev.device_ms = 1200.0
    clock.t = 1.3
    ing.__exit__(None, None, None)
    # A replay issued at host 2.0 that the stream reaches at once: 800 ms idle
    # before it, over host [1.2, 2.0]: 0.1 s of ingest, 0.7 s of the call's own.
    clock.t = 2.0
    ev.device_ms = 2000.0
    sc.mark(None, True, True, 4)
    ev.device_ms = 2500.0
    sc.mark(None, False, True, 4)
    # The next replay issued while the stream is busy: no gap.
    clock.t = 2.1
    sc.mark(None, True, True, 4)
    ev.device_ms = 3000.0
    last = sc.mark(None, False, True, 4)
    rec = timer.call
    assert rec["marks"] == 6 and rec["read"] == 0
    last.synchronize()
    sc.read_through(last)
    assert rec["read"] == 6 and not rec["done"]   # its span is still open
    clock.t = 3.5
    call.__exit__(None, None, None)
    assert timer.finished_calls() == [rec] and rec["done"]
    assert rec["eager_ms"] == pytest.approx(200.0)
    assert (rec["replays"], rec["steps"], rec["replay_ms"]) == (2, 8, pytest.approx(1000.0))
    assert rec["gap_ms"] == pytest.approx(800.0) and rec["lead_gap_ms"] == 0.0
    assert rec["idle_by_span"] == pytest.approx({"ingest": 100.0, "call": 700.0})
    assert timer.charge(1.2, 2.0, tid) == pytest.approx({"ingest": 0.1, "call": 0.7})
    # The next call's first piece reads the gap since this one's last as its lead.
    clock.t = 4.0
    made = ev.made
    with timer.stage("call"):
        ev.device_ms = 3250.0
        with sc.piece(None):
            ev.device_ms = 3300.0
        nxt = sc.mark(None, True, True, 1)
        ev.device_ms = 3400.0
        end = sc.mark(None, False, True, 1)
        end.synchronize()
        sc.read_through(end)
    rec2 = timer.finished_calls()[1]
    assert rec2["lead_gap_ms"] == pytest.approx(250.0) and rec2["gap_ms"] == 0.0
    assert rec2["idle_by_span"] == pytest.approx({OTHER: 250.0})
    assert nxt is not None and ev.made == made   # read events are recorded again


def test_the_pacer_reads_only_what_it_waited_for(monkeypatch):
    timer, clock = _timer(monkeypatch)
    ev = _fake_cuda(monkeypatch)
    monkeypatch.setattr(graphed_call, "MAX_REPLAYS_AHEAD", 2)
    sc = graphed_call.StreamClock()
    pacer = graphed_call._Pacer(sc)
    issued = []
    with timer.stage("call"):
        for i in range(5):
            ev.device_ms = 10.0 * i
            pacer.tick(torch.device("cpu"), lambda: issued.append(i), steps=1)
        rec = timer.call
        # Five replays, two in flight: the pacer waited for three; each read
        # replay has its start and end read.
        assert issued == list(range(5)) and rec["marks"] == 10
        assert rec["read"] == 6 and rec["replays"] == 3
    spans = {n for n, *_ in timer.spans()}
    assert {"replay", "pace_wait"} <= spans
    # With the pacing off there are no events at all.
    monkeypatch.setattr(graphed_call, "MAX_REPLAYS_AHEAD", 0)
    made = ev.made
    pacer.tick(torch.device("cpu"), lambda: issued.append(9))
    assert ev.made == made and issued[-1] == 9


def test_an_eager_piece_outside_a_call_records_nothing(monkeypatch):
    timer, clock = _timer(monkeypatch)
    ev = _fake_cuda(monkeypatch)
    sc = graphed_call.StreamClock()
    with sc.piece(None):
        pass
    assert ev.made == 0 and not sc._marks


# -- the profiler -----------------------------------------------------------

def test_profiled_calls_and_the_call_after_them_are_left_out(monkeypatch, tmp_path):
    timer = StageTimer()
    monkeypatch.setattr(profiling, "_current", timer)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    for i in range(6):
        if i == 2:
            prof.start()
        with timer.stage("call"):
            with timer.stage("ingest"):
                torch.ones(4).sum()
            if i == 2:
                prof.stop()
    calls = timer.finished_calls()
    assert [c["profiled"] for c in calls] == [False, False, True, False, False, False]
    assert calls[2]["annotated"] and not calls[3]["annotated"]
    assert [c["seq"] for c in timer.whole_calls()] == [1, 2, 5, 6]
    from benchmark.timeline import window_calls

    ctx = {"t0": calls[0]["t0"], "t1": calls[-1]["t1"]}
    assert [c["seq"] for c in window_calls(ctx)] == [1, 2, 5, 6]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"apex.call", "apex.ingest"} <= names


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    opened = []

    class Spy:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    timer = StageTimer()
    with timer.stage("call"), timer.stage("replay"):
        pass
    assert opened == [] and not timer.finished_calls()[0]["profiled"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.stage("call"), timer.stage("ingest"):
            for name in ("tick", "pace_wait", "replay"):   # at every replay: no range
                with timer.stage(name):
                    pass
    assert opened == ["apex.call", "apex.ingest"]
    assert timer.finished_calls()[1]["profiled"]


# -- the readers --------------------------------------------------------------

def _record(seq, t0, t1, *, replay_ms=0.0, steps=0, eager_ms=0.0, lead=0.0, gap=0.0,
            ingest_ms=0.0, profiled=False):
    rec = profiling._call_record(seq, 0, t0, profiled)
    rec.update(t1=t1, replay_ms=replay_ms, steps=steps, replays=steps, eager_ms=eager_ms,
               lead_gap_ms=lead, gap_ms=gap, done=True, step=seq * steps)
    if ingest_ms:
        rec["host_ms"]["ingest"] = ingest_ms
    return rec


def _readers_timer(monkeypatch, calls, waits=()):
    timer = StageTimer()
    timer.calls.extend(calls)
    for t, w in waits:
        timer.queue_wait(t, [w])
    monkeypatch.setattr(profiling, "_current", timer)
    return timer


READERS = ["learner_device_ms_per_step", "learner_stream_idle_share", "ingest_ms_per_call",
           "serve_queue_wait_p95_ms"]


def test_each_new_reader_on_a_hand_built_context(monkeypatch):
    calls = [_record(1, 0.0, 1.0, replay_ms=900.0, steps=900, eager_ms=10.0, lead=40.0,
                     gap=50.0, ingest_ms=2.0),
             _record(2, 1.0, 2.0, replay_ms=1000.0, steps=1000, eager_ms=10.0, gap=10.0,
                     profiled=True),
             _record(3, 2.0, 3.0, replay_ms=5000.0, steps=1000, ingest_ms=100.0),  # after
             _record(4, 3.0, 4.0, replay_ms=1100.0, steps=1000, eager_ms=20.0, lead=30.0,
                     ingest_ms=4.0),
             _record(5, 4.0, 5.0, replay_ms=1000.0, steps=1100, eager_ms=10.0, gap=20.0),
             _record(6, 5.0, 6.5, replay_ms=1000.0, steps=1000)]   # past the window
    waits = [(0.5 + i * 0.01, 0.001 * (i % 10 + 1)) for i in range(100)]   # in call 1
    waits += [(1.5, 9.0), (2.5, 9.0)]                                        # in 2 and 3
    _readers_timer(monkeypatch, calls, waits)
    ctx = {"t0": 0.0, "t1": 6.0, "central": True}
    read = {name: harness.metric_reader(name)(ctx) for name in READERS}
    assert read["learner_device_ms_per_step"] == pytest.approx(3000.0 / 3000)
    idle = 40 + 50 + 30 + 20
    assert read["learner_stream_idle_share"] == pytest.approx(
        100.0 * idle / (idle + 3000.0 + 40.0))
    assert read["ingest_ms_per_call"] == pytest.approx(6.0 / 3)
    # Only the waits inside the kept calls: 1 … 10 ms, ten of each.
    import statistics

    want = statistics.quantiles([0.001 * (i % 10 + 1) for i in range(100)], n=100)[94]
    assert read["serve_queue_wait_p95_ms"] == pytest.approx(1e3 * want)
    assert harness.metric_reader("serve_queue_wait_p95_ms")({**ctx, "central": False}) is None


def test_readers_read_nothing_with_fewer_than_three_whole_calls(monkeypatch):
    calls = [_record(1, 0.0, 1.0, replay_ms=900.0, steps=900, ingest_ms=2.0),
             _record(2, 1.0, 2.0, replay_ms=900.0, steps=900, ingest_ms=2.0),
             _record(3, 2.0, 3.0, replay_ms=900.0, steps=900, profiled=True),
             _record(4, 3.0, 4.0, replay_ms=900.0, steps=900)]
    _readers_timer(monkeypatch, calls, [(0.5, 0.002)] * 30)
    ctx = {"t0": 0.0, "t1": 4.0, "central": True}
    assert all(harness.metric_reader(n)(ctx) is None for n in READERS)
    # CPU calls (no stream events) read for ingest, not for the device.
    cpu = [_record(i, float(i), i + 1.0, ingest_ms=3.0) for i in range(1, 5)]
    _readers_timer(monkeypatch, cpu)
    ctx = {"t0": 0.0, "t1": 9.0, "central": False}
    assert harness.metric_reader("ingest_ms_per_call")(ctx) == pytest.approx(3.0)
    assert harness.metric_reader("learner_device_ms_per_step")(ctx) is None
    assert harness.metric_reader("learner_stream_idle_share")(ctx) is None


def test_the_queue_wait_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "WAIT_CAPACITY", 16)
    timer = StageTimer()
    for i in range(40):
        timer.queue_wait(float(i), [i / 1e3])
    got = timer.queue_waits(0.0, 100.0)
    assert got == [(float(i), pytest.approx(i / 1e3)) for i in range(24, 40)]


_CPU_RUN = """
import json
import torch
from benchmark import harness
torch.set_num_threads(1)   # a share of a machine the test's neighbours run on too
harness.TRACE_STEPS = 1   # one call a stretch: enough whole untraced calls in 8 s
tiny = ["replay.capacity=4096", "learner.steps_per_call=1", "learner.ingest_block=64",
        "learner.min_replay_mem_size=256", "actor.num_actors=4", "actor.mode=thread"]
res = harness.run_cell("c3_central_2m", 2**31 + 4321, 8.0, True, device="cpu",
                       overrides=tiny, out=lambda s: None, err=lambda s: None)
print("RESULT " + json.dumps(res))
"""


def test_a_cpu_run_reads_the_new_metrics_or_nothing():
    # Its own interpreter: the result refuses a process that loaded JAX, as
    # this one has (tests/conftest.py).
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _CPU_RUN], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(next(ln for ln in out.stdout.splitlines() if ln.startswith("RESULT "))[7:])
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # No stream events on the CPU: the device's metrics read nothing.
    assert "learner_device_ms_per_step" not in got and "learner_stream_idle_share" not in got
    assert got["ingest_ms_per_call"]["value"] > 0 and got["ingest_ms_per_call"]["unit"] == "ms"
    assert got["serve_queue_wait_p95_ms"]["value"] > 0
    for name in ("env_frames_per_s", "serve_batch_rows", "serve_forward_ms"):
        assert name in got   # the metrics the cell had still read


# -- the runtime's section and the trace summary -----------------------------

def test_the_fused_runtime_emits_its_learner_timeline():
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger

    cfg = tconfig.ApexConfig()
    cfg.network, cfg.env.name = "mlp", "chain:6"
    cfg.actor.num_actors, cfg.actor.flush_every = 4, 8
    cfg.learner.device_replay, cfg.learner.steps_per_call = True, 16
    cfg.learner.min_replay_mem_size, cfg.replay.capacity = 256, 4096
    pipe = AsyncPipeline(cfg.validate(), logger=MetricLogger(stream=io.StringIO()),
                         log_every=10_000, device="cpu")
    assert profiling.current_timer() is pipe.timers
    final = pipe.run(learner_steps=64)
    tl = final["learner_timeline"]
    rows = tl["calls_newest"]
    assert [r["step"] for r in rows] == [0, 16, 32, 48]
    assert all(r["device_ms"] == 0.0 and not r["profiled"] for r in rows)
    assert sum(r["ingest_rows"] for r in rows) >= 0
    # No stream events on the CPU: no device aggregates.
    assert tl["calls"] == 0 and tl["device_ms_per_step"] is None
    assert {"call", "ingest", "publish"} <= set(final["stage_us"])


def test_the_trace_summary_sets_each_calls_device_span_beside_its_events():
    def launch(ts, corr, name="cudaGraphLaunch", tid=1):
        return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2.0,
                "tid": tid, "args": {"correlation": corr}}

    def kernel(ts, dur, corr, cat="kernel"):
        return {"cat": cat, "name": "k", "ts": ts, "dur": dur, "args": {"correlation": corr}}

    events = [
        {"cat": "user_annotation", "name": "apex.call", "ts": 100.0, "dur": 1000.0, "tid": 1},
        launch(110.0, 1), kernel(200.0, 300.0, 1), launch(120.0, 2), kernel(500.0, 200.0, 2),
        launch(130.0, 5, tid=2), kernel(90.0, 900.0, 5),   # another thread's: not the call's
        {"cat": "user_annotation", "name": "apex.call", "ts": 2000.0, "dur": 500.0, "tid": 1},
        launch(2010.0, 3), kernel(2100.0, 300.0, 3),
        launch(2020.0, 6, "cudaMemcpyAsync"), kernel(2400.0, 100.0, 6, "gpu_memcpy"),
        {"cat": "user_annotation", "name": "apex.replay", "ts": 3000.0, "dur": 10.0, "tid": 1},
        launch(3000.0, 4), kernel(3100.0, 50.0, 4),   # launched outside any call
    ]
    calls = otrace.summarize_events(events)["calls"]
    assert calls == [{"host_ms": 1.0, "device_span_ms": pytest.approx(0.5)},
                     {"host_ms": 0.5, "device_span_ms": pytest.approx(0.4)}]
    recs = [_record(1, 0.0, 1.0, replay_ms=0.4, steps=1, eager_ms=0.05, gap=0.05),
            _record(2, 1.0, 2.0, replay_ms=0.6, steps=1)]
    check = otrace.clock_check(calls, recs)
    assert [(c["event_span_ms"], c["trace_span_ms"]) for c in check] == [
        (pytest.approx(0.5), pytest.approx(0.5)), (pytest.approx(0.6), pytest.approx(0.4))]
    assert [c["ratio"] for c in check] == [pytest.approx(1.0), pytest.approx(1.5)]
