"""On-demand ``torch.profiler`` capture of a live learner, started from
``/varz?trace=1``.

Port of ``ape_x_dqn_tpu/obs/trace.py`` (``TraceOnDemand``, :49): one
capture at a time; ``trigger()`` returns at once with a status dict (the
``/varz`` reply's ``trace``).  The learner thread calls ``tick(step)`` at
each host step and, on the fused path, between the graph replays of a
call (``runtime/graphed_call.GraphedCall``'s ``on_replay``, with the step
the replays reached): the first tick after a trigger starts the profiler
(``utils/profiling.start_trace``: the device synchronized, then CPU and
CUDA activity), the first tick ``obs.trace_steps`` steps later stops it.
So a window holds exactly the steps it was asked for, inside a K-step
call or across a call boundary, and no work launched before it; armed
between two calls, it starts at the next call's first replay (the
prologue's, which holds the sampler on the sample-ahead path).  Start and
stop run on the thread that launches the learner's CUDA graphs, between
its launches: stopping the profiler from another thread while the
learner replayed CUDA graphs hung an H100 (``cudaGraphLaunch`` against
the profiler's stop).
``beat_fn`` (the runtime's: the learner's heartbeat) is called before and
after each start and stop, so the learner's heartbeat ages by the stall
itself and not by the stall plus the call before it.

A thread of the capture's own then writes the Chrome trace into the
capture's logdir (``trace.json``; the profiler's export holds the GIL
while it writes) and summarizes it in a child process (``python -m
ape_x_dqn_tpu_torch.obs.trace TRACE``), so that reading ~10^6 events
never competes with the learner thread for the GIL.  The summary goes into
``summary.json`` beside the trace and into ``status()``.

The summary is the port's own (the JAX package parses an xplane with
``tools/trace_capture.py``, which is JAX tooling and never loaded here),
computed from the trace's events as ``profile_fused`` computes its busy
time:

  * ``top_device_ms`` — device ms and count by kernel name, the top 20;
  * ``device_busy_ms`` (the union of device intervals: kernels, copies,
    memsets), ``device_span_ms`` (first device start to last device end)
    and ``idle_share`` over that span;
  * ``sampler_kernels`` — the sampler's kernels (``SAMPLER_KERNEL``), and
    ``sampler_kernels_launched_in_window``, those whose launch (a graph
    replay or a kernel launch) the trace holds too;
  * ``graph_replays`` — ``cudaGraphLaunch`` calls;
  * ``device_clock_lead_ms`` — how far a device record's start lies before
    its own launch at most (a kernel cannot start before it is launched:
    a positive value is the card's clock running ahead of the host's, which
    ``utils/profiling.EDGE_MARGIN_S`` must exceed), ``device_clock_lead``
    the record that sets it (its name, category, stream, correlation id and
    start) and the launch it was matched to (name, thread, start, length),
    and ``device_records_before_launch`` how many correlations lead at all.

CUPTI's device records cover the whole process, the CPU operators only the
learner thread, so the summary reads the device timeline.  Starting and
stopping the profiler stalls the learner (the stop synchronizes the
device) and replays run slower under CUPTI, so a rate measured over a run
leaves the capture window out; the record's ``cost`` holds the stalls
(``start_ms``, ``stop_ms`` on the learner thread, ``export_ms`` under the
GIL, ``summary_ms`` in the child).  ``counters_fn`` (the runtime's:
learner steps, sampler launches) is read at the start and at the stop;
the deltas go into the record as ``counters``.

What a capture costs grows with its device records.  For one 2048-step
call of config3's learner (~8.9 * 10^5 records, an 830 MB trace) on an
NVIDIA H100 80GB HBM3 at 700 W, torch's stop and its export each held the
GIL for 12–19 s, so every Python thread of the process waited that long
(``/healthz`` can read a component stale meanwhile), and the process's
first capture also spent ~11 s setting CUPTI up on the learner thread.
The profiler can drop records (there up to ~0.2 % of a learner call's);
the summary counts what the trace holds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

# The sampler's kernel name in ops/csrc/sampling.cu.
SAMPLER_KERNEL = "sample_kernel"
GRAPH_LAUNCH = "cudaGraphLaunch"
# Runtime and driver calls that launch device work (a graph replay, a
# kernel, the sampler's cooperative launch).
LAUNCHES = ("cudaGraphLaunch", "cudaLaunch", "cuLaunch", "cuGraphLaunch")
# Chrome-trace categories of device work, and of the host's launch calls.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
TOP_OPS = 20
SUMMARY_NICE = 10
# The package's parent directory, for the summary's child process.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def union_of_spans(spans):
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def summarize_events(events) -> dict:
    """The device timeline of a Chrome trace's ``traceEvents`` (times in
    µs): see the module docstring."""
    by_name: Dict[str, list] = {}
    spans = []
    sampler_corr = []
    first_record: Dict[object, dict] = {}   # correlation → its earliest device record
    launches: Dict[object, dict] = {}
    graph_replays = 0
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            s, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((s, s + dur))
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += dur
            acc[1] += 1
            if corr not in first_record or s < float(first_record[corr]["ts"]):
                first_record[corr] = e
            if SAMPLER_KERNEL in name:
                sampler_corr.append(corr)
        elif cat in HOST_API_CATS and name.startswith(LAUNCHES):
            launches[corr] = e
            graph_replays += name.startswith(GRAPH_LAUNCH)
    leads = [(float(launches[c]["ts"]) - float(r["ts"]), c)
             for c, r in first_record.items() if c in launches]
    busy = union_of_spans(spans)
    span = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0.0
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:TOP_OPS]
    lead_us, lead_corr = max(leads, key=lambda lc: lc[0]) if leads else (None, None)
    return {
        "device_events": len(spans),
        "device_busy_ms": busy / 1e3,
        "device_span_ms": span / 1e3,
        "idle_share": (1.0 - busy / span) if span else None,
        "top_device_ms": [{"name": n, "ms": us / 1e3, "count": c} for n, (us, c) in top],
        "sampler_kernels": len(sampler_corr),
        "sampler_kernels_launched_in_window": sum(c in launches for c in sampler_corr),
        "graph_replays": graph_replays,
        "device_clock_lead_ms": lead_us / 1e3 if leads else None,
        "device_clock_lead": _lead_record(first_record[lead_corr], launches[lead_corr],
                                          lead_us) if leads else None,
        "device_records_before_launch": sum(lead > 0 for lead, _ in leads),
    }


def _lead_record(record: dict, launch: dict, lead_us: float) -> dict:
    """The device record that leads its launch most, and that launch."""
    args = record.get("args", {})
    return {"ms": lead_us / 1e3, "name": record.get("name"), "cat": record.get("cat"),
            "stream": args.get("stream"), "correlation": args.get("correlation"),
            "ts_us": record.get("ts"), "dur_us": record.get("dur"),
            "launch": {"name": launch.get("name"), "tid": launch.get("tid"),
                       "ts_us": launch.get("ts"), "dur_us": launch.get("dur")}}


def summarize(path: str) -> dict:
    """``summarize_events`` of the Chrome trace at ``path``."""
    with open(path) as f:
        return summarize_events(json.load(f).get("traceEvents", []))


def summarize_in_child(path: str, timeout_s: float = 600.0) -> dict:
    """``summarize(path)`` in a child process (``python -m
    ape_x_dqn_tpu_torch.obs.trace``), its JSON read from the child's stdout:
    the waiting thread holds no GIL while ~10^6 events are read."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    res = subprocess.run([sys.executable, "-m", "ape_x_dqn_tpu_torch.obs.trace", path],
                         capture_output=True, text=True, env=env, timeout=timeout_s)
    if res.returncode != 0:
        raise RuntimeError(f"trace summary exited {res.returncode}: {res.stderr[-2000:]}")
    return json.loads(res.stdout)


class TraceOnDemand:
    """One capture at a time: ``trigger()`` arms it, the learner's
    ``tick(step)`` starts and stops the profiler, a thread of its own
    writes the trace and the summary."""

    def __init__(self, steps: int = 512, out_dir: Optional[str] = None,
                 timeout_s: float = 60.0, counters_fn: Optional[Callable[[], dict]] = None,
                 beat_fn: Optional[Callable[[], None]] = None):
        self._steps = int(steps)
        self._beat = beat_fn or (lambda: None)
        self._out_dir = out_dir
        self._timeout_s = float(timeout_s)
        self._counters_fn = counters_fn
        self._lock = threading.Lock()
        self._busy = False
        self._job: Optional[dict] = None   # the armed or running capture
        self.captures = 0
        self.last: dict = {"state": "idle"}

    def trigger(self, steps: Optional[int] = None) -> dict:
        with self._lock:
            if self._busy:
                return {**self.last, "state": "already-running"}
            self._busy = True
            self.captures += 1
        n = int(steps) if steps else self._steps
        if self._out_dir:
            logdir = os.path.join(self._out_dir, f"capture_{os.getpid()}_{self.captures}")
        else:
            logdir = tempfile.mkdtemp(prefix="obs_trace_")
        now = time.monotonic()
        self.last = {"state": "capturing", "logdir": logdir, "steps": n,
                     "t_trigger": round(now, 4)}
        self._job = {"n": n, "deadline": now + self._timeout_s,
                     "rec": {"logdir": logdir, "steps_requested": n, "t_trigger": round(now, 4)}}
        return dict(self.last)

    def status(self) -> dict:
        return dict(self.last)

    def _counters(self) -> dict:
        return dict(self._counters_fn()) if self._counters_fn is not None else {}

    def tick(self, step: int) -> None:
        """A step or fused-call boundary on the learner thread: start an armed
        capture, or stop a running one ``n`` steps after it started (or at
        its deadline)."""
        job = self._job
        if job is None:
            return
        now = time.monotonic()
        rec = job["rec"]
        job["last"] = step
        if "prof" not in job:
            from ape_x_dqn_tpu_torch.utils.profiling import start_trace

            self._beat()
            job["prof"] = start_trace()
            self._beat()
            rec["trace_started"] = job["prof"] is not None
            t0 = time.monotonic()
            rec["cost"] = {"start_ms": round((t0 - now) * 1e3, 3)}
            job.update(c0=self._counters(), start=step, t0=t0,
                       deadline=t0 + self._timeout_s)
            if job["prof"] is None:
                self._finish(job, "unavailable")
            return
        if step < job["start"] + job["n"] and now < job["deadline"]:
            return
        self._stop(job, step)

    def close(self) -> None:
        """The learner stops: a running capture stops here (learner thread),
        an armed one is dropped."""
        job = self._job
        if job is None:
            return
        if "prof" in job:
            self._stop(job, job["last"])
        else:
            self._finish(job, "error", reason="the learner stopped before the capture began")

    def _stop(self, job: dict, step: int) -> None:
        from ape_x_dqn_tpu_torch.utils.profiling import stop_trace

        self._job = None
        self._beat()
        t0 = time.monotonic()
        stopped = stop_trace(job["prof"])
        t1 = time.monotonic()
        self._beat()
        rec = job["rec"]
        rec["cost"]["stop_ms"] = round((t1 - t0) * 1e3, 3)
        c1 = self._counters()
        rec["counters"] = {k: c1[k] - job["c0"].get(k, 0) for k in c1}
        rec["steps_traced"] = step - job["start"]
        rec["window_s"] = round(t0 - job["t0"], 3)
        if not stopped:
            self._finish(job, "error", reason="torch.profiler stop failed")
            return
        threading.Thread(target=self._write, args=(job,), name="obs-trace-capture",
                         daemon=True).start()

    def _write(self, job: dict) -> None:
        """The capture's thread: the Chrome trace, then its summary in a
        child process."""
        from ape_x_dqn_tpu_torch.utils.profiling import export_trace

        rec, cost = job["rec"], job["rec"]["cost"]
        try:
            t0 = time.monotonic()
            path = export_trace(job.pop("prof"), rec["logdir"])
            t1 = time.monotonic()
            cost["export_ms"] = round((t1 - t0) * 1e3, 3)
            cost["trace_bytes"] = os.path.getsize(path)
            rec["summary"] = summarize_in_child(path)
            cost["summary_ms"] = round((time.monotonic() - t1) * 1e3, 3)
            with open(os.path.join(rec["logdir"], "summary.json"), "w") as f:
                json.dump(rec, f, default=str)
            self._finish(job, "done")
        except Exception as e:  # noqa: BLE001 — a capture must never end the run
            self._finish(job, "error", reason=f"{type(e).__name__}: {e}")

    def _finish(self, job: dict, state: str, reason: Optional[str] = None) -> None:
        rec = job["rec"]
        rec["state"] = state
        if reason:
            rec["reason"] = reason
        rec["t_done"] = round(time.monotonic(), 4)
        self._job = None
        self.last = rec
        with self._lock:
            self._busy = False


if __name__ == "__main__":
    # The summary's child process (``summarize_in_child``): one Chrome trace
    # in, its summary as one JSON object on stdout.  It is background work
    # (~20 s of one core for a 2048-step call of config3's learner), so it
    # runs below the learner, its pump and the actor workers.
    os.nice(SUMMARY_NICE)
    print(json.dumps(summarize(sys.argv[1])))
