"""Per-stage wall-clock accumulators and the device trace.

Port of ``StageTimer`` (``ape_x_dqn_tpu/utils/profiling.py:33-70``): the
async host-replay loop times ``sample+place``, ``step_dispatch``,
``priority_writeback`` and ``publish`` (and ``eval`` when it runs) and
exports µs per call as ``stage_us`` in its JSONL.  Stage times are host
times: a step that only enqueues device work reads short in
``step_dispatch``, and the wait shows up wherever the host next reads a
device value (the write-back's priority read, a log emit).

The timer is also the port's span recorder: every stage is kept in a
bounded ring with its parent, and the fused loops' ``call`` span gathers a
record of each fused call, to which the graph runner's stream clock
(``runtime/graphed_call.StreamClock``) adds the call's device time and
the stream's idle gaps, each charged to the learner thread's spans over
the host time it lasted.  The runtime makes its timer the process's
current one (``current_timer``), where the fused learners, the graph
runner, the serving batcher and the benchmark's readers find it.

``trace(logdir)`` (JAX :93-118) records CPU and CUDA activity with
``torch.profiler`` and writes a Chrome trace into ``logdir``
(``train --profile-dir``, ``obs/trace.TraceOnDemand``).  JAX's
``start_server`` (:121) has no torch counterpart: ``torch.profiler`` has
no live server to attach to.  The subtractive timings are not ported.

On a card, ``start_trace`` and ``stop_trace`` set three things up for the
learners' CUDA graphs:

  * CUPTI stays attached between traces (``TEARDOWN_CUPTI=0``): CUPTI torn
    down after one trace and set up again for the next, beside graph
    launches, is what ``torch.profiler`` itself avoids for its own CUDA
    graphs ("CUDA Graph does not work well with CUPTI teardown").
  * A larger cap on CUPTI's activity buffers (``kineto.conf`` beside this
    file, named by ``KINETO_CONFIG`` unless the caller set it, and read
    when the first trace of the process sets the profiler up): at the
    default cap a window of ~9 * 10^5 kernels lost records from its second
    trace in a process on.
  * ``EDGE_MARGIN_S`` of an idle device at both edges of the window: the
    profiler keeps only records stamped between its start and its stop,
    and a card's kernel timestamps, mapped onto the host's clock, can lie
    a few ms to either side of the host's, so a kernel launched right
    after the start, or ending right before the stop, could be dropped.
  * ``LEAD_KERNELS`` throwaway kernels (a ``fill_``) right after the start:
    a trace that follows a large one in the process loses its first few
    device records, with or without the settings above; these take their
    place.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from array import array
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple


# The span ring's length: ~10 s of the fused learner's ~3 000 spans a
# second, more than one call's and the ~17 ms the stream readings lag.
SPAN_CAPACITY = 32768
# Finished call records kept: ~17 minutes at K = 1024 on the card, where a
# call takes ~1.1 s; the learner_timeline section aggregates over them.
CALL_CAPACITY = 1024
# Serving requests' queue waits kept (1 000–2 300 a second in a central
# cell on the card).
WAIT_CAPACITY = 1 << 18
# The span whose entry opens a call record, and what a thread does with
# no span open.
CALL = "call"
OTHER = "other"
# The spans at every graph replay open no profiler range: the trace names
# their host work by its CUDA call already (``cudaGraphLaunch``,
# ``cudaEventSynchronize``), and three ranges a step under CUDA-only
# activity, where torch keeps none, ran traced stretches of config5's
# learner at 343–371 steps/s against 509–539 without them (NVIDIA H100
# 80GB HBM3, 700 W).
PER_REPLAY = frozenset({"tick", "pace_wait", "replay"})
_OPEN = float("inf")

_current: Optional["StageTimer"] = None


def current_timer() -> "StageTimer":
    """The process's current ``StageTimer``: the one last made current
    (``StageTimer.make_current``; the runtime makes its own current when it
    is built), else a default one.  A reader finds the timeline here with
    no handle on whoever records into it."""
    global _current
    if _current is None:
        _current = StageTimer()
    return _current


def profiler_active() -> bool:
    """torch.autograd's profiler-enabled flag: a ``torch.profiler`` capture
    is running in this process (False while torch is not imported)."""
    return bool(getattr(sys.modules.get("torch.autograd.profiler"), "_is_profiler_enabled",
                        False))


class _Span:
    """One ``StageTimer.stage``; ``rows`` and ``blocks``, where the body
    sets them, are added to the call it lies in."""

    __slots__ = ("_timer", "name", "id", "t0", "rows", "blocks", "_rf", "_stack")

    def __init__(self, timer: "StageTimer", name: str):
        self._timer, self.name = timer, name
        self.rows = self.blocks = 0
        self._rf = None

    def __enter__(self) -> "_Span":
        self._timer._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._timer._exit(self)
        return False


class StageTimer:
    """Named wall-clock spans: ``with timer.stage("sample"): ...``.

    Each span adds to per-name totals (``us_per_call``, the JSONL's and
    ``/varz``'s ``stage_us``) and is kept, as (name, t0, t1, parent, thread),
    in a preallocated ring of ``capacity`` spans, times by
    ``time.monotonic()``.  A span named ``call`` opens a call record:
    the host ms of the spans inside it by name, the rows and blocks they
    set, whether a ``torch.profiler`` capture was active at any span edge
    of it (``profiled``), and what the learner's stream clock
    (``runtime/graphed_call.StreamClock``) reads of its device work
    (``device_reading``).  A record is finished, and kept in ``calls``,
    once its span has closed and its last device reading has come in.
    While a profiler is active each span but the per-replay ones
    (``PER_REPLAY``) is also a ``torch.profiler.record_function`` range
    ``apex.<name>``.
    ``queue_wait`` keeps the serving tier's request waits.  One uncontended
    lock acquire when a span closes: the totals' ``+=`` on a dict item is a
    read-modify-write, not atomic under CPython.
    """

    def __init__(self, capacity: int = SPAN_CAPACITY, clock: Callable[[], float] = time.monotonic):
        self._total_s: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.now = clock
        self.capacity = int(capacity)
        n = self.capacity
        self._ids = [-1] * n
        self._names: List[Optional[str]] = [None] * n
        self._t0s = [0.0] * n
        self._t1s = [0.0] * n
        self._parents = [-1] * n
        self._tids = [0] * n
        self._next = 0
        self._seq = itertools.count()
        self._local = threading.local()
        self.call: Optional[dict] = None      # the open call record
        self._calls_opened = 0
        self.calls: Deque[dict] = deque(maxlen=CALL_CAPACITY)
        self._wait_t = array("d", bytes(8 * WAIT_CAPACITY))
        self._wait_s = array("d", bytes(8 * WAIT_CAPACITY))
        self._waits = 0
        self._hint = 0

    def make_current(self) -> "StageTimer":
        global _current
        _current = self
        return self

    # -- spans ------------------------------------------------------------

    def stage(self, name: str) -> _Span:
        return _Span(self, name)

    def _enter(self, span: _Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        tid = threading.get_ident()
        # A slot is written by the thread whose id it is, so no lock: ids
        # follow start times up to another thread's entry in between, and
        # the readers follow one thread's spans.
        i = next(self._seq)
        t0 = self.now()
        k = i % self.capacity
        self._names[k], self._t0s[k], self._t1s[k] = span.name, t0, _OPEN
        self._parents[k], self._tids[k] = stack[-1] if stack else -1, tid
        self._ids[k] = i
        self._next = max(self._next, i + 1)
        stack.append(i)
        span.id, span.t0, span._stack = i, t0, stack
        profiled = profiler_active()
        if span.name == CALL and self.call is None:
            self._calls_opened += 1
            self.call = _call_record(self._calls_opened, tid, t0, profiled)
        if profiled:
            self._note_profiled(tid)
            if span.name not in PER_REPLAY:
                import torch

                span._rf = torch.autograd.profiler.record_function("apex." + span.name)
                span._rf.__enter__()

    def _exit(self, span: _Span) -> None:
        t1 = self.now()
        if span._rf is not None:
            span._rf.__exit__(None, None, None)
        tid = threading.get_ident()
        if profiler_active():
            self._note_profiled(tid)
        name, dt = span.name, t1 - span.t0
        with self._lock:
            k = span.id % self.capacity
            if self._ids[k] == span.id:
                self._t1s[k] = t1
            self._total_s[name] += dt
            self._count[name] += 1
        span._stack.pop()
        rec = self.call
        if rec is None or rec["tid"] != tid:
            return
        if name == CALL:
            rec["t1"] = t1
            self.call = None
            self._maybe_finish(rec)
            return
        host = rec["host_ms"]
        host[name] = host.get(name, 0.0) + dt * 1e3
        if span.rows or span.blocks:
            rows = rec["rows"].setdefault(name, [0, 0])
            rows[0] += span.rows
            rows[1] += span.blocks

    def closed(self, spans: Sequence[Tuple[str, float, float]]) -> None:
        """Spans of this thread that have already ended, in order, each
        inside its open span and holding none, times from ``now()``: the
        graph runner's per-replay spans (``PER_REPLAY``, which open no
        profiler range), recorded with one call a replay instead of one
        ``stage`` each."""
        stack = getattr(self._local, "stack", None) or ()
        parent = stack[-1] if stack else -1
        tid = threading.get_ident()
        if profiler_active():
            self._note_profiled(tid)
        cap = self.capacity
        with self._lock:
            for name, t0, t1 in spans:
                i = next(self._seq)
                k = i % cap
                self._names[k], self._t0s[k], self._t1s[k] = name, t0, t1
                self._parents[k], self._tids[k], self._ids[k] = parent, tid, i
                self._total_s[name] += t1 - t0
                self._count[name] += 1
            self._next = max(self._next, i + 1)
        rec = self.call
        if rec is not None and rec["tid"] == tid:
            host = rec["host_ms"]
            for name, t0, t1 in spans:
                host[name] = host.get(name, 0.0) + (t1 - t0) * 1e3

    def call_step(self, step: int) -> None:
        """The learner step the open call starts from."""
        rec = self.call
        if rec is not None and rec["step"] is None:
            rec["step"] = int(step)

    def _note_profiled(self, tid: int) -> None:
        rec = self.call
        if rec is not None and rec["tid"] == tid:
            rec["profiled"] = True

    def spans(self) -> List[Tuple[str, float, float, int, int]]:
        """The ring's spans, oldest first: (name, t0, t1, parent id, own
        id); an open span's t1 is inf, a parent of -1 is none."""
        with self._lock:
            first = max(0, self._next - self.capacity)
            out = []
            for i in range(first, self._next):
                k = i % self.capacity
                out.append((self._names[k], self._t0s[k], self._t1s[k], self._parents[k], i))
        return out

    def charge(self, a: float, b: float, tid: int) -> Dict[str, float]:
        """Seconds of [a, b] by the innermost span of thread ``tid`` open
        over each part (a span's self time: its duration less its
        children's), ``OTHER`` where none was; what the ring no longer
        holds counts as ``OTHER`` too.  Called by one thread (the one that
        reads the stream's clock), from nearly increasing times."""
        out: Dict[str, float] = {}
        if b <= a:
            return out
        last = self._next
        first = max(0, last - self.capacity)
        if last <= first:
            return {OTHER: b - a}
        j = self._last_entered(a, first, last)
        stack = self._open_at(j, a, tid, first)
        t, i = a, j + 1
        cap, t0s, t1s, tids, names = self.capacity, self._t0s, self._t1s, self._tids, self._names
        while t < b:
            nxt_close = t1s[stack[-1] % cap] if stack else _OPEN
            while i < last and tids[i % cap] != tid:
                i += 1
            nxt_enter = t0s[i % cap] if i < last else _OPEN
            edge = min(nxt_close, nxt_enter, b)
            if edge > t:
                who = names[stack[-1] % cap] if stack else OTHER
                out[who] = out.get(who, 0.0) + edge - t
                t = edge
            if edge == b:
                break
            if nxt_close <= nxt_enter:
                stack.pop()
            else:
                stack.append(i)
                i += 1
        self._hint = j
        return out

    def _last_entered(self, a: float, first: int, last: int) -> int:
        """The id of the last span entered at or before ``a`` (first - 1
        if none): a forward walk from the last query's answer, else a
        binary search (ids follow start times)."""
        cap, t0s = self.capacity, self._t0s
        lo, hi, j = first, last, self._hint
        if first <= j < last and t0s[j % cap] <= a:
            for _ in range(64):
                if j + 1 == last or t0s[(j + 1) % cap] > a:
                    return j
                j += 1
            lo = j
        while lo < hi:
            mid = (lo + hi) // 2
            if t0s[mid % cap] <= a:
                lo = mid + 1
            else:
                hi = mid
        return lo - 1

    def _open_at(self, j: int, a: float, tid: int, first: int) -> List[int]:
        """The ids of ``tid``'s spans open at ``a``, outermost first: the
        last of its spans entered by then and its ancestors, those not yet
        closed."""
        cap = self.capacity
        while j >= first and self._tids[j % cap] != tid:
            j -= 1
        chain = []
        while j >= first and self._ids[j % cap] == j:
            if self._t1s[j % cap] > a:
                chain.append(j)
            j = self._parents[j % cap]
        chain.reverse()
        return chain

    # -- call records -----------------------------------------------------

    def device_reading(self, rec: Optional[dict], start: bool, replay: bool, steps: int,
                       ms: float, t_issue: float, tid: int) -> None:
        """One reading of the learner's stream for call ``rec``: with
        ``start``, the idle gap (ms) before a piece issued at host time
        ``t_issue``, charged to the spans ``tid`` had open over
        [t_issue - gap, t_issue]; else a piece's device ms (a graph replay
        of ``steps`` steps, or eager work)."""
        if rec is None:
            return
        if start:
            if ms > 0.0:
                idle = rec["idle_by_span"]
                for name, s in self.charge(t_issue - ms / 1e3, t_issue, tid).items():
                    idle[name] = idle.get(name, 0.0) + s * 1e3
                if rec["read"] == 0:
                    rec["lead_gap_ms"] += ms
                else:
                    rec["gap_ms"] += ms
        elif replay:
            rec["replay_ms"] += ms
            rec["replays"] += 1
            rec["steps"] += steps
        else:
            rec["eager_ms"] += ms
        rec["read"] += 1
        self._maybe_finish(rec)

    def _maybe_finish(self, rec: dict) -> None:
        if rec["t1"] is not None and rec["read"] == rec["marks"] and not rec["done"]:
            rec["done"] = True
            with self._lock:
                self.calls.append(rec)

    def finished_calls(self) -> List[dict]:
        with self._lock:
            return list(self.calls)

    def whole_calls(self) -> List[dict]:
        """Finished calls less those a ``torch.profiler`` capture touched
        (``profiled``) and the call right after each of them (the
        profiler's stop stalls the learner)."""
        calls = self.finished_calls()
        touched = {c["seq"] for c in calls if c["profiled"]}
        return [c for c in calls if not c["profiled"] and c["seq"] - 1 not in touched]

    def timeline(self, newest: int = 64) -> dict:
        """The operator's view of the learner (the JSONL's and ``/varz``'s
        ``learner_timeline``): over the whole calls with device readings,
        the learner stream's device ms per step, its idle share and the
        idle ms by the host span that held it; and the newest calls' rows."""
        timed = [c for c in self.whole_calls() if c["replays"]]
        steps = sum(c["steps"] for c in timed)
        replay = sum(c["replay_ms"] for c in timed)
        idle = sum(c["lead_gap_ms"] + c["gap_ms"] for c in timed)
        span = replay + idle + sum(c["eager_ms"] for c in timed)
        by: Dict[str, float] = {}
        for c in timed:
            for name, ms in c["idle_by_span"].items():
                by[name] = by.get(name, 0.0) + ms
        rows = [{"step": c["step"], "device_ms": round(c["replay_ms"], 3),
                 "idle_ms": round(c["lead_gap_ms"] + c["gap_ms"], 3),
                 "ingest_ms": round(c["host_ms"].get("ingest", 0.0), 3),
                 "ingest_rows": c["rows"].get("ingest", [0, 0])[0],
                 "ingest_blocks": c["rows"].get("ingest", [0, 0])[1],
                 "profiled": c["profiled"]}
                for c in self.finished_calls()[-newest:]]
        return {"calls": len(timed),
                "device_ms_per_step": round(replay / steps, 5) if steps else None,
                "idle_share": round(idle / span, 5) if span else None,
                "idle_ms_by_span": {k: round(v, 3) for k, v in
                                    sorted(by.items(), key=lambda kv: -kv[1])},
                "calls_newest": rows}

    # -- the serving tier -------------------------------------------------

    def queue_wait(self, t: float, waits: Sequence[float]) -> None:
        """Requests' queue waits (s) that ended at host time ``t``."""
        with self._lock:
            n = self._waits
            for w in waits:
                k = n % WAIT_CAPACITY
                self._wait_t[k], self._wait_s[k] = t, w
                n += 1
            self._waits = n

    def queue_waits(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        """(end time, wait s) of the kept waits that ended inside [t0, t1]."""
        with self._lock:
            ks = [i % WAIT_CAPACITY for i in range(max(0, self._waits - WAIT_CAPACITY),
                                                   self._waits)]
            return [(self._wait_t[k], self._wait_s[k]) for k in ks
                    if t0 <= self._wait_t[k] <= t1]

    # -- totals -----------------------------------------------------------

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._total_s[name] += seconds
            self._count[name] += 1

    def totals(self) -> Tuple[Dict[str, float], Dict[str, int]]:
        """Copies of the seconds and the call counts per stage, so a reader
        can take the means of a window between two snapshots."""
        with self._lock:
            return dict(self._total_s), dict(self._count)

    def us_per_call(self) -> Dict[str, float]:
        with self._lock:
            totals, counts = dict(self._total_s), dict(self._count)
        return {
            name: round(totals[name] / max(1, counts[name]) * 1e6, 1)
            for name in totals
        }


def _call_record(seq: int, tid: int, t0: float, profiled: bool) -> dict:
    """A call's record: host fields filled as its spans close, device
    fields by ``device_reading`` (ms of the learner's stream: ``replay_ms``
    over ``replays`` replays of ``steps`` steps, ``eager_ms`` of eager
    pieces, ``lead_gap_ms`` idle before its first piece, ``gap_ms`` idle
    between its pieces, ``idle_by_span`` those gaps by host span);
    ``marks`` stream events recorded for it, ``read`` of them read."""
    return {"seq": seq, "tid": tid, "t0": t0, "t1": None, "profiled": profiled,
            "annotated": profiled, "step": None, "host_ms": {}, "rows": {},
            "replays": 0, "steps": 0, "replay_ms": 0.0, "eager_ms": 0.0,
            "lead_gap_ms": 0.0, "gap_ms": 0.0, "idle_by_span": {},
            "marks": 0, "read": 0, "done": False}


TRACE_FILE = "trace.json"
KINETO_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kineto.conf")
EDGE_MARGIN_S = 0.05
LEAD_KERNELS = 16


def start_trace():
    """A started ``torch.profiler`` recording CPU activity, and CUDA
    activity where a card is visible; None when it could not start (a
    profiler must never end a training run: a warning on stderr).  With a
    card, the device is synchronized first, so the trace holds no work
    launched before it, and the settings of the module docstring apply."""
    import torch

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.environ["TEARDOWN_CUPTI"] = "0"
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
        os.environ.setdefault("KINETO_CONFIG", KINETO_CONFIG)
    try:
        if cuda:
            torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        if cuda:
            lead = torch.empty(1, device=torch.cuda.current_device())
            for _ in range(LEAD_KERNELS):
                lead.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(EDGE_MARGIN_S)
        return prof
    except Exception as e:  # noqa: BLE001 — see the docstring
        print(f"WARNING: torch.profiler trace unavailable ({e}); continuing", file=sys.stderr)
        return None


def stop_trace(prof) -> bool:
    """Stop a profiler from ``start_trace`` (this synchronizes the device,
    and with a card waits ``EDGE_MARGIN_S`` after that); False, with a
    warning, when it failed."""
    import torch

    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(EDGE_MARGIN_S)
        prof.stop()
        return True
    except Exception as e:  # noqa: BLE001 — see start_trace
        print(f"WARNING: torch.profiler stop failed ({e})", file=sys.stderr)
        return False


def export_trace(prof, logdir: str) -> str:
    """Write a stopped profiler's Chrome trace to ``logdir/trace.json``."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[Optional[object]]:
    """``torch.profiler`` over the body (``start_trace``), its Chrome trace
    written to ``logdir/trace.json`` at exit (``obs.trace.summarize``
    reads it).  Yields the profiler, or None when tracing is off or could
    not start."""
    prof = start_trace() if enabled else None
    try:
        yield prof
    finally:
        if prof is not None and stop_trace(prof):
            try:
                export_trace(prof, logdir)
            except OSError as e:
                print(f"WARNING: the Chrome trace was not written ({e})", file=sys.stderr)
