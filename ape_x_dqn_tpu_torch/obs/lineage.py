"""Experience lineage, cross-tier trace spans and latency-bucket exemplars.

Port of ``ape_x_dqn_tpu/obs/lineage.py``:

  * ``TraceSpanLog`` and ``BucketExemplars`` (:51-155), the two pieces the
    serving wire records into: a connection whose hello sets
    ``HELLO_FLAG_TRACE`` prefixes each request with a trace id, and every
    hop that handles it records one span here.  A trace id of 0 means "not
    sampled" and records nothing, so call sites stay unconditional.
  * ``LineageTracker`` (:156): a sampled chunk from the actor's flush to
    the train step that consumed it.  The actor stamps a random 63-bit id
    on a fraction ``obs.trace_sample_rate`` of its chunks (the wire
    envelope carries it); ``on_ingest`` (the slots the replay gave the
    chunk), ``on_sample`` (a learner batch's slots) and ``on_trained``
    (the deferred priority write-back: the step's device work is done)
    stamp its span, and a completed trace emits one ``lineage_span``
    event with monotone CLOCK_MONOTONIC times.  Every ingested slot's
    birth time is kept, and every sampled batch records its true ages
    into a histogram.  The host-replay path only: the fused device ring
    never surfaces sample indices to the host.

Standard library and numpy only: no torch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

# Span keys in hand-off order; a finished span is monotone over them.
SPAN_ORDER = ("t_act", "t_ingest", "t_first_sample", "t_trained")


class TraceSpanLog:
    """Bounded per-process log of trace spans: ``{trace_id, hop, pid,
    t0_s, t1_s, dur_ms, ...}`` with CLOCK_MONOTONIC stamps.  ``emit``
    (``callable(name, **fields)``) and ``recorder`` (an object with
    ``record(name, **fields)``) mirror each span; their failures never
    reach the caller.  Thread-safe."""

    def __init__(self, depth: int = 128, emit=None, recorder=None):
        self._spans: deque = deque(maxlen=int(depth))
        self._emit = emit
        self._recorder = recorder
        self._lock = threading.Lock()
        self.recorded = 0

    def record(self, trace_id: int, hop: str, t0: float,
               t1: Optional[float] = None, **meta) -> Optional[dict]:
        """One completed hop; None (nothing recorded) for trace id 0."""
        if not trace_id:
            return None
        t1 = float(t1 if t1 is not None else time.monotonic())
        span = {
            "trace_id": int(trace_id), "hop": hop, "pid": os.getpid(),
            "t0_s": round(float(t0), 6), "t1_s": round(t1, 6),
            "dur_ms": round((t1 - float(t0)) * 1e3, 3), **meta,
        }
        with self._lock:
            self._spans.append(span)
            self.recorded += 1
        for sink in (getattr(self._recorder, "record", None), self._emit):
            if sink is not None:
                try:
                    sink("trace_span", **span)
                except Exception:  # noqa: BLE001 — tracing must not kill a run
                    pass
        return span

    def snapshot(self) -> dict:
        """``{"recorded": n, "spans": [...recent spans]}``."""
        with self._lock:
            return {"recorded": self.recorded, "spans": list(self._spans)}


class BucketExemplars:
    """Newest sampled trace id per bucket of a ``LatencyHistogram``, keyed
    by the bucket label the sample's count landed in; at most
    ``max_buckets`` labels, oldest first out.  Trace id 0 records nothing.
    Thread-safe."""

    def __init__(self, hist, max_buckets: int = 64):
        self._hist = hist
        self._max = int(max_buckets)
        self._by_edge: Dict[str, int] = {}
        self._order: deque = deque()
        self._lock = threading.Lock()
        self.recorded = 0

    def record(self, seconds: float, trace_id: int) -> None:
        if not trace_id:
            return
        edge = self._hist.bucket_edge(seconds)
        with self._lock:
            if edge not in self._by_edge:
                self._order.append(edge)
                while len(self._order) > self._max:
                    self._by_edge.pop(self._order.popleft(), None)
            self._by_edge[edge] = int(trace_id)
            self.recorded += 1

    def snapshot(self) -> Dict[str, int]:
        """{bucket label: newest trace id}."""
        with self._lock:
            return dict(self._by_edge)


class LineageTracker:
    """Per-slot birth times, the age-at-sample histogram and the open
    traces of one replay of ``capacity`` slots.  ``on_ingest`` runs on the
    actor or pump thread, ``on_sample`` and ``on_trained`` on the learner
    thread: one lock, batched calls only."""

    def __init__(self, capacity: int, emit=None, max_open_traces: int = 512,
                 keep_completed: int = 16):
        self.capacity = int(capacity)
        self._emit = emit  # callable(name, **fields), e.g. MetricLogger.event
        self._birth = np.zeros(self.capacity, np.float64)  # 0 = never filled
        self._traced = np.zeros(self.capacity, bool)
        self._slot_trace: Dict[int, int] = {}   # slot -> open trace id
        self._open: Dict[int, dict] = {}
        self._max_open = int(max_open_traces)
        self._completed: deque = deque(maxlen=int(keep_completed))
        self.completed_count = 0
        self.abandoned_count = 0   # traces whose slots were recycled first
        # A producer on another host stamps its own monotonic clock: a
        # ``t_act`` in this host's future is clamped to ingest and counted.
        self.clock_skew_clamped = 0
        self._lock = threading.Lock()
        self.age_hist = LatencyHistogram(min_s=1e-3, max_s=7200.0, per_decade=10)
        self.span_hists = {
            "act_to_ingest": LatencyHistogram(min_s=1e-4, max_s=3600.0),
            "ingest_to_first_sample": LatencyHistogram(min_s=1e-4, max_s=7200.0),
            "act_to_trained": LatencyHistogram(min_s=1e-4, max_s=7200.0),
        }

    def on_ingest(self, indices, t_act: Optional[float] = None, trace_id: int = 0,
                  wid: Optional[int] = None) -> None:
        """A chunk landed in replay slots ``indices``; ``t_act`` is the
        producer's send time (the wire's ``sent_t``), a nonzero
        ``trace_id`` marks the chunk traced."""
        idx = np.asarray(indices, np.int64)
        if idx.size == 0:
            return
        now = time.monotonic()
        if t_act is not None and t_act > now:
            t_act = now
            with self._lock:
                self.clock_skew_clamped += 1
        with self._lock:
            # An overwrite before its trace closed abandons that trace.
            if self._traced[idx].any():
                for s in idx[self._traced[idx]]:
                    self._abandon_slot_locked(int(s))
            self._birth[idx] = now
            if trace_id:
                if len(self._open) >= self._max_open:
                    self._drop_trace_locked(next(iter(self._open)), abandoned=True)
                self._open[int(trace_id)] = {
                    "trace_id": int(trace_id),
                    "wid": wid,
                    "slots": idx.copy(),
                    "t_act": float(t_act) if t_act is not None else now,
                    "t_ingest": now,
                    "rows": int(idx.size),
                }
                self._traced[idx] = True
                for s in idx:
                    self._slot_trace[int(s)] = int(trace_id)

    def on_sample(self, indices) -> None:
        """A prioritized batch was sampled at these slots."""
        idx = np.asarray(indices, np.int64)
        if idx.size == 0:
            return
        now = time.monotonic()
        births = self._birth[idx]
        for age in (now - births[births > 0.0]):
            self.age_hist.record(float(age))
        if not self._traced[idx].any():
            return
        with self._lock:
            for s in idx[self._traced[idx]]:
                rec = self._open.get(self._slot_trace.get(int(s), -1))
                if rec is not None and "t_first_sample" not in rec:
                    rec["t_first_sample"] = now

    def on_trained(self, indices) -> None:
        """The train step that consumed these slots has completed."""
        idx = np.asarray(indices, np.int64)
        if idx.size == 0 or not self._traced[idx].any():
            return
        now = time.monotonic()
        done: List[dict] = []
        with self._lock:
            for s in idx[self._traced[idx]]:
                tid = self._slot_trace.get(int(s))
                rec = self._open.get(tid) if tid is not None else None
                if rec is None or "t_first_sample" not in rec:
                    continue
                rec["t_trained"] = now
                self._drop_trace_locked(tid, abandoned=False)
                done.append(rec)
        for rec in done:
            self._complete(rec)

    def trace_ids_for(self, indices) -> List[int]:
        """Open trace ids among these slots, deduplicated, first seen
        first."""
        idx = np.asarray(indices, np.int64)
        if idx.size == 0 or not self._traced[idx].any():
            return []
        out: List[int] = []
        with self._lock:
            for s in idx[self._traced[idx]]:
                tid = self._slot_trace.get(int(s))
                if tid is not None and tid not in out:
                    out.append(tid)
        return out

    def _abandon_slot_locked(self, slot: int) -> None:
        tid = self._slot_trace.get(slot)
        if tid is not None and tid in self._open:
            self._drop_trace_locked(tid, abandoned=True)

    def _drop_trace_locked(self, trace_id: int, abandoned: bool) -> None:
        rec = self._open.pop(trace_id, None)
        if rec is None:
            return
        slots = rec["slots"]
        self._traced[slots] = False
        for s in slots:
            self._slot_trace.pop(int(s), None)
        if abandoned:
            self.abandoned_count += 1

    def _complete(self, rec: dict) -> None:
        spans = {
            "act_to_ingest_ms": (rec["t_ingest"] - rec["t_act"]) * 1e3,
            "ingest_to_first_sample_ms": (rec["t_first_sample"] - rec["t_ingest"]) * 1e3,
            "first_sample_to_trained_ms": (rec["t_trained"] - rec["t_first_sample"]) * 1e3,
            "act_to_trained_ms": (rec["t_trained"] - rec["t_act"]) * 1e3,
        }
        self.span_hists["act_to_ingest"].record(max(0.0, rec["t_ingest"] - rec["t_act"]))
        self.span_hists["ingest_to_first_sample"].record(
            max(0.0, rec["t_first_sample"] - rec["t_ingest"]))
        self.span_hists["act_to_trained"].record(max(0.0, rec["t_trained"] - rec["t_act"]))
        event = {
            "trace_id": rec["trace_id"],
            "wid": rec["wid"],
            "rows": rec["rows"],
            **{k: round(rec[k], 6) for k in SPAN_ORDER},
            **{k: round(v, 3) for k, v in spans.items()},
        }
        self.completed_count += 1
        self._completed.append(event)
        if self._emit is not None:
            try:
                self._emit("lineage_span", **event)
            except Exception:  # noqa: BLE001 — tracing must not kill a run
                pass

    def summary(self, include_recent: bool = True) -> dict:
        """The ``/varz`` and JSONL ``lineage`` section: the age-at-sample
        distribution, span percentiles and trace counts; the JSONL emit
        leaves out the recent spans, which ride the stream as events."""
        with self._lock:
            open_n = len(self._open)
        age = self.age_hist.summary()
        age["buckets_s"] = self.age_hist.buckets()
        out = {
            "age_at_sample": age,
            "spans_ms": {k: h.summary() for k, h in self.span_hists.items() if h.count},
            "traces_open": open_n,
            "traces_completed": self.completed_count,
            "traces_abandoned": self.abandoned_count,
            "clock_skew_clamped": self.clock_skew_clamped,
        }
        if include_recent:
            out["recent_spans"] = list(self._completed)
        return out
