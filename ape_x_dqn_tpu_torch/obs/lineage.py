"""Cross-tier trace spans and latency-bucket exemplars.

Port of ``TraceSpanLog`` and ``BucketExemplars`` from
``ape_x_dqn_tpu/obs/lineage.py`` (:51-155), the two pieces the serving
wire records into: a connection whose hello sets ``HELLO_FLAG_TRACE``
prefixes each request with a trace id, and every hop that handles it
records one span here.  A trace id of 0 means "not sampled" and records
nothing, so call sites stay unconditional.  ``LineageTracker`` (the
experience lineage of one process) is not part of the port yet.
Standard library only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional


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
