"""Structured metrics: rate counters and a JSONL stream.

Port of the JSONL subset of ``ape_x_dqn_tpu/utils/metrics.py``:
``RateCounter`` and ``MetricLogger`` (``log`` accumulates scalars, ``emit``
writes one record of their mean/min/max/count plus extra fields, stamped
with a per-process ``seq`` and the ``pid``).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict, deque
from typing import IO, Dict, Optional


class RateCounter:
    """Events/second over a sliding window."""

    def __init__(self, window_s: float = 10.0):
        self._window = window_s
        self._events: deque[tuple[float, float]] = deque()  # (time, count)
        self._born = time.monotonic()
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, n))
            cutoff = now - self._window
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    def rate(self) -> float:
        now = time.monotonic()
        with self._lock:
            cutoff = now - self._window
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()
            if not self._events:
                return 0.0
            # Fixed-window denominator clamped to the counter's age: bursty
            # arrivals must not read as an inflated rate.
            span = max(min(self._window, now - self._born), 1e-3)
            return sum(n for _, n in self._events) / span


class MetricLogger:
    """Aggregate scalars between emits; write one JSONL record per emit.
    Thread-safe; writers share one logger."""

    def __init__(self, stream: Optional[IO] = None):
        self._stream = stream if stream is not None else sys.stdout
        self._acc: Dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._start = time.monotonic()

    def log(self, name: str, value: float) -> None:
        with self._lock:
            self._acc[name].append(float(value))

    def emit(self, **extra) -> dict:
        with self._lock:
            record: dict = {"t": round(time.monotonic() - self._start, 3)}
            for name, vals in self._acc.items():
                if not vals:
                    continue
                if len(vals) == 1:
                    record[name] = vals[0]
                else:
                    record[name] = sum(vals) / len(vals)
                    record[f"{name}/max"] = max(vals)
                    record[f"{name}/min"] = min(vals)
                    record[f"{name}/n"] = len(vals)
            self._acc.clear()
            record.update(extra)
            record.setdefault("seq", next(self._seq))
            record.setdefault("pid", os.getpid())
            self._stream.write(json.dumps(record) + "\n")
            self._stream.flush()
        return record
