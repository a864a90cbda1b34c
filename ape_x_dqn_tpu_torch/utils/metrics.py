"""Structured metrics: rate counters and a JSONL stream.

Port of the JSONL subset of ``ape_x_dqn_tpu/utils/metrics.py``:
``RateCounter``, ``TransportStats`` (the process-actor pool's counters)
and ``MetricLogger`` (``log`` accumulates scalars, ``emit`` writes one
record of their mean/min/max/count plus extra fields, stamped with a
per-process ``seq`` and the ``pid``, to a stream and optionally to a file,
one JSONL record per emit, appended).
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


class TransportStats:
    """Experience-transport counters of the process-actor pool: chunks,
    bytes and transitions drained, send→drain latency, and the salvage
    counts of dead incarnations (committed records recovered; torn tails
    detected).  The subset of the JAX package's ``TransportStats``
    (``utils/metrics.py:271``) that the pool feeds; latency percentiles come
    from the most recent ``latency_window`` chunks.  Written by the one
    drain thread."""

    def __init__(self, latency_window: int = 4096):
        self._latency: deque[float] = deque(maxlen=latency_window)
        self.latency_max_s = 0.0
        self.chunks = 0
        self.bytes = 0
        self.transitions = 0
        self.salvaged_records = 0
        self.torn_records = 0

    def record_chunk(self, nbytes: int, latency_s: float, transitions: int) -> None:
        self.chunks += 1
        self.bytes += int(nbytes)
        self.transitions += int(transitions)
        lat = max(0.0, latency_s)  # a negative delta can only be clock skew
        self._latency.append(lat)
        self.latency_max_s = max(self.latency_max_s, lat)

    def count_salvage(self, records: int, torn: bool) -> None:
        self.salvaged_records += int(records)
        if torn:
            self.torn_records += 1

    def summary(self) -> dict:
        lat = sorted(self._latency)

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p / 100 * len(lat)))] * 1e3, 3)

        return {
            "chunks": self.chunks,
            "bytes": self.bytes,
            "transitions": self.transitions,
            "chunk_latency_ms": ({"p50_ms": pct(50), "p99_ms": pct(99),
                                  "max_ms": round(self.latency_max_s * 1e3, 3)}
                                 if lat else {}),
            "salvaged_records": self.salvaged_records,
            "torn_records": self.torn_records,
        }


class MetricLogger:
    """Aggregate scalars between emits; write one JSONL record per emit.
    Thread-safe; writers share one logger."""

    def __init__(self, stream: Optional[IO] = None, path: Optional[str] = None):
        self._streams: list[IO] = [stream] if stream is not None else []
        self._file = open(path, "a") if path else None
        if self._file:
            self._streams.append(self._file)
        if not self._streams:
            self._streams.append(sys.stdout)
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
            line = json.dumps(record) + "\n"
            for out in self._streams:
                out.write(line)
                out.flush()
        return record

    def close(self) -> None:
        """Close the file sink (the stream belongs to the caller)."""
        if self._file:
            self._file.close()
