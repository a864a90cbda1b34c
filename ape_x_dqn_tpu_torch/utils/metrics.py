"""Structured metrics: rate counters, latency histograms and a JSONL stream.

Port of the JSONL subset of ``ape_x_dqn_tpu/utils/metrics.py``:
``RateCounter``, ``TransportStats`` (the process-actor pool's counters),
``LatencyHistogram`` with the merge arithmetic on its serialized forms
(``merge_bucket_dicts``, ``bucket_percentile``, ``merge_counter_maps``;
JAX :107-405, same bucket layout, so stats dicts merge across the two
packages) and ``MetricLogger`` (``log`` accumulates scalars, ``emit``
writes one record of their mean/min/max/count plus extra fields, ``event``
one out-of-band record, each stamped with a per-process ``seq`` and the
``pid``, to a stream and optionally to a file, appended), and the
loggerless ``emit_event`` (JAX :407-423) for code with no logger in scope:
the checkpoint restore paths' ``checkpoint_restore_missing_replay`` and
``degraded_restore``.
"""

from __future__ import annotations

import itertools
import json
import math
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
        self._total = 0.0
        self._born = time.monotonic()
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, n))
            self._total += n
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

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    def merge(self, other: "RateCounter") -> None:
        """Fold ``other``'s window in: events interleave by time, totals
        add."""
        with other._lock:
            events, total, born = list(other._events), other._total, other._born
        with self._lock:
            self._events = deque(sorted([*self._events, *events]))
            self._total += total
            self._born = min(self._born, born)


class LatencyHistogram:
    """Log-bucketed latency histogram: percentiles without storing samples.

    ``per_decade`` geometric buckets per power of ten between ``min_s`` and
    ``max_s``; bucket 0 is underflow, the last absorbs overflow.  A
    percentile is the upper edge of its bucket, clamped to the observed max
    (one bucket width of relative error, ~12 % at 20 per decade).
    Thread-safe."""

    def __init__(self, min_s: float = 1e-5, max_s: float = 120.0,
                 per_decade: int = 20):
        self._min = float(min_s)
        self._per = int(per_decade)
        n = int(math.ceil(math.log10(max_s / min_s) * per_decade))
        self._counts = [0] * (n + 2)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def _index(self, s: float) -> int:
        if s < self._min:
            return 0
        return min(1 + int(math.log10(s / self._min) * self._per),
                   len(self._counts) - 1)

    def record(self, seconds: float) -> None:
        s = float(seconds)
        i = self._index(s)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += s
            if s > self._max:
                self._max = s

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (seconds),
        clamped to the observed max; NaN when empty."""
        with self._lock:
            if self._count == 0:
                return float("nan")
            rank = max(1, math.ceil(p / 100.0 * self._count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    if i == 0:
                        return min(self._min, self._max)
                    return min(self._min * 10 ** (i / self._per), self._max)
            return self._max

    def _same_layout(self, other: "LatencyHistogram") -> bool:
        return (self._min, self._per, len(self._counts)) == (
            other._min, other._per, len(other._counts))

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` in; the bucket layouts must match."""
        if not self._same_layout(other):
            raise ValueError("cannot merge histograms with different bucket layouts")
        with other._lock:
            counts = list(other._counts)
            count, total, mx = other._count, other._sum, other._max
        with self._lock:
            self._counts = [a + b for a, b in zip(self._counts, counts)]
            self._count += count
            self._sum += total
            self._max = max(self._max, mx)

    def state_dict(self) -> dict:
        """The full state as plain types, to cross a process boundary."""
        with self._lock:
            return {"min_s": self._min, "per_decade": self._per,
                    "counts": list(self._counts), "count": self._count,
                    "sum": self._sum, "max": self._max}

    def merge_state(self, state: dict) -> bool:
        """Fold one shipped ``state_dict`` in; False (and nothing merged)
        when its bucket layout disagrees."""
        counts = state.get("counts")
        if (not counts or len(counts) != len(self._counts)
                or float(state.get("min_s", self._min)) != self._min
                or int(state.get("per_decade", self._per)) != self._per):
            return False
        with self._lock:
            self._counts = [a + int(b) for a, b in zip(self._counts, counts)]
            self._count += int(state.get("count", 0))
            self._sum += float(state.get("sum", 0.0))
            self._max = max(self._max, float(state.get("max", 0.0)))
        return True

    def _edge(self, i: int) -> str:
        if i == len(self._counts) - 1:
            return "+Inf"
        return f"{self._min * 10 ** (max(i, 0) / self._per):.6g}"

    def buckets(self) -> dict:
        """Non-empty buckets as {upper edge in seconds: count}, with
        ``"+Inf"`` for overflow."""
        with self._lock:
            counts = list(self._counts)
        return {self._edge(i): c for i, c in enumerate(counts) if c}

    def bucket_edge(self, seconds: float) -> str:
        """The ``buckets()`` label that ``seconds`` records into."""
        return self._edge(self._index(float(seconds)))

    def summary(self) -> dict:
        """{count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms}."""
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
        if count == 0:
            return {"count": 0}
        return {
            "count": count,
            "mean_ms": round(total / count * 1e3, 3),
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p95_ms": round(self.percentile(95) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
        }


def merge_bucket_dicts(a: dict, b: dict) -> dict:
    """Per-edge sum of two ``LatencyHistogram.buckets()`` dicts (same-layout
    histograms emit the same edge labels)."""
    out = dict(a)
    for edge, count in b.items():
        out[edge] = out.get(edge, 0) + count
    return out


def bucket_percentile(buckets: dict, p: float) -> float:
    """The p-th percentile (seconds) of a buckets dict: the upper edge of
    the bucket holding rank p; NaN when empty, inf in the overflow bucket."""
    items = []
    inf_count = 0
    for edge, count in buckets.items():
        if edge == "+Inf":
            inf_count = int(count)
        else:
            items.append((float(edge), int(count)))
    items.sort()
    total = sum(c for _, c in items) + inf_count
    if total == 0:
        return float("nan")
    rank = max(1, math.ceil(p / 100.0 * total))
    cum = 0
    for edge, count in items:
        cum += count
        if cum >= rank:
            return edge
    return float("inf")


def merge_counter_maps(a: dict, b: dict) -> dict:
    """Recursive numeric-leaf sum of two counter maps: dicts merge
    recursively, numbers add, a key on one side rides through, and on a
    non-numeric conflict (bools included) ``a``'s value stays."""
    out = dict(a)
    for k, v in b.items():
        cur = out.get(k)
        if isinstance(cur, dict) and isinstance(v, dict):
            out[k] = merge_counter_maps(cur, v)
        elif isinstance(cur, bool) or isinstance(v, bool):
            out[k] = cur if k in out else v
        elif isinstance(cur, (int, float)) and isinstance(v, (int, float)):
            out[k] = cur + v
        elif k not in out:
            out[k] = v
    return out


_EVENT_SEQ = itertools.count(1)


def emit_event(event: str, stream: Optional[IO] = None, **fields) -> dict:
    """One structured ``{"event": ..., ...}`` JSONL line to ``stream``
    (stderr by default: stdout carries the run's metric records), stamped
    with a per-process ``seq`` and the ``pid``.  Returns the record."""
    record = {"event": event, **fields}
    record.setdefault("seq", next(_EVENT_SEQ))
    record.setdefault("pid", os.getpid())
    out = stream if stream is not None else sys.stderr
    try:
        out.write(json.dumps(record) + "\n")
        out.flush()
    except ValueError:  # a closed stream
        pass
    return record


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
    Thread-safe; writers share one logger.  With ``tensorboard_dir`` each
    emit's numeric fields also go to TensorBoard (``torch.utils.
    tensorboard``, JAX :438-458), stepped by the record's ``step``; where
    that package is missing the sink is off, with a warning on stderr."""

    def __init__(self, stream: Optional[IO] = None, path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
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
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except Exception as e:  # noqa: BLE001 — an optional sink
                print(f"WARNING: TensorBoard sink unavailable ({e})", file=sys.stderr)

    def log(self, name: str, value: float) -> None:
        with self._lock:
            self._acc[name].append(float(value))

    def event(self, name: str, **fields) -> dict:
        """One out-of-band ``{"event": name, ...}`` record, written now; the
        scalar accumulators are untouched."""
        with self._lock:
            record = {"event": name, **fields}
            record.setdefault("seq", next(self._seq))
            record.setdefault("pid", os.getpid())
            line = json.dumps(record) + "\n"
            for out in self._streams:
                out.write(line)
                out.flush()
        return record

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
            if self._tb is not None:
                step = int(record.get("step", 0))
                for k, v in record.items():
                    if isinstance(v, (int, float)) and k not in ("step", "final", "seq", "pid"):
                        self._tb.add_scalar(k, v, global_step=step)
        return record

    def close(self) -> None:
        """Close the file and TensorBoard sinks (the stream belongs to the
        caller)."""
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
