"""Metrics registry and health: typed instruments, providers, two views.

Port of ``ape_x_dqn_tpu/obs/registry.py`` (``Counter`` :32, ``Gauge`` :72,
``Histogram`` :112, ``MetricsRegistry`` :193, ``Health`` :299).  Counters,
gauges and histograms (on ``utils/metrics``' ``RateCounter`` and
``LatencyHistogram``) sit beside **providers**: callables whose dicts fold
existing stats surfaces (the pool's transport stats, the checkpoint
writer's, the workers' shm stats blocks) into every snapshot.
``snapshot()`` is the ``/varz`` JSON and ``prometheus_text()`` the
``/metrics`` scrape (``obs/exporter.py``), byte for byte what the JAX
package renders for the same instruments and values.

``Health`` is the ``/healthz`` source: components **beat** or register an
**age function**; one older than its bound marks it, and the process,
degraded.

Standard library only: no torch.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, Optional

from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram, RateCounter


class Counter:
    """Monotone counter with a sliding-window rate (events/s)."""

    kind = "counter"

    def __init__(self, help: str = "", window_s: float = 30.0):
        self.help = help
        self._value = 0.0
        self._rate = RateCounter(window_s)
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up — use a Gauge")
        with self._lock:
            self._value += n
        self._rate.add(n)

    def merge(self, other: "Counter") -> None:
        """Fold another counter in: totals add, rate windows interleave."""
        with other._lock:
            value = other._value
        with self._lock:
            self._value += value
        self._rate.merge(other._rate)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def rate(self) -> float:
        return self._rate.rate()

    def snapshot(self):
        return {"total": self.value, "rate_s": round(self.rate(), 3)}


class Gauge:
    """Last-write-wins scalar; ``set_fn`` makes it a gauge computed at
    snapshot time (a failing function reads NaN, never raises)."""

    kind = "gauge"

    def __init__(self, help: str = ""):
        self.help = help
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._value = float(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must never crash
                return float("nan")
        return self._value

    def snapshot(self):
        return self.value

    def merge(self, other: "Gauge") -> None:
        """Fold another gauge in as the max of the two values (a plain
        scalar from then on)."""
        self._value = max(self.value, other.value)
        self._fn = None


class Histogram:
    """Log-bucketed distribution: O(1) observe, percentiles and the raw
    buckets out."""

    kind = "histogram"

    def __init__(self, help: str = "", min_s: float = 1e-5,
                 max_s: float = 120.0, per_decade: int = 20):
        self.help = help
        self._hist = LatencyHistogram(min_s=min_s, max_s=max_s, per_decade=per_decade)

    def observe(self, value: float) -> None:
        self._hist.record(value)

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def sum(self) -> float:
        """Total observed (the ``_sum`` series of a Prometheus summary)."""
        return float(self._hist._sum)

    def percentile(self, p: float) -> float:
        return self._hist.percentile(p)

    def merge(self, other: "Histogram") -> None:
        """Bucket-wise fold; the layouts must match."""
        self._hist.merge(other._hist)

    def snapshot(self):
        out = self._hist.summary()
        out["buckets"] = self._hist.buckets()
        return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(*parts: str) -> str:
    return _NAME_RE.sub("_", "_".join(p for p in parts if p))


def _prom_value(v: float) -> str:
    """A sample value as the text format spells it (``NaN``, ``+Inf``,
    ``-Inf`` for the specials)."""
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return f"{v:g}"


def _prom_help(text: str) -> str:
    """HELP text on one line: backslash and newline escaped."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _flatten(prefix: str, value, out: list) -> None:
    """The numeric leaves of a nested dict as (name, value) pairs."""
    if isinstance(value, bool):
        out.append((prefix, int(value)))
    elif isinstance(value, (int, float)):
        out.append((prefix, value))
    elif isinstance(value, dict):
        for k, v in value.items():
            _flatten(_prom_name(prefix, str(k)), v, out)


class MetricsRegistry:
    """Named typed instruments and snapshot providers."""

    def __init__(self, prefix: str = "apex"):
        self.prefix = prefix
        self._instruments: Dict[str, object] = {}
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(**kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", min_s: float = 1e-5,
                  max_s: float = 120.0, per_decade: int = 20) -> Histogram:
        return self._get_or_create(name, Histogram, help=help, min_s=min_s,
                                   max_s=max_s, per_decade=per_decade)

    def register_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """Fold ``fn()``'s dict into every snapshot under ``name``."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def snapshot(self) -> dict:
        """The ``/varz`` JSON: instruments under their names, provider dicts
        under theirs; a failing provider reads as an ``error`` entry."""
        with self._lock:
            instruments = dict(self._instruments)
            providers = dict(self._providers)
        out: dict = {"t_mono": round(time.monotonic(), 3)}
        for name, inst in instruments.items():
            out[name] = inst.snapshot()
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — a scrape must not crash
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition: counters as ``_total``, gauges,
        histograms as summaries (quantiles 0.5/0.95/0.99, ``_sum``,
        ``_count``), provider dicts flattened to numeric-leaf gauges."""
        with self._lock:
            instruments = dict(self._instruments)
            providers = dict(self._providers)
        lines: list = []
        for name, inst in sorted(instruments.items()):
            pname = _prom_name(self.prefix, name)
            if inst.help:
                lines.append(f"# HELP {pname} {_prom_help(inst.help)}")
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname}_total {_prom_value(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_value(inst.value)}")
            elif isinstance(inst, Histogram):
                lines.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.95, 0.99):
                    v = inst.percentile(q * 100)
                    v = v if v == v else 0.0  # an empty histogram reads 0
                    lines.append(f'{pname}{{quantile="{q}"}} {_prom_value(v)}')
                lines.append(f"{pname}_sum {_prom_value(inst.sum)}")
                lines.append(f"{pname}_count {inst.count}")
        flat: list = []
        for name, fn in sorted(providers.items()):
            try:
                _flatten(_prom_name(self.prefix, name), fn(), flat)
            except Exception:  # noqa: BLE001 — a scrape must not crash
                continue
        for pname, value in flat:
            lines.append(f"{pname} {_prom_value(value)}")
        return "\n".join(lines) + "\n"


class Health:
    """Per-component liveness for ``/healthz``: ``beat(name)`` from loops,
    ``register(name, age_fn)`` for components that track their own last
    activity.  A component older than ``stale_after_s`` (or its own bound)
    is degraded, and the process with it."""

    def __init__(self, stale_after_s: float = 15.0):
        self.stale_after_s = float(stale_after_s)
        self._beats: Dict[str, float] = {}
        self._age_fns: Dict[str, Callable[[], float]] = {}
        self._stale: Dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, name: str) -> None:
        with self._lock:
            self._beats[name] = time.monotonic()

    def register(self, name: str, age_fn: Callable[[], float],
                 stale_after_s: Optional[float] = None) -> None:
        with self._lock:
            self._age_fns[name] = age_fn
            if stale_after_s is not None:
                self._stale[name] = float(stale_after_s)

    def merge(self, other: "Health") -> None:
        """Fold another Health in: components union, the freshest beat and
        the tighter bound win, age functions ride through."""
        with other._lock:
            beats = dict(other._beats)
            age_fns = dict(other._age_fns)
            stale = dict(other._stale)
        with self._lock:
            for name, t in beats.items():
                self._beats[name] = max(self._beats.get(name, t), t)
            for name, fn in age_fns.items():
                self._age_fns.setdefault(name, fn)
            for name, bound in stale.items():
                self._stale[name] = min(self._stale.get(name, bound), bound)

    def status(self) -> dict:
        now = time.monotonic()
        with self._lock:
            beats = dict(self._beats)
            age_fns = dict(self._age_fns)
            stale = dict(self._stale)
        components: dict = {}
        ok_all = True
        for name, t in beats.items():
            age = now - t
            ok = age <= stale.get(name, self.stale_after_s)
            components[name] = {"age_s": round(age, 3), "ok": ok}
            ok_all &= ok
        for name, fn in age_fns.items():
            try:
                age = float(fn())
            except Exception:  # noqa: BLE001 — a failing age function is degraded
                age = float("inf")
            ok = age <= stale.get(name, self.stale_after_s)
            components[name] = {"age_s": round(min(age, 1e12), 3), "ok": ok}
            ok_all &= ok
        return {"status": "ok" if ok_all else "degraded", "components": components}
