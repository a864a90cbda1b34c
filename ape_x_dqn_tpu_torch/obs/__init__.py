"""Observability: the registry, the exporter, worker stats blocks, the
flight recorder, experience lineage and on-demand traces.

Port of ``ape_x_dqn_tpu/obs/``:

  * ``registry``  — typed counters, gauges and histograms, providers, health
  * ``exporter``  — ``/metrics`` (Prometheus), ``/varz`` (JSON), ``/healthz``
  * ``shm_stats`` — per-worker shared-memory stats blocks (SIGKILL-readable)
  * ``recorder``  — flight recorder and post-mortem files
  * ``lineage``   — experience lineage, trace spans, bucket exemplars
  * ``trace``     — ``/varz?trace=1``: an on-demand ``torch.profiler`` capture

Lazy (PEP 562): ``import ape_x_dqn_tpu_torch.obs.shm_stats`` in a worker
runs this file first, so the names below resolve on first access instead
of importing the exporter, the trace or torch.  The fleet aggregator
(``obs/fleet.py``), the timeline store (``obs/timeline.py``) and the chaos
injector (``obs/chaos.py``) are not part of the port yet.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "ObsServer": "ape_x_dqn_tpu_torch.obs.exporter",
    "LineageTracker": "ape_x_dqn_tpu_torch.obs.lineage",
    "TraceSpanLog": "ape_x_dqn_tpu_torch.obs.lineage",
    "BucketExemplars": "ape_x_dqn_tpu_torch.obs.lineage",
    "FlightRecorder": "ape_x_dqn_tpu_torch.obs.recorder",
    "write_postmortem": "ape_x_dqn_tpu_torch.obs.recorder",
    "Counter": "ape_x_dqn_tpu_torch.obs.registry",
    "Gauge": "ape_x_dqn_tpu_torch.obs.registry",
    "Health": "ape_x_dqn_tpu_torch.obs.registry",
    "Histogram": "ape_x_dqn_tpu_torch.obs.registry",
    "MetricsRegistry": "ape_x_dqn_tpu_torch.obs.registry",
    "WORKER_SLOTS": "ape_x_dqn_tpu_torch.obs.shm_stats",
    "WorkerStatsBlock": "ape_x_dqn_tpu_torch.obs.shm_stats",
    "TraceOnDemand": "ape_x_dqn_tpu_torch.obs.trace",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is not None:
        return getattr(importlib.import_module(target), name)
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
