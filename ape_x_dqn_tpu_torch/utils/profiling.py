"""Per-stage wall-clock accumulators for the host-side pipeline.

Port of ``StageTimer`` (``ape_x_dqn_tpu/utils/profiling.py:33-70``).  The
async host-replay loop times ``sample+place``, ``step_dispatch``,
``priority_writeback`` and ``publish`` (and ``eval`` when it runs) and
exports µs per call as ``stage_us`` in its JSONL.  Stage times are host
times: a step that only enqueues device work reads short in
``step_dispatch``, and the wait shows up wherever the host next reads a
device value (the write-back's priority read, a log emit).  The JAX
package's device tracing and subtractive timing are not part of the port.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Named wall-clock accumulators: ``with timer.stage("sample"): ...``.

    One ``perf_counter`` pair per section plus one uncontended lock acquire
    (the ``+=`` on a dict item is a read-modify-write, not atomic under
    CPython, so cross-thread updates need the lock).
    """

    def __init__(self):
        self._total_s: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._total_s[name] += seconds
            self._count[name] += 1

    def us_per_call(self) -> Dict[str, float]:
        with self._lock:
            totals, counts = dict(self._total_s), dict(self._count)
        return {
            name: round(totals[name] / max(1, counts[name]) * 1e6, 1)
            for name in totals
        }
