"""Per-stage wall-clock accumulators and the device trace.

Port of ``StageTimer`` (``ape_x_dqn_tpu/utils/profiling.py:33-70``): the
async host-replay loop times ``sample+place``, ``step_dispatch``,
``priority_writeback`` and ``publish`` (and ``eval`` when it runs) and
exports µs per call as ``stage_us`` in its JSONL.  Stage times are host
times: a step that only enqueues device work reads short in
``step_dispatch``, and the wait shows up wherever the host next reads a
device value (the write-back's priority read, a log emit).

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
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Tuple


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
