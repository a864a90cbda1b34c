"""The reading rule of the metrics that read the program's own timeline
(``ape_x_dqn_tpu_torch.utils.profiling``: the process's current
``StageTimer``, whose call records hold each fused call's host spans and
the CUDA events its graph runner recorded on the learner's stream).

A reader takes the whole calls inside the window that no
``torch.profiler`` capture touched (``profiled``), and not the call right
after one that did (the profiler's stop stalls the learner); with fewer
than ``MIN_CALLS`` of them it reads nothing.  A program without the
timeline reads nothing too.
"""

from __future__ import annotations

from typing import List, Optional

MIN_CALLS = 3


def window_calls(ctx: dict) -> Optional[List[dict]]:
    try:
        from ape_x_dqn_tpu_torch.utils.profiling import current_timer
    except ImportError:
        return None
    timer = current_timer()
    if not hasattr(timer, "finished_calls"):
        return None
    calls = timer.finished_calls()
    touched = {c["seq"] for c in calls if c["profiled"]}
    picked = [c for c in calls if ctx["t0"] <= c["t0"] and c["t1"] <= ctx["t1"]
              and not c["profiled"] and c["seq"] - 1 not in touched]
    return picked if len(picked) >= MIN_CALLS else None


def timed_calls(ctx: dict) -> Optional[List[dict]]:
    """``window_calls`` whose device work the stream's events timed."""
    calls = window_calls(ctx)
    if calls is None:
        return None
    timed = [c for c in calls if c["replays"]]
    return timed if len(timed) >= MIN_CALLS else None
