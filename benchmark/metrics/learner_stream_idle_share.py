"""The learner stream's idle share, as a percentage: the gaps between one
timed piece of its work (a graph replay, or eager work: the load of a
call's inputs, the metrics copy, the ingest adds) and the next, each from
the end event of one piece to the start event of the next, over the
pieces and gaps of the window's whole untraced calls (benchmark/
timeline.py); a call's gaps include the one before its first piece."""

from benchmark.timeline import timed_calls


def read(ctx):
    calls = timed_calls(ctx)
    if calls is None:
        return None
    idle = sum(c["lead_gap_ms"] + c["gap_ms"] for c in calls)
    span = idle + sum(c["replay_ms"] + c["eager_ms"] for c in calls)
    return 100.0 * idle / span if span else None
