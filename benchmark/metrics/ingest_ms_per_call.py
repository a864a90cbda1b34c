"""Host ms the learner thread spends per fused call moving actor rows into
the device ring (the program's ``ingest`` span), over the window's whole
untraced calls (benchmark/timeline.py)."""

from benchmark.timeline import window_calls


def read(ctx):
    calls = window_calls(ctx)
    if calls is None:
        return None
    return sum(c["host_ms"].get("ingest", 0.0) for c in calls) / len(calls)
