"""Device ms of the fused learner's graph replays per learner step: the
CUDA events the program records before and after each replay on the
learner's stream, summed over the window's whole untraced calls
(benchmark/timeline.py), over their steps."""

from benchmark.timeline import timed_calls


def read(ctx):
    calls = timed_calls(ctx)
    if calls is None:
        return None
    steps = sum(c["steps"] for c in calls)
    return sum(c["replay_ms"] for c in calls) / steps if steps else None
