"""95th percentile of the served requests' queue waits, from a request's
enqueue at the PolicyServer's batcher to the start of its batch's forward
(the program's timeline), over the requests whose batch started inside
one of the window's whole untraced calls (benchmark/timeline.py)."""

import bisect
import statistics

from benchmark.timeline import window_calls

MIN_REQUESTS = 20


def read(ctx):
    if not ctx["central"]:
        return None
    calls = window_calls(ctx)
    if calls is None:
        return None
    from ape_x_dqn_tpu_torch.utils.profiling import current_timer

    starts = [c["t0"] for c in calls]
    waits = []
    for t, w in current_timer().queue_waits(ctx["t0"], ctx["t1"]):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= calls[i]["t1"]:
            waits.append(w)
    if len(waits) < MIN_REQUESTS:
        return None
    return 1e3 * statistics.quantiles(waits, n=100)[94]
