"""95th percentile of the central workers' act round trips (request to
reply) in the window: their round-trip histograms (the port's
LatencyHistogram layout, 20 buckets a decade from 10 µs) at the window's
edges, the difference interpolated inside its bucket."""

from benchmark.yardstick import histogram_percentile, latency_edges

MIN_S, PER_DECADE = 1e-5, 20


def read(ctx):
    if not ctx["central"]:
        return None
    a, b = ctx["state_t0"].get("rtt", {}), ctx["state_t1"].get("rtt", {})
    total = None
    for w, st in b.items():
        base = a.get(w, {"counts": [0] * len(st["counts"])})["counts"]
        diff = [x - y for x, y in zip(st["counts"], base)]
        total = diff if total is None else [x + y for x, y in zip(total, diff)]
    if not total or sum(total) == 0:
        return None
    edges = latency_edges(MIN_S, PER_DECADE, len(total) - 1)
    return 1e3 * histogram_percentile(total, edges, 95.0)
