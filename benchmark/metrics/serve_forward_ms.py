"""Server-side ms per batch the PolicyServer served in the window: the
batch thread's host time per batch (copy in, forward, copy out and the
wait for them), from its per-bucket counts and means at the window's
edges."""


def read(ctx):
    if not ctx["central"]:
        return None
    a, b = ctx["state_t0"].get("forward_times", {}), ctx["state_t1"].get("forward_times", {})
    batches, host_ms = 0, 0.0
    for bucket, row in b.items():
        was = a.get(bucket, {"batches": 0, "host_ms": 0.0})
        batches += row["batches"] - was["batches"]
        host_ms += row["batches"] * row["host_ms"] - was["batches"] * was["host_ms"]
    if batches <= 0:
        return None
    return host_ms / batches
