"""Mean rows per forward the PolicyServer served in the window, as a
percentage of serving.max_batch (the batcher's histogram of batch sizes,
read at the window's edges)."""


def read(ctx):
    if not ctx["central"]:
        return None
    a, b = ctx["state_t0"].get("batch_hist", {}), ctx["state_t1"].get("batch_hist", {})
    counts = {n: c - a.get(n, 0) for n, c in b.items()}
    batches = sum(counts.values())
    if not batches:
        return None
    rows = sum(int(n) * c for n, c in counts.items())
    return 100.0 * rows / batches / ctx["cfg"].serving.max_batch
