"""Learner updates (B rows each) completed in the window over the window:
the learner step reached at each replay boundary, read at the window's
edges by the host clock."""

from benchmark.yardstick import window_rate


def read(ctx):
    return window_rate(ctx["steps_log"], ctx["t0"], ctx["t1"])
