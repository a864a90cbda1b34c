"""As env_frames_per_s, in a cell whose actors act with their own copy of
the params: paced by the host, it decides nothing there."""

from benchmark.yardstick import window_rate


def read(ctx):
    if ctx["central"]:
        return None
    return window_rate(ctx["sink_log"], ctx["t0"], ctx["t1"])
