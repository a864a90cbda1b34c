"""Agent steps the actors took and the learner's sink received in the
window (one transition each), over the window, in a cell with central
inference: every action came from the card's server, so this is the
serving tier's throughput (closed loop, paced by the host)."""

from benchmark.yardstick import window_rate


def read(ctx):
    if not ctx["central"]:
        return None
    return window_rate(ctx["sink_log"], ctx["t0"], ctx["t1"])
