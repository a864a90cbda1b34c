"""Model FLOPs of the learner steps in the traced stretch over its span,
as a percentage of the H100's dense bfloat16 peak (the torso computes in
bfloat16); the FLOPs are counted from the network's shapes
(yardstick.learner_step_flops)."""

from benchmark.yardstick import PEAK_BF16_FLOPS, learner_step_flops


def read(ctx):
    red = ctx["trace"]
    if red is None or not red["steps"] or not red["span_us"]:
        return None
    n = ctx["net_shape"]
    flops = learner_step_flops(n["obs_shape"], n["channels"], n["hidden"],
                               n["num_actions"], ctx["batch"])
    return 100.0 * flops * red["steps"] / (red["span_us"] / 1e6) / PEAK_BF16_FLOPS
