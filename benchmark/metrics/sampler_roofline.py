"""The sampler's byte bound, (C·4 + T·8) B at 3.35 TB/s with T = K·B
targets per launch, over the device time of one ``sample_kernel`` record
in the traced stretch, as a percentage.  The bytes are the benchmark's
own, from C and T, so whatever implements the sampler is read against
the same work."""

from benchmark.yardstick import sampler_bound_s

KERNEL = "sample_kernel"


def read(ctx):
    red = ctx["trace"]
    if red is None:
        return None
    us = sum(v for k, v in red["by_name_us"].items() if KERNEL in k)
    n = sum(v for k, v in red["count_by_name"].items() if KERNEL in k)
    if not n or not us:
        return None
    T = ctx["steps_per_call"] * ctx["batch"]
    return 100.0 * sampler_bound_s(ctx["capacity"], T) / (us / n / 1e6)
