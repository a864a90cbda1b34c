"""1 − the union of device records over the traced stretch's span, as a
percentage (the arithmetic of the port's profile_fused, copied into
yardstick.reduce_trace)."""


def read(ctx):
    red = ctx["trace"]
    if red is None or not red["span_us"]:
        return None
    return 100.0 * (1.0 - red["busy_us"] / red["span_us"])
