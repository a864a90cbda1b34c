"""Device kernels a learner step runs: the kernels the graph launches of
the traced stretch issued (every step's replay, and each call's prologue
and epilogue) over the stretch's learner steps."""


def read(ctx):
    red = ctx["trace"]
    if red is None or not red["graph_kernels"] or not red["steps"]:
        return None
    return red["graph_kernels"] / red["steps"]
