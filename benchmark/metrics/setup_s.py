"""Process start to the window's start: imports, the learner's build (the
ring's allocation, the graphs' capture, the sampler's build on a first
run), the weights and the prefill, the actors' spawn and the checked call."""


def read(ctx):
    return ctx["setup_s"]
