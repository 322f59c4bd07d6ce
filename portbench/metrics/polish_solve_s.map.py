"""Device seconds of the Newton polish's solves a MAP fit: the CUDA event
pairs of its ``polish/solve`` spans (``spans.device_s_mean``)."""

from portbench.spans import device_s_mean


def read(ctx):
    return device_s_mean(ctx, "optimize", "polish/solve")
