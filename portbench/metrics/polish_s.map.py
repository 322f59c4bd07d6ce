"""Seconds of the Newton polish a fit (``phase_s['polish']``,
``readers.span_mean``)."""

from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "optimize", "polish")
