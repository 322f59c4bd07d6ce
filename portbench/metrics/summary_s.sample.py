"""Seconds of the posterior summary a fit in the K1 cells
(``phase_s['summary']``, ``readers.span_mean``)."""

from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "sample", "summary")
