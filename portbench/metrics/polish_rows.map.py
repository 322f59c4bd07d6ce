"""Hessian rows the Newton polish evaluates a MAP fit: the counter
``polish/rows``, the sum over its iterations of the rows still running
(``spans.counter_mean``)."""

from portbench.spans import counter_mean


def read(ctx):
    return counter_mean(ctx, "optimize", "polish/rows")
