"""% of the Newton polish's traced time in which the device ran nothing:
the profiled fit's ``polish`` span laid over its profiler slices
(``spans.idle_share``)."""

from portbench.spans import idle_share


def read(ctx):
    return idle_share(ctx, "optimize", "polish")
