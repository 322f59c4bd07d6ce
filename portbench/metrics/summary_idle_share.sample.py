"""% of the posterior summary's traced time in the K1 cells in which the
device ran nothing: the profiled fit's ``summary`` span laid over its
profiler slices (``spans.idle_share``)."""

from portbench.spans import idle_share


def read(ctx):
    return idle_share(ctx, "sample", "summary")
