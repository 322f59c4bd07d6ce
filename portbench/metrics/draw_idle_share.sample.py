"""% of the flat sampler's draws' traced time in which the device ran
nothing: the profiled fit's ``sample/draw`` spans (each draw from the
loop's top to its last store, around its K1 launch) laid over its
profiler slices (``spans.idle_share``): the per-draw bookkeeping's idle
time between K1 launches."""

from portbench.spans import idle_share


def read(ctx):
    return idle_share(ctx, "sample", "sample/draw")
