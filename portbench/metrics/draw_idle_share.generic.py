"""% of the generic SHMC sampler's draws' traced time in which the device
ran nothing: the profiled fit's ``sample/draw`` spans laid over its
profiler slices (``spans.idle_share``). A span closes before the
per-draw synchronize of ``timing=True`` (``draw_s``), which it leaves
out."""

from portbench.spans import idle_share


def read(ctx):
    return idle_share(ctx, "sample", "sample/draw")
