"""% of the traced sampling fit's slices in which the device ran nothing
(``readers.idle``), in the generic SHMC cells."""

from portbench.readers import idle


def read(ctx):
    return idle(ctx, "sample")
