"""% of the traced MAP fit's slices in which the device ran nothing
(``readers.idle``)."""

from portbench.readers import idle


def read(ctx):
    return idle(ctx, "optimize")
