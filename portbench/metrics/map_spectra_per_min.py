"""MAP point estimates returned, per minute: every completed fit's
spectra over the window's span (``readers.rate``)."""

from portbench.readers import rate


def read(ctx):
    return rate(ctx, "optimize")
