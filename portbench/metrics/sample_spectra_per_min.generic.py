"""Spectra whose full posterior was returned, per minute, in the cells
of the generic (autograd) SHMC sampler: every completed fit's spectra
over the window's span (``readers.rate``)."""

from portbench.readers import rate


def read(ctx):
    return rate(ctx, "sample")
