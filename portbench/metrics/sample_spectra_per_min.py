"""Spectra whose full posterior was returned, per minute, in the cells
of the K1 trajectory kernel: every completed fit's spectra over the
window's span (``readers.rate``)."""

from portbench.readers import rate


def read(ctx):
    return rate(ctx, "sample")
