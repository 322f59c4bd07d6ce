"""% of the window's spectra that the escalation gate flagged and the
NUTS refit fitted again (``diagnostics['escalated']``,
``readers.escalated_share``)."""

from portbench.readers import escalated_share


def read(ctx):
    if ctx.mode != "sample":
        return None
    return escalated_share(f.diagnostics["escalated"] for f in ctx.fits
                           if "escalated" in f.diagnostics)
