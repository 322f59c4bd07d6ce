"""Milliseconds a sampling draw of the generic SHMC sampler (each draw's
``draw_s``, host clock closed by a device synchronize, over the last
``samples`` draws of a fit), the mean over the window's fits that
recorded spans outside the profiler. None where the fit took the
trajectory kernel (no ``draw_s``)."""


def read(ctx):
    if ctx.mode != "sample":
        return None
    s = ctx.cell.config["samples"]
    v = []
    for f in ctx.spans():
        d = f.diagnostics.get("draw_s")
        if d is None or len(d) < s:
            continue
        v.append(1e3 * sum(d[-s:]) / s)
    return sum(v) / len(v) if v else None
