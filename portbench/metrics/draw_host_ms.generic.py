"""Milliseconds of host time a sampling draw of the generic SHMC sampler
spends outside its trajectory: the self time of each of the last
``samples`` ``sample/draw`` spans of a fit (the span less its
``sample/draw/traj`` child), the mean over the window's fits that
recorded spans outside the profiler."""

from portbench.spans import last_draws, named, self_ns


def read(ctx):
    if ctx.mode != "sample":
        return None
    n = ctx.cell.config["samples"]
    v = []
    for f in ctx.spans():
        spans = f.diagnostics.get("spans")
        if not spans:
            continue
        keep = {s["id"] for s in last_draws(spans, n)}
        own = [t for s, t in zip(named(spans, "sample/draw"),
                                 self_ns(spans, "sample/draw"))
               if s["id"] in keep]
        if own:
            v.append(1e-6 * sum(own) / len(own))
    return sum(v) / len(v) if v else None
