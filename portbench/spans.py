"""Arithmetic over the program's spans that the span metrics share.

A fit called with ``timing=True`` returns its spans as
``diagnostics['spans']``: dicts with ``name``, ``id``, ``parent``,
``fit``, ``shard``, ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s
clock (the clock ``torch.profiler`` stamps its events with) and
``device_s`` (the seconds of the span's CUDA event pair; None on the
CPU). The traced run's profiled fit records them beside its profiler
slices, so a span's host interval can be laid over the device's
timeline: ``idle`` is the time inside a span in which the device ran
nothing, within the slices that the profiler covered. The reductions
take plain lists and ``devtrace.Event``s, so that they can be checked on
synthetic intervals."""

from __future__ import annotations

import bisect
import sys

from portbench.devtrace import union


def events(ctx):
    """The profiled fit's slices (lists of ``devtrace.Event``): the
    Ctx's ``events`` where it carries them; else the ``traced_events``
    that ``core.run``, which calls the readers, holds; None in an
    untraced run."""
    ev = getattr(ctx, "events", None)
    if ev is not None:
        return ev
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run" and "traced_events" in f.f_locals:
            return f.f_locals["traced_events"]
        f = f.f_back
    return None


def profiled(ctx):
    """The spans of the traced run's profiled fit (None without one, or
    where the program records none)."""
    for f in ctx.fits:
        if f.kind == "profiled":
            return f.diagnostics.get("spans")
    return None


def named(spans, name):
    return [s for s in spans if s["name"] == name]


def _busy_ns(dev, starts, ends, cum, s, e):
    """Nanoseconds of the merged, sorted intervals ``dev`` inside
    [s, e) (``starts``, ``ends`` their edges, ``cum`` their lengths'
    running sum from 0)."""
    i = bisect.bisect_right(ends, s)
    j = bisect.bisect_left(starts, e)
    if i >= j:
        return 0
    return (cum[j] - cum[i] - max(0, s - starts[i])
            - max(0, ends[j - 1] - e))


def idle(slices, intervals):
    """(idle ns, traced ns): the host ``intervals`` ((start_ns, end_ns),
    merged) cut to each slice's window (the span of its events), and the
    part of them in which the slice's device intervals (kernels, copies,
    sets) ran nothing."""
    spans = union(intervals)
    idle_ns = traced_ns = 0
    for evts in slices:
        if not evts or not spans:
            continue
        t0 = min(e.start_ns for e in evts)
        t1 = max(e.end_ns for e in evts)
        cut = [(max(s, t0), min(e, t1)) for s, e in spans
               if min(e, t1) > max(s, t0)]
        if not cut:
            continue
        dev = union((e.start_ns, e.end_ns) for e in evts if e.device)
        starts = [d[0] for d in dev]
        ends = [d[1] for d in dev]
        cum = [0]
        for d in dev:
            cum.append(cum[-1] + d[1] - d[0])
        for s, e in cut:
            traced_ns += e - s
            idle_ns += e - s - _busy_ns(dev, starts, ends, cum, s, e)
    return idle_ns, traced_ns


def idle_share(ctx, mode, name):
    """% of the profiled fit's ``name`` spans, within its traced slices,
    in which the device ran nothing; None where nothing was traced
    inside them."""
    if ctx.mode != mode:
        return None
    spans, slices = profiled(ctx), events(ctx)
    if not spans or not slices:
        return None
    idle_ns, traced_ns = idle(slices, [(s["start_ns"], s["end_ns"])
                                       for s in named(spans, name)])
    return 100.0 * idle_ns / traced_ns if traced_ns > 0 else None


def self_ns(spans, name):
    """Each ``name`` span's host nanoseconds less its children's, in the
    order the spans were recorded."""
    child = {}
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] = (child.get(s["parent"], 0)
                                  + s["end_ns"] - s["start_ns"])
    return [s["end_ns"] - s["start_ns"] - child.get(s["id"], 0)
            for s in named(spans, name)]


def last_draws(spans, n):
    """The last ``n`` ``sample/draw`` spans of each fit's sampler on each
    shard (the sampling draws, after the warmup's)."""
    runs = {}
    for s in named(spans, "sample/draw"):
        runs.setdefault((s["fit"], s["shard"]), []).append(s)
    return [s for run in runs.values()
            for s in sorted(run, key=lambda x: x["start_ns"])[-n:]]


def seconds(span):
    """A span's device seconds (its CUDA event pair); on the CPU, where a
    call's work runs inside it, its host seconds."""
    if span["device_s"] is not None:
        return span["device_s"]
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def device_s_mean(ctx, mode, name):
    """Device seconds of the ``name`` spans a fit, the mean over the
    window's fits that recorded spans outside the profiler."""
    if ctx.mode != mode:
        return None
    v = []
    for f in ctx.spans():
        found = named(f.diagnostics.get("spans", []), name)
        if found:
            v.append(sum(seconds(s) for s in found))
    return sum(v) / len(v) if v else None


def counter_mean(ctx, mode, name):
    """The counter ``name`` a fit, the mean over the window's fits that
    recorded spans outside the profiler and counted it."""
    if ctx.mode != mode:
        return None
    v = [f.diagnostics["counters"][name] for f in ctx.spans()
         if name in f.diagnostics.get("counters", {})]
    return sum(v) / len(v) if v else None
