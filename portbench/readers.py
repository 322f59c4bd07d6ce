"""Arithmetic that several metric readers (``metrics/<name>.py``) share:
each reader is one call of these on its ``core.Ctx``."""

from __future__ import annotations

import numpy as np


def rate(ctx, mode):
    """Spectra a minute: the spectra of every fit completed in the window
    over the span from the first fit's start to the last fit's end (host
    clock, each fit closed by a device synchronize)."""
    if ctx.mode != mode or not ctx.fits:
        return None
    span = ctx.fits[-1].end - ctx.fits[0].start
    return 60.0 * sum(f.batch for f in ctx.fits) / span


def span_mean(ctx, mode, phase):
    """Seconds of the entry's program span ``phase_s[phase]`` (timing=True:
    host clock closed by a device synchronize), the mean over the
    window's fits that recorded spans outside the profiler."""
    if ctx.mode != mode:
        return None
    v = [f.diagnostics["phase_s"][phase] for f in ctx.spans()
         if phase in f.diagnostics.get("phase_s", {})]
    return sum(v) / len(v) if v else None


def idle(ctx, mode):
    """% of the traced fit's slices in which the device ran no kernel,
    copy or set (the union of their intervals in the trace)."""
    if ctx.trace is None or ctx.mode != mode or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def escalated_share(flags):
    """% of the spectra flagged, over a list of fits' ``escalated`` masks;
    None where no fit has one."""
    flags = [np.asarray(x, bool) for x in flags]
    n = sum(x.size for x in flags)
    if not n:
        return None
    return 100.0 * sum(int(x.sum()) for x in flags) / n
