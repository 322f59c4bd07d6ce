"""Per-stage wall-clock of a fit, the spans and counters that a fit
records, and a device trace around any stage (port of
bayes_drt_tpu/profiling.py).

A stage on a CUDA device is closed by ``torch.cuda.synchronize``, so it
measures the card's work and not only its enqueue. ``trace`` records a
``torch.profiler`` timeline (host ops, and the card's kernels when one is
present) as a Chrome trace.

Spans and counters (``span``, ``count``) record only inside a recording
scope, which an entry point decorated with ``recorded`` opens when it is
called with ``timing=True``. Outside one, a span or a count is one check
of a module-level number: it records nothing, allocates nothing and never
synchronizes. Inside one, a span adds no synchronize either: it records
its name, its parent span, the fit it belongs to (a fit called inside a
recorded fit, as the escalation refit is, gets its own id), the mesh
shard whose worker thread ran it, its host interval in
``time.time_ns()`` (the clock ``torch.profiler`` stamps its events with,
so that the spans line up with a device trace) and, on a CUDA device, a
``torch.cuda.Event`` pair on the current stream, read when the scope
closes (after the fit's last synchronize) into the span's device
seconds. Span stacks are per thread; ``fork`` and ``adopt`` carry the
caller's open span into a mesh worker thread."""

from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import os
import threading
import time
from typing import Optional

import torch

_trace_seq = itertools.count()

# open recording scopes in the process: the one check a span makes when
# nothing records
_on = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)


class _Null:
    """The context a span is when nothing records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Recorder:
    """What one outermost recording scope recorded: ``spans``, a list of
    dicts (``name``, ``id``, ``parent`` (None for a fit's root),
    ``fit``, ``shard`` (None outside a mesh worker thread),
    ``start_ns``, ``end_ns``, ``device_s`` (None without a CUDA event
    pair)) in the order they closed, and ``counters``, {name: total}
    over the scope, its shards and the fits called inside it."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.fits = itertools.count()
        self._pairs = []        # (span, start event, end event)

    def add(self, span, ev0, ev1):
        self.spans.append(span)
        if ev0 is not None and ev1 is not None:
            self._pairs.append((span, ev0, ev1))

    def finish(self):
        """Read every event pair into its span's ``device_s``. The last
        events of a fit can trail its last synchronize by the host work
        after it: the scope waits for its root's end event, the last it
        recorded (every earlier one on that stream is then done), on an
        idle queue; a pair on another device's stream that is still
        pending is waited for alone."""
        if self._pairs:
            self._pairs[-1][2].synchronize()
        for span, ev0, ev1 in self._pairs:
            try:
                ms = ev0.elapsed_time(ev1)
            except RuntimeError:            # not yet reached
                ev1.synchronize()
                ms = ev0.elapsed_time(ev1)
            span["device_s"] = ms * 1e-3
        self._pairs = []


class _Ctx:
    """One thread's place in a recording: the recorder, the fit, the
    shard, whether spans take CUDA events, the open spans' ids and the
    fit's root span."""

    __slots__ = ("rec", "fit", "shard", "cuda", "stack", "root")

    def __init__(self, rec, fit, shard, cuda, stack):
        self.rec, self.fit, self.shard = rec, fit, shard
        self.cuda, self.stack = cuda, stack
        self.root = None


def _event(ctx):
    if not ctx.cuda or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """An open span; after it closes, ``record`` holds its dict and
    ``seconds`` its host seconds."""

    __slots__ = ("ctx", "record", "_ev0")

    def __init__(self, ctx, name):
        self.ctx = ctx
        self.record = {"name": name, "id": next(_ids),
                       "parent": ctx.stack[-1] if ctx.stack else None,
                       "fit": ctx.fit, "shard": ctx.shard,
                       "start_ns": 0, "end_ns": 0, "device_s": None}

    def __enter__(self):
        self.ctx.stack.append(self.record["id"])
        self.record["start_ns"] = time.time_ns()
        self._ev0 = _event(self.ctx)
        return self

    def __exit__(self, *exc):
        ev1 = _event(self.ctx) if self._ev0 is not None else None
        self.record["end_ns"] = time.time_ns()
        self.ctx.stack.pop()
        self.ctx.rec.add(self.record, self._ev0, ev1)
        return False

    @property
    def seconds(self):
        return (self.record["end_ns"] - self.record["start_ns"]) * 1e-9


def _ctx():
    return getattr(_local, "ctx", None)


def span(name: str):
    """A context that records the span ``name`` (``layer/part``) inside a
    recording scope, and does nothing outside one."""
    if not _on:
        return _NULL
    ctx = _ctx()
    if ctx is None:
        return _NULL
    return _Span(ctx, name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` inside a recording scope."""
    if not _on:
        return
    ctx = _ctx()
    if ctx is None:
        return
    with _lock:
        ctx.rec.counters[name] = ctx.rec.counters.get(name, 0) + int(n)


def fork():
    """The calling thread's place in a recording, for ``adopt`` in a
    worker thread (None when it records nothing)."""
    if not _on:
        return None
    ctx = _ctx()
    if ctx is None:
        return None
    return (ctx.rec, ctx.fit, ctx.cuda,
            ctx.stack[-1] if ctx.stack else None)


@contextlib.contextmanager
def adopt(forked, shard: int):
    """Record in this worker thread under the span open in the thread
    that ``fork``ed, as shard ``shard``."""
    if forked is None:
        yield
        return
    rec, fit, cuda, parent = forked
    prev = _ctx()
    _local.ctx = _Ctx(rec, fit, shard, cuda,
                      [parent] if parent is not None else [])
    try:
        yield
    finally:
        _local.ctx = prev


@contextlib.contextmanager
def recording():
    """A recording scope around one fit: its root span ``fit``. Yields
    the Recorder, which a scope opened inside another shares (the fit
    gets its own id and its root the enclosing span as parent)."""
    global _on
    outer = _ctx()
    rec = outer.rec if outer is not None else Recorder()
    ctx = _Ctx(rec, next(rec.fits), outer.shard if outer else None,
               outer.cuda if outer else False,
               [outer.stack[-1]] if outer and outer.stack else [])
    _local.ctx = ctx
    with _lock:
        _on += 1
    try:
        root = _Span(ctx, "fit")
        ctx.root = root
        with root:
            yield rec
        if outer is None:
            rec.finish()
    finally:
        with _lock:
            _on -= 1
        _local.ctx = outer


def recorded(entry):
    """Decorate an entry point that takes ``timing``: called with
    ``timing=True`` it runs in a ``recording`` scope, and the outermost
    such call returns its ``diagnostics`` with ``spans`` and ``counters``
    (the Recorder's)."""
    sig = inspect.signature(entry)

    @functools.wraps(entry)
    def call(*args, **kw):
        if not sig.bind(*args, **kw).arguments.get("timing", False):
            return entry(*args, **kw)
        outermost = _ctx() is None
        with recording() as rec:
            result = entry(*args, **kw)
        if outermost:
            result.diagnostics["spans"] = rec.spans
            result.diagnostics["counters"] = dict(rec.counters)
        return result

    return call


def _phase_start(device):
    """The calling fit's first phase, starting now on ``device``: (host
    start, start event, index of the first span recorded in it), or None
    when nothing records. The fit's root span takes its device start from
    here."""
    ctx = _ctx()
    if not _on or ctx is None or ctx.root is None:
        return None
    ctx.cuda = device is not None and device.type == "cuda"
    ev = _event(ctx)
    root = ctx.root
    if root._ev0 is None and ev is not None:
        root._ev0 = ev
    return time.time_ns(), ev, len(ctx.rec.spans)


def _phase_end(name, phase):
    """Record ``phase`` (``_phase_start``'s), which a mark closes, as the
    span ``name`` under the fit's root, the parent of the spans recorded
    under the root since it started; returns the next phase."""
    ctx = _ctx()
    if phase is None or ctx is None:
        return None
    t0, ev0, first = phase
    ev1 = _event(ctx) if ev0 is not None else None
    now = time.time_ns()
    root_id = ctx.root.record["id"]
    rec = {"name": name, "id": next(_ids), "parent": root_id,
           "fit": ctx.fit, "shard": ctx.shard, "start_ns": t0,
           "end_ns": now, "device_s": None}
    for s in ctx.rec.spans[first:]:
        if s["fit"] == ctx.fit and s["parent"] == root_id:
            s["parent"] = rec["id"]
    ctx.rec.add(rec, ev0, ev1)
    return now, ev1, len(ctx.rec.spans)


class StageTimer:
    """Named wall-clock stages, each closed by a synchronize of
    ``device`` (none: the host clock alone); attached as
    ``Inverter.timings``. ``stage(name)`` times a block; ``mark(name)``
    times the stretch since the previous mark (or the timer's creation).
    ``stages`` sums each name's seconds, ``laps`` lists them. With
    ``on=False`` every stage and mark does nothing. ``phases=True`` (an
    entry point's clock): inside a recording scope each mark is also a
    top-level span of the fit, the parent of the spans opened since the
    previous mark."""

    def __init__(self, device=None, on: bool = True, phases: bool = False):
        self.stages = {}
        self.laps = {}
        self.on = on
        self._device = None if device is None else torch.device(device)
        self._last = time.perf_counter()
        self._phase = _phase_start(self._device) if on and phases else None

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _add(self, name, seconds):
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        self.laps.setdefault(name, []).append(seconds)

    @contextlib.contextmanager
    def _timed(self, name):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self._add(name, time.perf_counter() - t0)

    def stage(self, name: str):
        return self._timed(name) if self.on else _NULL

    def mark(self, name: str):
        if not self.on:
            return
        self._sync()
        now = time.perf_counter()
        self._add(name, now - self._last)
        self._last = now
        self._phase = _phase_end(name, self._phase)

    def summary(self) -> dict:
        return dict(self.stages)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the enclosed stage (CPU activity, and
    CUDA activity when a card is present), exported as a Chrome trace
    ``trace-<pid>-<n>.json`` into ``log_dir`` (created if missing). Yields
    the profiler, whose ``key_averages()`` the caller may read. No-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{next(_trace_seq)}.json"))
