"""The device trace of one fit: ``torch.profiler`` over slices of the
call, reduced to kernel times by name, the device's busy time (the union
of its kernel, copy and set intervals), the traced windows and the
longest idle gaps labelled by what the host was doing in them.

``events`` reads the profiler's raw event list (no ``key_averages``, which
builds a Python object an event and takes minutes over the millions of
kernels that a fit of graphed leaves launches). The reductions take plain
``Event`` tuples, so that they can be checked on synthetic intervals."""

from __future__ import annotations

from typing import NamedTuple


_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
_HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
               "python_function", "cpu_instant_event")


class Event(NamedTuple):
    name: str
    device: bool          # ran on the card (kernel, copy, set)
    start_ns: int
    end_ns: int


class TraceSummary(NamedTuple):
    kernels: dict         # name -> (launches, seconds)
    busy_s: float         # union of device intervals inside the window
    window_s: float       # the traced span
    gaps: list            # [(host label, seconds)], longest first
    device_ops: list      # [(name, seconds)], most time first


class Slices:
    """``torch.profiler`` (CPU and CUDA activity) over slices of a fit:
    the first starts with ``start``, each lasts ``on_s`` seconds and the
    next starts ``every_s`` seconds after the last one stopped, checked at
    every ``tick``. Between ``start`` and ``finish`` every torch call
    (through a ``TorchFunctionMode``) and every CUDA graph replay ticks,
    so the slices need no hook in the program. A fit of graphed leaves
    records ~300,000 kernels a second under the profiler and its stop
    takes ~35 us an event, so a traced run samples its fit in slices
    instead of holding the profiler over all of it. ``slices`` holds each
    finished slice's ``Event``s."""

    def __init__(self, on_s, every_s):
        self.on_s, self.every_s = float(on_s), float(every_s)
        self.prof = None
        self.mark = None
        self.slices = []
        self._replay = None
        self._mode = None

    def start(self):
        import torch
        from torch.overrides import TorchFunctionMode
        self.cuda = torch.cuda.is_available()
        tick = self.tick

        class Ticks(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                tick()
                return func(*args, **(kwargs or {}))

        if self.cuda:
            # L-BFGS and the generic sampler run whole phases as replays
            graph = torch.cuda.CUDAGraph
            self._replay = graph.replay

            def replay(g, *args, **kw):
                tick()
                return self._replay(g, *args, **kw)

            graph.replay = replay
        self._mode = Ticks()
        self._mode.__enter__()
        self._on()

    def _on(self):
        import time

        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = time.perf_counter()

    def _off(self):
        import time

        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.slices.append(events(self.prof))
        self.prof = None
        self.mark = time.perf_counter()

    def tick(self):
        import time
        if self.mark is None:
            return
        now = time.perf_counter()
        if self.prof is not None and now - self.mark >= self.on_s:
            if not self._capturing():
                self._off()
        elif self.prof is None and now - self.mark >= self.every_s:
            if not self._capturing():
                self._on()

    def _capturing(self):
        """A CUDA graph capture is under way: no synchronize, no switch."""
        import torch
        return self.cuda and torch.cuda.is_current_stream_capturing()

    def finish(self):
        if self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._mode = None
        if self._replay is not None:
            import torch
            torch.cuda.CUDAGraph.replay = self._replay
            self._replay = None
        if self.prof is not None:
            self._off()
        self.mark = None


def events(prof):
    """``Event``s of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        # activity_type() is missing from older torch; there device_type()
        # alone tells the device's kernels, copies and sets from host ops
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        if kind == "gpu_user_annotation":
            continue          # a host span drawn on the device's row
        dev = kind in _DEVICE_KINDS or (
            kind not in _HOST_KINDS and "CPU" not in str(e.device_type()))
        s = int(e.start_ns())
        out.append(Event(e.name(), dev, s, s + int(e.duration_ns())))
    return out


def union(intervals):
    """Merged, sorted (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(slices, top=10, skip=("portbench",)):
    """TraceSummary of a traced fit's slices (lists of ``Event``). A
    slice's window is the span of its events; a gap is a stretch of it
    in which the device ran nothing, labelled by the host event that
    overlaps it most (shorter events first on ties; events named with a
    ``skip`` prefix, the harness's own spans, never label). Times add up
    over the slices; the longest ``top`` gaps and kernels are kept."""
    slices = [s for s in slices if s]
    if not slices:
        return None
    kernels, gaps = {}, []
    busy_ns = window_ns = 0
    for evts in slices:
        t0 = min(e.start_ns for e in evts)
        t1 = max(e.end_ns for e in evts)
        window_ns += t1 - t0
        dev = [e for e in evts if e.device]
        host = [e for e in evts if not e.device
                and not e.name.startswith(skip)]
        for e in dev:
            n, s = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, s + (e.end_ns - e.start_ns) * 1e-9)
        busy = union((e.start_ns, e.end_ns) for e in dev)
        busy_ns += sum(e - s for s, e in busy)
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        raw = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
               if edges[i + 1] > edges[i]]
        raw.sort(key=lambda g: g[0] - g[1])
        for gs, ge in raw[:top]:
            best, key = "host (no traced op)", None
            for h in host:
                ov = min(ge, h.end_ns) - max(gs, h.start_ns)
                if ov <= 0:
                    continue
                k = (ov, -(h.end_ns - h.start_ns))
                if key is None or k > key:
                    best, key = h.name, k
            gaps.append((best, (ge - gs) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(((n, s) for n, (_, s) in kernels.items()),
                 key=lambda x: -x[1])[:top]
    return TraceSummary(kernels=kernels, busy_s=busy_ns * 1e-9,
                        window_s=window_ns * 1e-9, gaps=gaps[:top],
                        device_ops=ops)


def kernel_time(summary, pattern):
    """(launches, seconds) of the kernels whose name holds ``pattern``."""
    n, s = 0, 0.0
    for name, (k, t) in summary.kernels.items():
        if pattern in name:
            n, s = n + k, s + t
    return n, s
