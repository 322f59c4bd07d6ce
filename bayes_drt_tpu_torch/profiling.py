"""Per-stage wall-clock of a fit and a device trace around any stage
(port of bayes_drt_tpu/profiling.py).

A stage on a CUDA device is closed by ``torch.cuda.synchronize``, so it
measures the card's work and not only its enqueue. ``trace`` records a
``torch.profiler`` timeline (host ops, and the card's kernels when one is
present) as a Chrome trace."""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import torch

_trace_seq = itertools.count()


class StageTimer:
    """Collects named wall-clock stages; attached as ``Inverter.timings``.
    ``device``: the device whose queue each stage waits for (none: the
    host clock alone)."""

    def __init__(self, device=None):
        self.stages = {}
        self._device = None if device is None else torch.device(device)

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

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
