"""Per-stage wall-clock of a fit (port of bayes_drt_tpu/profiling.py's
StageTimer).

A stage on a CUDA device is closed by ``torch.cuda.synchronize``, so it
measures the card's work and not only its enqueue."""

from __future__ import annotations

import contextlib
import time

import torch


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
