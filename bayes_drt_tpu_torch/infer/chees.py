"""Synchronous static multinomial HMC configuration and its deterministic
schedules (port of bayes_drt_tpu/infer/chees.py:98,121,400).

Only the pieces the flat-chain sampler (infer/shmc_flat.py) reads are
ported; the generic autodiff ``sample_shmc`` and ChEES are later work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SHMCConfig(NamedTuple):
    """Every draw of every chain runs exactly ``n_steps`` leapfrogs.

    The adaptation fields carry the JAX package's defaults. ``precision``
    is "highest" (true fp32 products); the reduced-precision arm of the
    JAX package is not ported and raises."""
    n_steps: int = 32
    warm_steps: int = 0           # leapfrogs per warmup draw (0 = n_steps)
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    adapt_mass: bool = True
    jitter_lo: float = 0.67       # per-draw step-size multiplier h is
                                  # halton-distributed in [jitter_lo, 1]
    eps_quantile: float = 0.0     # sampling-phase step size = this quantile
                                  # of the chains' adapted step sizes
                                  # (0 = min, < 0 = each chain its own)
    precision: str = "highest"

    def validate(self) -> None:
        if self.precision != "highest":
            raise NotImplementedError(
                f"precision={self.precision!r} is not ported; the port runs "
                "true fp32 ('highest') until an A/B on the quality gates "
                "admits a reduced-precision arm")


def _pool_eps(eps_bc, cfg):
    """Pool per-chain adapted step sizes (B, C) into one sampling-phase eps
    per spectrum (B,) or, for eps_quantile < 0, keep them per chain."""
    q = cfg.eps_quantile
    if q < 0.0:
        return eps_bc
    if q == 0.0:
        return eps_bc.min(dim=1).values
    return torch.quantile(eps_bc, q, dim=1)


def _halton2(total: int) -> np.ndarray:
    """Van der Corput base-2 sequence in (0, 1): the shared quasi-random
    trajectory jitter."""
    out = np.zeros(total)
    for i in range(total):
        f, r, x = 0.5, 0.0, i + 1
        while x > 0:
            r += f * (x & 1)
            x >>= 1
            f *= 0.5
        out[i] = r
    return out
