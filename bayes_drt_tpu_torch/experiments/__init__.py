"""The arms the JAX package fences in bayes_drt_tpu.experiments, under
its names, pointing at the port's counterparts. In the JAX package each
lost an A/B on a TPU against its production path; those timings are the
TPU's and are not repeated here. What each arm is in the port:

**ChEES-HMC** (``sample_chees``, ``ChEESConfig``; also
``fit_spectra_batch(sampler='chees')``, ``fit_spectra_ragged`` and
``Inverter.fit(sampler='chees')``). Adaptive trajectory-length HMC
(Hoffman et al. 2021): every chain of a spectrum integrates for one
shared, jittered trajectory time learned in warmup by Adam ascent on the
ChEES criterion; each draw replays a CUDA graph of masked leaves until
its longest row is done (infer/chees.py).

**NUTSConfig(fused_draws=True)** (infer/nuts.py). In the JAX package a
whole chain, warmup and samples, as one loop of leapfrog steps with the
draw boundaries masked inside the step. Its draws are the flat form's,
so the port runs the flat form; it keeps the option, its warning and its
refusal of dense mass adaptation.

**The flat-chain trajectory** (``sample_shmc_flat``, ``FlatSpec``,
``FlatShared``, ``flat_spec_for``, ``flat_shared_for``,
``flat_value_and_grad``; ``SHMCConfig(pallas_traj=True)`` or
``flat_chain=True``). The single series DRT's whole (B*C, D) chain axis
through one launch a draw of the hand-written trajectory kernel
(csrc/traj.cu), over the hand-derived value and gradient. Unlike the JAX
package, the port runs it by default on that model's SHMC fits: it is
the port's main path.

**The quadrature kernel** (``construct_A_drt_quad``, also under the JAX
name ``construct_A_drt_pallas``). The DRT A matrix by trapezoid
quadrature in the hand-written kernel csrc/quad.cu; every DRT A the port
builds on a CUDA device comes from it.

Timings of these arms on an NVIDIA H100 are in PERF.md, each beside the
card's name and power limit.
"""

from ..infer.chees import ChEESConfig, sample_chees
from ..infer.shmc_flat import (FlatShared, FlatSpec, flat_shared_for,
                               flat_spec_for, flat_value_and_grad,
                               sample_shmc_flat)
from ..ops.quad import construct_A_drt_quad

construct_A_drt_pallas = construct_A_drt_quad

__all__ = [
    "ChEESConfig", "sample_chees",
    "FlatShared", "FlatSpec", "flat_shared_for", "flat_spec_for",
    "flat_value_and_grad", "sample_shmc_flat",
    "construct_A_drt_pallas", "construct_A_drt_quad",
]
