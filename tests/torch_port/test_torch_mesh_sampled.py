"""The main path on a mesh: the single series DRT's SHMC fit (through the
trajectory kernel's plain version on the CPU) on 8 virtual CPU shards
against the meshless fit, both held to the bench's five gates, and the
JAX package's mesh fit of the same spectra for the layout and the
diagnostics' shapes. A file of its own: the 8 shards run one after
another on the CPU."""

import numpy as np
import torch

from bayes_drt_tpu.infer.chees import SHMCConfig as JaxSHMCConfig
from bayes_drt_tpu.parallel import fit_spectra_batch as jax_fit
from bayes_drt_tpu.parallel import make_mesh as jax_make_mesh
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.parallel import (evaluate_gamma, fit_spectra_batch,
                                          make_mesh)

torch.set_num_threads(1)

EIGHT = tuple((i, i, i + 1) for i in range(8))


def test_sampled_main_path_on_eight_shards():
    """8 spectra (41 points, K=101) at 4 x (120 + 180) with 24 leapfrogs a
    draw, on 8 shards (one spectrum each, every shard its own generator)
    and without a mesh: both pass the bench's gates (batch-mean gamma RMSE
    < 3% Rp, per-spectrum p90 < 5% Rp, band coverage > 0.93, median
    min-ESS > 3.5, median logp split-Rhat < 4), their batch-mean RMSEs
    within 1% Rp of each other; the mesh fit runs the trajectory kernel's
    route. The JAX package's mesh fit (its generic path) lays the batch
    out the same way, with the same diagnostics' shapes."""
    freq, Zb = sim.make_benchmark_batch(8, freq=np.logspace(6, -2, 41),
                                        noise_level=0.0025, seed=0)
    kw = dict(chains=4, warmup=120, samples=180, ncp=True, sampler="shmc",
              escalate=False, random_seed=1)
    cfg = dict(n_steps=24, warm_steps=24, eps_quantile=0.5)
    runs = {"mesh": fit_spectra_batch(
        freq, Zb, mesh=make_mesh(8, device="cpu"), device="cpu",
        dtype=torch.float64, shmc_cfg=SHMCConfig(**cfg), **kw),
        "meshless": fit_spectra_batch(freq, Zb, device="cpu",
                                      dtype=torch.float64,
                                      shmc_cfg=SHMCConfig(**cfg), **kw)}
    tau = runs["mesh"].tau
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    mean_rmse = {}
    for name, res in runs.items():
        g = evaluate_gamma(res, tau)
        lo, hi = evaluate_gamma(res, tau, "lo"), evaluate_gamma(res, tau,
                                                                "hi")
        per = np.sqrt(np.mean((g - gt) ** 2, axis=1))
        mean_rmse[name] = np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2))
        d = res.diagnostics
        assert mean_rmse[name] < 0.03 * rp, name
        assert np.percentile(per, 90) < 0.05 * rp, name
        assert np.mean((gt >= lo) & (gt <= hi)) > 0.93, name
        assert np.median(d["min_ess"]) > 3.5, name
        assert np.median(d["logp_rhat"]) < 4.0, name
        assert np.isfinite(res.coef).all()
    assert abs(mean_rmse["mesh"] - mean_rmse["meshless"]) < 0.01 * rp
    assert runs["mesh"].diagnostics["shard_layout"] == EIGHT
    assert runs["mesh"].diagnostics["shmc_route"] == "flat-kernel"
    want = jax_fit(freq, Zb, mesh=jax_make_mesh(8),
                   shmc_cfg=JaxSHMCConfig(**cfg), **dict(kw, warmup=20,
                                                         samples=10))
    assert want.diagnostics["shard_layout"] == EIGHT
    for k, v in want.diagnostics.items():
        if k != "state_cfg":
            assert np.shape(runs["mesh"].diagnostics[k]) == np.shape(v), k
