"""The JAX package's own ChEES-HMC fits, the reference figures behind
phase 17 (a) and (d) of chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/jax_chees_reference.py [B]
    JAX_PLATFORMS=cpu python scripts/jax_chees_reference.py inverter

Fits the first B (default 64) of the smoke's main-path batch
(sim.make_benchmark_batch(1024, circuit="ZARC", noise_level=0.0025,
seed=0): N=81, K=101, D=211) with the JAX package's
fit_spectra_batch(sampler="chees") as the smoke calls the port's: the
default ChEESConfig, 4 chains x (150 warmup + 250 draws), ncp,
random_seed 1, no escalation, float32 (x64 off, as the JAX package runs
on its TPU), on the CPU. Prints one JSON line: the RMSE of the batch-mean
gamma and the p90 of per-spectrum RMSE (both over Rp of the analytic ZARC
DRT), the pointwise 95% band coverage, the mean divergence rate, the
median min-ESS and logp split-Rhat, the mean leapfrogs a draw, the
quantiles of the adapted trajectory times and the seconds. B=64 took
57.6 s and B=1024 512.4 s on one CPU host (x86; JAX's CPU build).

``inverter``: the JAX package's Inverter.fit(mode="sample",
sampler="chees", ncp=True) on phase 13's spectrum (sim.make_benchmark_
batch(1, circuit="ZARC", noise_level=0.0025, seed=13)) at 2 chains x (120
+ 60), float32, for random_seed 0 to INV_SEEDS - 1. Prints each fit's
figures of the JAX Inverter tests' sampled gates (gamma RMSE over Rp,
|R_inf - 1|, rhat_max, ess_min) and their medians and 90th percentiles
over the seeds, one JSON line. 32 seeds took 24.1 s on one CPU host.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bayes_drt_tpu.parallel import (evaluate_gamma,  # noqa: E402
                                    fit_spectra_batch)
from bayes_drt_tpu_torch import sim  # noqa: E402
from bayes_drt_tpu_torch.ops.matrices import get_tau_basis  # noqa: E402

CHAINS, WARMUP, SAMPLES = 4, 150, 250
INV_BUDGET = (120, 60)
INV_SEEDS = 32


def inverter():
    import warnings
    from bayes_drt_tpu import Inverter
    freq, zb = sim.make_benchmark_batch(1, circuit="ZARC",
                                        noise_level=0.0025, seed=13)
    tau = np.logspace(-7, 2, 200)
    t_rp = np.logspace(-9, 4, 2000)
    rp = float(np.trapezoid(sim.zarc_drt(t_rp, 1e-3, 0.8), np.log(t_rp)))
    fits = []
    t0 = time.perf_counter()
    for seed in range(INV_SEEDS):
        inv = Inverter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inv.fit(freq, zb[0], mode="sample", sampler="chees", ncp=True,
                    warmup=INV_BUDGET[0], samples=INV_BUDGET[1],
                    random_seed=seed)
        g = inv.predict_distribution(eval_tau=tau)
        sd = inv.sample_diagnostics
        fits.append({
            "rmse_over_rp": float(np.sqrt(np.mean(
                (g - sim.zarc_drt(tau, 1e-3, 0.8)) ** 2)) / rp),
            "R_inf_err": abs(float(inv.R_inf) - 1.0),
            "rhat_max": float(sd["rhat_max"]),
            "ess_min": float(sd["ess_min"]),
            "divergence_rate": float(sd["divergence_rate"])})
    print(json.dumps({
        "budget": [2, *INV_BUDGET], "seeds": INV_SEEDS,
        "seconds": time.perf_counter() - t0,
        "median": {k: float(np.median([f[k] for f in fits]))
                   for k in fits[0]},
        "q90": {k: float(np.percentile([f[k] for f in fits], 90))
                for k in fits[0]},
        "fits": fits}))


def main(b):
    freq, zb = sim.make_benchmark_batch(1024, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    zb = zb[:b]
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    t0 = time.perf_counter()
    res = fit_spectra_batch(freq, zb, mode="sample", chains=CHAINS,
                            warmup=WARMUP, samples=SAMPLES, random_seed=1,
                            ncp=True, sampler="chees", gamma_eval_tau=tau,
                            dtype=jnp.float32)
    wall = time.perf_counter() - t0
    d = res.diagnostics
    g = np.asarray(evaluate_gamma(res, tau))
    per = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    cov = np.mean((gt[None, :] >= d["gamma_eval_lo"])
                  & (gt[None, :] <= d["gamma_eval_hi"]))
    tt = np.asarray(d["state_traj_time"], float)
    print(json.dumps({
        "B": b, "budget": [CHAINS, WARMUP, SAMPLES], "seconds": wall,
        "rmse_over_rp": float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2))
                              / rp),
        "p90_over_rp": float(np.percentile(per, 90) / rp),
        "coverage": float(cov),
        "divergence_rate": float(np.mean(d["divergence_rate"])),
        "min_ess_median": float(np.median(d["min_ess"])),
        "logp_rhat_median": float(np.median(d["logp_rhat"])),
        "n_leapfrog_mean": float(np.mean(d["n_leapfrog"])),
        "traj_time_q": np.quantile(tt, [0.0, 0.1, 0.5, 0.9, 1.0]).tolist(),
        "finite": bool(np.isfinite(res.coef).all())}))


if __name__ == "__main__":
    if sys.argv[1:] == ["inverter"]:
        inverter()
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
