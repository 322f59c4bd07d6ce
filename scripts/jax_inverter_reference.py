"""The JAX package's own Inverter fits of the Inverter phase's spectrum,
the reference figures behind the sampled-fit gates of chip_smoke.py's
phase 13.

    JAX_PLATFORMS=cpu python scripts/jax_inverter_reference.py

Fits the smoke's spectrum (the port's sim.make_benchmark_batch(1, ZARC,
noise 0.25% of the real range, seed 13): the row chip_smoke.py draws)
with the JAX package's Inverter, float64 on the CPU: the default MAP, the
default NUTS (md10) at the smoke's cut budget 2 x (30 + 20) and at the
JAX package's Inverter test budget 2 x (120 + 120), and SHMC at the
default 2 x (200 + 200), both samplers with ncp as the smoke runs them,
each sampled fit from the seeds 1234, 1 and 2. Prints, one JSON line a
fit, the gamma RMSE against the ZARC truth over Rp, R_inf, and for the
sampled fits rhat_max, ess_min (the JAX package's Inverter test gates
them at < 5 and > 2 at 2 x (120 + 120)) and the divergence rate.

    JAX_PLATFORMS=cpu python scripts/jax_inverter_reference.py --port [FIT ...]

also fits with the port's Inverter (float64 on the CPU) from the same
seeds; FIT names limit the run to those fits (map, nuts_md10_30_20,
nuts_md10_120_120, shmc_200_200).
"""

import json
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from bayes_drt_tpu import Inverter  # noqa: E402
from bayes_drt_tpu_torch import sim  # noqa: E402

SEED = 13
FITS = {"map": {},
        "nuts_md10_30_20": dict(mode="sample", warmup=30, samples=20,
                                ncp=True),
        "nuts_md10_120_120": dict(mode="sample", warmup=120, samples=120,
                                  ncp=True),
        "shmc_200_200": dict(mode="sample", sampler="shmc", ncp=True)}


def main(argv):
    port = "--port" in argv
    names = [a for a in argv if a != "--port"] or list(FITS)
    freq, zb = sim.make_benchmark_batch(1, circuit="ZARC",
                                        noise_level=0.0025, seed=SEED)
    z = zb[0]
    tau_gt = np.logspace(-7, 2, 200)
    grid = np.logspace(-9, 4, 2000)
    rp = float(np.trapezoid(sim.zarc_drt(grid, 1e-3, 0.8), np.log(grid)))
    truth = sim.zarc_drt(tau_gt, 1e-3, 0.8)
    makers = {"jax": Inverter}
    if port:
        import torch

        import bayes_drt_tpu_torch
        makers["port"] = lambda: bayes_drt_tpu_torch.Inverter(
            device="cpu", dtype=torch.float64)
    for name in names:
        kw = FITS[name]
        for seed in ((1234,) if name == "map" else (1234, 1, 2)):
            for package, make in makers.items():
                inv = make()
                t0 = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    inv.fit(freq, z, random_seed=seed, **kw)
                g = inv.predict_distribution(eval_tau=tau_gt)
                rec = {"package": package, "fit": name, "seed": seed,
                       "seconds_cpu": time.perf_counter() - t0,
                       "rmse_over_rp": float(np.sqrt(np.mean(
                           (g - truth) ** 2)) / rp),
                       "R_inf": float(inv.R_inf)}
                if inv.fit_type == "bayes":
                    sd = inv.sample_diagnostics
                    rec.update(rhat_max=sd["rhat_max"],
                               ess_min=sd["ess_min"],
                               rank_rhat_max=sd["rank_rhat_max"],
                               divergence_rate=sd["divergence_rate"])
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
