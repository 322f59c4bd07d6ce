"""The Series-Parallel DRT band coverage of the JAX package's NUTS against
the port's, on the same spectra and settings, both on the CPU.

    JAX_PLATFORMS=cpu python scripts/sp_coverage_check.py [B] [float32|float64]

Fits the first B (default 8) spectra of chip_smoke.py's Series-Parallel
batch (sim.series_parallel_circuit with uniform noise at 0.25% of the real
range, seed 11; DRT + TP-DDT on logspace(6, -2, 81), nonneg, sigma_min
0.002) with NUTS max_depth 8, tree_scan, ncp, no escalation, 4 chains x
(100 warmup + 100 draws): the JAX package's fit_spectra_batch in float64,
the port's with device="cpu" in the given dtype (float64 by default).
Prints, as one JSON line, each package's DRT band coverage (the share of
the 81 basis points whose ZARC truth lies inside the pointwise 95% band),
per spectrum and its mean with the standard error over spectra, the
difference in standard errors, the DRT RMSE and the median divergence
rate, and the seconds of each fit.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bayes_drt_tpu.parallel import fit_spectra_batch as jax_fit  # noqa: E402
from bayes_drt_tpu_torch import sim  # noqa: E402
from bayes_drt_tpu_torch.parallel import (evaluate_gamma,  # noqa: E402
                                          fit_spectra_batch)

SEED = 11
BASIS = np.logspace(6, -2, 81)
DISTRIBUTIONS = {
    "DRT": {"kernel": "DRT", "basis_freq": BASIS},
    "TP-DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "transmissive",
               "dist_type": "parallel", "basis_freq": BASIS,
               "x_scale": 0.8}}
KW = dict(distributions=DISTRIBUTIONS, nonneg=True, sigma_min=0.002,
          chains=4, warmup=100, samples=100, max_tree_depth=8,
          tree_scan=True, ncp=True, escalate=False, random_seed=3)


def figures(res, tau, truth):
    d = res.diagnostics
    lo, hi = np.asarray(d["gamma_eval_lo"]), np.asarray(d["gamma_eval_hi"])
    cov = np.mean((truth[None, :] >= lo) & (truth[None, :] <= hi), axis=1)
    g = evaluate_gamma(res, tau)
    rmse = np.sqrt(np.mean((g - truth[None, :]) ** 2, axis=1))
    return {"coverage": cov.tolist(), "coverage_mean": float(cov.mean()),
            "coverage_se": float(cov.std(ddof=1) / np.sqrt(len(cov))),
            "drt_rmse_mean": float(rmse.mean()),
            "divergence_median": float(np.median(d["divergence_rate"]))}


def main(b, dtype):
    torch.set_num_threads(4)
    freq = np.logspace(6, -2, 81)
    zb = sim.noisy_replicas(sim.series_parallel_circuit(freq), b, 0.0025,
                            SEED)
    tau = 1.0 / (2 * np.pi * BASIS)
    truth = sim.zarc_drt(tau, 1e-3, 0.8)
    out = {"B": b, "budget": [4, 100, 100], "max_tree_depth": 8}
    t0 = time.perf_counter()
    res_j = jax_fit(freq, zb, gamma_eval_tau=tau, **KW)
    out["jax"] = dict(figures(res_j, tau, truth), dtype="float64",
                      wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    res_t = fit_spectra_batch(freq, zb, gamma_eval_tau=tau, dtype=dtype,
                              device="cpu", **KW)
    out["port"] = dict(figures(res_t, tau, truth), dtype=dtype,
                       wall_s=time.perf_counter() - t0)
    se = np.hypot(out["jax"]["coverage_se"], out["port"]["coverage_se"])
    out["port_minus_jax_in_se"] = float(
        (out["port"]["coverage_mean"] - out["jax"]["coverage_mean"]) / se)
    print(json.dumps(out))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
         sys.argv[2] if len(sys.argv) > 2 else "float64")
