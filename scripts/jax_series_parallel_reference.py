"""The JAX package's own MAP recovery on the Series-Parallel check spectra,
the reference figure behind the Series-Parallel phase of chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/jax_series_parallel_reference.py [B]

Fits the first B (default 8) spectra of the smoke's batch (the port's
sim.series_parallel_circuit with uniform noise at 0.25% of the real
range, seed 11: the same rows chip_smoke.py draws) with the JAX package's
fit_spectra_batch(mode="optimize") in its default form (2 restarts, cap
2000, polish), float64 on the CPU, and prints the mean over spectra of the
DRT part's RMSE against the ZARC truth (Rp = 1), the TP-DDT part's RMSE
against its Cole-Cole truth and the median relative residual of
predict_Z_batch against the noiseless spectrum, as one JSON line.
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

from bayes_drt_tpu.parallel import (evaluate_gamma, fit_spectra_batch,  # noqa: E402
                                    predict_Z_batch)
from bayes_drt_tpu_torch import sim  # noqa: E402

SEED = 11
BASIS = np.logspace(6, -2, 81)
DISTRIBUTIONS = {
    "DRT": {"kernel": "DRT", "basis_freq": BASIS},
    "TP-DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "transmissive",
               "dist_type": "parallel", "basis_freq": BASIS,
               "x_scale": 0.8}}


def main(b):
    freq = np.logspace(6, -2, 81)
    z_true = sim.series_parallel_circuit(freq)
    zb = sim.noisy_replicas(z_true, b, 0.0025, SEED)
    t0 = time.perf_counter()
    res = fit_spectra_batch(freq, zb, mode="optimize",
                            distributions=DISTRIBUTIONS, nonneg=True,
                            sigma_min=0.002)
    wall = time.perf_counter() - t0
    tau = 1.0 / (2 * np.pi * BASIS)
    g = np.asarray(evaluate_gamma(res, tau))
    g_ddt = np.asarray(evaluate_gamma(res, tau, "coef_1"))
    rmse = np.sqrt(np.mean((g - sim.zarc_drt(tau, 1e-3, 0.8)) ** 2, axis=1))
    rmse_ddt = np.sqrt(np.mean(
        (g_ddt - sim.cole_cole_rbf(np.log(tau / 0.1), 0.8)) ** 2, axis=1))
    zhat = predict_Z_batch(res, freq)
    resid = np.median(np.abs(zhat - z_true) / np.abs(z_true), axis=1)
    print(json.dumps({
        "B": b, "drt_rmse_mean": float(rmse.mean()),
        "drt_rmse": rmse.tolist(), "ddt_rmse_mean": float(rmse_ddt.mean()),
        "z_resid_median": float(np.median(resid)),
        "n_iter": np.asarray(res.diagnostics["n_iter"]).tolist(),
        "wall_s": wall, "device": "cpu (float64)"}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
