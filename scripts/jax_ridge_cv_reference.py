"""The JAX package's own batched Re-Im cross-validated ridge on the main
path's spectra, the reference figures behind the CV gate of
chip_smoke.py's phase 13.

    JAX_PLATFORMS=cpu python scripts/jax_ridge_cv_reference.py [B] [--port P]

Fits the first B (default 16) of the main path's spectra (the port's
sim.make_benchmark_batch(1024, ZARC, noise 0.25% of the real range, seed
0): the rows chip_smoke.py draws) with the JAX package's
ridge_fit_spectra_batch at its defaults (integral penalty, hyper-lambda)
and cv_lambdas = logspace(-10, 5, 31) in float32 (the card's default),
on the CPU, in blocks of 64 spectra (each spectrum's fit is its own, so
the blocks change no result). (float64 is not run: there the QPs of the
smallest lambdas pivot to their 2,000-iteration cap, and the vmapped loop
runs every row that long.) Prints as one JSON line the batch-mean gamma
RMSE, the per-spectrum RMSE p90 and max against the ZARC truth over Rp
(the smoke's map_figures), the count of spectra that selected each grid
boundary and the median selected lambda, over all B spectra and over the
first 16 (the smoke prints the card's figures over both).

With --port P, the port's ridge_fit_spectra_batch (float32, CPU) fits the
first P of those spectra too, and the line also holds its figures, the
count of equal selections and the largest relative difference of the two
packages' total CV curves at lambda >= 1e-6 and below it.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bayes_drt_tpu.parallel import (evaluate_gamma,  # noqa: E402
                                    ridge_fit_spectra_batch)
from bayes_drt_tpu_torch import sim  # noqa: E402

GRID = np.logspace(-10, 5, 31)
BLOCK = 64
FIRST = 16


def figures(g, lam, tau):
    """The smoke's CV figures of per-spectrum gammas (B, T) on tau."""
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    per = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    grid = GRID.astype(np.float32)
    return {
        "B": len(g),
        "rmse_over_rp": float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2))
                              / rp),
        "p90_over_rp": float(np.percentile(per, 90) / rp),
        "max_over_rp": float(per.max() / rp),
        "boundary_low": int(np.sum(lam == grid[0])),
        "boundary_high": int(np.sum(lam == grid[-1])),
        "cv_lambda_median": float(np.median(lam))}


def fit_blocks(fit, zb):
    """(gamma (B, T), cv_lambda (B,), cv_totcv (B, L), tau) of ``fit`` run
    on ``zb`` in blocks of BLOCK spectra."""
    gs, lams, tots = [], [], []
    for i in range(0, len(zb), BLOCK):
        g, lam, tot, tau = fit(zb[i:i + BLOCK])
        gs.append(g)
        lams.append(lam)
        tots.append(tot)
    return np.concatenate(gs), np.concatenate(lams), np.concatenate(tots), tau


def jax_fit(freq):
    def fit(zb):
        res = ridge_fit_spectra_batch(freq, zb, cv_lambdas=GRID,
                                      dtype=jnp.float32)
        return (evaluate_gamma(res, res.tau),
                np.asarray(res.diagnostics["cv_lambda"]),
                np.asarray(res.diagnostics["cv_totcv"]), res.tau)
    return fit


def port_fit(freq):
    import torch

    from bayes_drt_tpu_torch.parallel import evaluate_gamma as eg
    from bayes_drt_tpu_torch.parallel import ridge_fit_spectra_batch as rf

    def fit(zb):
        res = rf(freq, zb, cv_lambdas=GRID, dtype=torch.float32,
                 device="cpu")
        return (eg(res, res.tau),
                np.asarray(res.diagnostics["cv_lambda"]),
                np.asarray(res.diagnostics["cv_totcv"]), res.tau)
    return fit


def main(argv):
    p = 0
    if "--port" in argv:
        i = argv.index("--port")
        p = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    b = int(argv[0]) if argv else FIRST
    freq, zb = sim.make_benchmark_batch(1024, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    out = {"dtype": "float32"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        g, lam, tot, tau = fit_blocks(jax_fit(freq), zb[:b])
        out["seconds_cpu"] = time.perf_counter() - t0
        out["jax"] = figures(g, lam, tau)
        out["jax_first16"] = figures(g[:FIRST], lam[:FIRST], tau)
        if p:
            t0 = time.perf_counter()
            gp, lamp, totp, _ = fit_blocks(port_fit(freq), zb[:p])
            out["port_seconds_cpu"] = time.perf_counter() - t0
            out["port"] = figures(gp, lamp, tau)
            rel = np.abs(totp - tot[:p]) / np.abs(tot[:p])
            small = GRID < 1e-6
            out["port_vs_jax"] = {
                "B": p, "equal_selections": int(np.sum(lamp == lam[:p])),
                "totcv_rel_diff_max_lambda_ge_1e-6":
                    float(rel[:, ~small].max()),
                "totcv_rel_diff_max_lambda_lt_1e-6":
                    float(rel[:, small].max())}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
