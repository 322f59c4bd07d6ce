"""The JAX package's own drift figures, the references behind the drift
phase of chip_smoke.py (phase 14).

    JAX_PLATFORMS=cpu python scripts/jax_drift_reference.py [B]
    JAX_PLATFORMS=cpu python scripts/jax_drift_reference.py rq [S] [--port]

The first form runs the JAX package's drift_fit_spectra_batch on the
drift bench's fleet (benchmarks/bench_drift.py:make_fleet(B, seed=0),
default B=64) at the bench's configuration (x1, 2 restarts, min_tau_drift
100, max_iter 1500, random_seed 1, the bench's timed call) in float32 on
the CPU, and prints one JSON line: the median and the largest per-cell
median relative residual, the quantiles of the L-BFGS iteration counts,
tau_1's range and the seconds of the call (a CPU figure, of no device).

The ``rq`` form fits the JAX drift test's RQ spectrum
(tests/test_drift.py:test_drift_rq_fit: 8 restarts, float64) at random
seeds 0..S-1 (default 10) and prints, for each, tau_rq, R_rq, whether
that test's gates hold, and the count that pass: the share of seeds whose
best of nine starts lands in the drifting element's basin. ``--port``
runs the port's Inverter (on the CPU, float64) on the same seeds instead.
"""

import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

KW = dict(drift_model="x1", random_seed=1, n_restarts=2, min_tau_drift=100.0,
          max_iter=1500)


def fleet(b):
    from bayes_drt_tpu.parallel import drift_fit_spectra_batch
    from bench_drift import make_fleet
    freq, times, zb = make_fleet(b, seed=0)
    t0 = time.perf_counter()
    res = drift_fit_spectra_batch(freq, times, zb, **KW)
    seconds = time.perf_counter() - t0
    d = res.diagnostics
    resid = np.asarray(d["median_rel_resid"], float)
    n_iter = np.asarray(d["n_iter"], float)
    tau_1 = np.asarray(d["drift"]["tau_1"], float)
    print(json.dumps({
        "B": b,
        "compute_dtype": "float64" if jax.config.jax_enable_x64 else "float32",
        "median_rel_resid_p50": float(np.median(resid)),
        "median_rel_resid_max": float(resid.max()),
        "n_iter_q": [float(q) for q in np.quantile(n_iter,
                                                   [0, 0.5, 0.9, 1.0])],
        "tau_1_range": [float(tau_1.min()), float(tau_1.max())],
        "finite": bool(np.isfinite(np.asarray(res.coef)).all()),
        "cpu_seconds": seconds}))


def rq_seeds(n_seeds, port):
    from bayes_drt_tpu_torch import sim
    jax.config.update("jax_enable_x64", True)
    if port:
        import torch
        from bayes_drt_tpu_torch import Inverter
        torch.set_num_threads(1)

        def make():
            return Inverter(device="cpu", dtype=torch.float64)
    else:
        from bayes_drt_tpu import Inverter

        def make():
            return Inverter()
    freq, Z, times = sim.make_drifting_spectrum("RQ")
    passed = 0
    for seed in range(n_seeds):
        inv = make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inv.drift_map_fit(freq, Z, times, drift_model="RQ",
                              random_seed=seed, n_restarts=8)
        f = inv.distribution_fits["DRT"]
        ok = bool(abs(np.log10(f["tau_rq"] / 0.05)) < 1.0
                  and 0.2 < f["R_rq"] < 1.0)
        passed += ok
        print(json.dumps({"seed": seed, "tau_rq": float(f["tau_rq"]),
                          "R_rq": float(f["R_rq"]), "gates": ok}),
              flush=True)
    print(json.dumps({"package": "port" if port else "jax",
                      "seeds": n_seeds, "passed": passed}))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if args and args[0] == "rq":
        rq_seeds(int(args[1]) if len(args) > 1 else 10,
                 "--port" in sys.argv)
    else:
        fleet(int(args[0]) if args else 64)
