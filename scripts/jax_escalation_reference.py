"""The JAX package's own forced escalation of single parallel blocking-DDT
spectra, the reference figures behind the escalation gate of
chip_smoke.py's phase 13 (c).

    JAX_PLATFORMS=cpu python scripts/jax_escalation_reference.py [W+S ...]

Fits the smoke's 16 spectra (phase 11's blocking-DDT spectra: 1 + a
Cole-Cole blocking DDT (tau 0.1, beta 0.8) on logspace(6, -2, 81),
sim.noisy_replicas at 0.25% noise and seed 12, the first 16 of 64) with the
JAX package's fit_spectra_batch as the smoke calls the port's: one
parallel planar blocking DDT on logspace(6, -3, 91), sampler 'shmc', 4
chains, random_seed 3, the escalation gate forced to flag every spectrum
(ess_bulk_min = inf), so each is refitted by NUTS md8 from the Inverter's
admittance ridge; float32 (the card's default; x64 off, as the JAX
package runs on its TPU), on the CPU. Each argument
is a budget per chain as WARMUP+SAMPLES (default 50+50 and 100+100).
Prints, one JSON line a budget, the median impedance residual
|Z_hat - Z_true| / |Z_true| (the smoke's gate, <= 0.02), the splice and
the seconds.
"""

import json
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bayes_drt_tpu.parallel import (fit_spectra_batch,  # noqa: E402
                                    predict_Z_batch)
from bayes_drt_tpu_torch import sim  # noqa: E402

B = 16
CHAINS = 4
SEED = 12                 # chip_smoke.py's SP_SEED + 1


def main(argv):
    budgets = [tuple(int(x) for x in a.split("+")) for a in argv] or [
        (50, 50), (100, 100)]
    freq = np.logspace(6, -2, 81)
    bp = {"DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "blocking",
                  "dist_type": "parallel",
                  "basis_freq": np.logspace(6, -3, 91)}}
    z_true = 1 + sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc="blocking")
    zb = sim.noisy_replicas(z_true, 64, 0.0025, SEED)[:B]
    for warmup, samples in budgets:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = fit_spectra_batch(
                freq, zb, distributions=bp, sampler="shmc", chains=CHAINS,
                warmup=warmup, samples=samples, random_seed=3,
                escalate_gate=dict(ess_bulk_min=np.inf), dtype=jnp.float32)
        zhat = np.asarray(predict_Z_batch(res, freq))
        resid = np.abs(zhat - z_true[None, :]) / np.abs(z_true)[None, :]
        print(json.dumps({
            "B": B, "budget": [CHAINS, warmup, samples], "dtype": "float32",
            "seconds_cpu": time.perf_counter() - t0,
            "escalated": int(np.sum(res.diagnostics["escalated"])),
            "z_resid_median": float(np.median(resid)),
            "finite": bool(np.isfinite(np.asarray(res.coef)).all())}),
            flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
