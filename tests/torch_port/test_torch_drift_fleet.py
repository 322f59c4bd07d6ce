"""drift_fit_spectra_batch of the port against the JAX package's on the
drift bench's fleet (benchmarks/bench_drift.py:make_fleet, thinned), a
series DRT with the batched ridge seed, for each of the eight drift
models: float64 on the CPU, both packages from the JAX package's own
starts (its ridge seed and jax.random draws; drift basins are multimodal
and L-BFGS amplifies last-bit differences), held at 25 L-BFGS
iterations."""

import numpy as np
import pytest
import torch

from bayes_drt_tpu.models import drift as jax_drift
from bayes_drt_tpu.parallel import drift_fit_spectra_batch as jax_fleet
from bayes_drt_tpu_torch.models.drift import unravel_drift
from bayes_drt_tpu_torch.parallel import batch, drift_fit_spectra_batch
from jax_drift_reference import fleet_starts, port_init_from
from test_torch_drift import BASIS, TAU, _assert_fleet_close, _fleet

torch.set_num_threads(1)

# the port's own ridge seed against the JAX package's: 1e-8 of each
# value's largest entry
SEED_TOL = 1e-8


@pytest.mark.parametrize("model", jax_drift.DRIFT_MODELS)
def test_fleet_series_matches_jax(model):
    """x1 (the bench's model) with the bench's 2 restarts on an even
    number of points (N = 30: the residual median averages the two middle
    values, as jnp.median does, where torch.median takes the lower); the
    other models seeded only (no restarts: the restart rows' handling is
    x1's and the parallel forms'), on N = 31."""
    freq, times, Zb = _fleet(even=model == "x1")
    n_restarts = 2 if model == "x1" else 0
    kw = dict(drift_model=model, n_restarts=n_restarts, min_tau_drift=100.0,
              max_iter=25, basis_freq=BASIS, random_seed=0)
    want = jax_fleet(freq, times, Zb, **kw)
    cfg = jax_drift.DriftConfig(model, "series", False, len(TAU))
    seeded, rand = fleet_starts(cfg, None, freq, Zb, TAU, 0, n_restarts)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch, "init_drift_params",
                   port_init_from(seeded, rand, seen))
        got = drift_fit_spectra_batch(freq, times, Zb, device="cpu",
                                      dtype=torch.float64, **kw)
    _assert_fleet_close(got, want)
    # the port's own batched ridge seed is the JAX package's
    pcfg = batch.DriftConfig(model, "series", False, len(TAU))
    jax_rows = unravel_drift(pcfg, torch.as_tensor(seeded))
    for name in ("Rinf0_raw", "induc_raw", "x0", "x1", "dx", "x2"):
        if name in jax_rows:
            want_v = jax_rows[name].numpy()
            np.testing.assert_allclose(
                np.broadcast_to(seen[0][name], want_v.shape), want_v,
                rtol=0, atol=SEED_TOL * np.abs(want_v).max(), err_msg=name)
