"""The batch entry points' fits on a mesh of virtual CPU shards against
the JAX package's virtual 8-device CPU mesh (tests/conftest.py): MAP's
layout (tests/test_parallel.py:220-245) and its sharded fit against
the unsharded one at the JAX test's bar (:65-72), a ragged NUTS fit's
layout (tests/test_round3.py:469-478) and the drift fleet at its fit
quality bar (:596-606). The mesh itself, the ridge, the one-shard
identities and the CLI are in test_torch_mesh.py.

On the CPU a row of a 1- or 2-row matrix product gets other bits from
the BLAS than the same row of a larger one, and the MAP posterior's
L-BFGS is chaotic on spectra it does not converge on, so MAP's equality
bar is held on shards of several spectra; the 8-shard MAP fit is held to
the layout and the fit's quality, as the JAX package holds its sharded
drift fit."""

import numpy as np
import torch

from bayes_drt_tpu.parallel import drift_fit_spectra_batch as jax_drift
from bayes_drt_tpu.parallel import fit_spectra_batch as jax_fit
from bayes_drt_tpu.parallel import fit_spectra_ragged as jax_ragged
from bayes_drt_tpu.parallel import make_mesh as jax_make_mesh
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.parallel import (drift_fit_spectra_batch,
                                          evaluate_gamma, fit_spectra_batch,
                                          fit_spectra_ragged, make_mesh)

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
EIGHT = tuple((i, i, i + 1) for i in range(8))


def _batch(b=8, n=41, noise=0.002, seed=0):
    return sim.make_benchmark_batch(b, freq=np.logspace(6, -2, n),
                                    noise_level=noise, seed=seed)


def _cpu_mesh(n):
    return make_mesh(n, device="cpu")


def test_map_partitions_like_jax():
    """tests/test_parallel.py:220-245 in both packages: the 8-spectrum
    MAP fit on 8 shards lands one spectrum a device, disjoint single-row
    ranges tiling 0..8; the port's fit is finite and its median spectrum
    within the JAX MAP test's bar, as the meshless fit's is (one spectrum
    of these, on the 31-point grid at 200 iterations, misses it in
    both)."""
    freq, Zb = _batch(8, n=31)
    kw = dict(mode="optimize", max_iter=200, n_restarts=2, random_seed=0)
    got = fit_spectra_batch(freq, Zb, mesh=_cpu_mesh(8), **F64, **kw)
    want = jax_fit(freq, Zb, mesh=jax_make_mesh(8), **kw)
    assert got.diagnostics["shard_layout"] == want.diagnostics[
        "shard_layout"]
    layout = got.diagnostics["shard_layout"]
    assert len({d for d, _, _ in layout}) == 8
    assert sorted((lo, hi) for _, lo, hi in layout) == [
        (i, i + 1) for i in range(8)]
    tau = got.tau
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    assert np.isfinite(got.coef).all()
    for res in (got, fit_spectra_batch(freq, Zb, **F64, **kw)):
        rmse = np.sqrt(np.mean((evaluate_gamma(res, tau) - gt) ** 2, axis=1))
        assert np.median(rmse) < 0.08 * rp, rmse / rp


def test_map_sharded_matches_unsharded():
    """tests/test_parallel.py:65-72 on the JAX test's 81-point grid: the
    MAP fit on 4 shards (the same starts, drawn for the whole batch and
    sliced) equals the unsharded one at the JAX test's bar."""
    freq, Zb = _batch(8, n=81)
    kw = dict(mode="optimize", max_iter=800, n_restarts=2, random_seed=0)
    res_m = fit_spectra_batch(freq, Zb, mesh=_cpu_mesh(4), **F64, **kw)
    res_u = fit_spectra_batch(freq, Zb, **F64, **kw)
    np.testing.assert_allclose(res_m.coef, res_u.coef, rtol=1e-4, atol=1e-6)


def test_ragged_sample_partitions_like_jax():
    """tests/test_round3.py:469-478 in sample mode: a ragged NUTS fit of 8
    spectra on 8 shards, one spectrum a device in both packages, the
    same diagnostics' shapes, finite coefficients."""
    fleet = [(f[::4], z[::4]) for f, z in sim.make_ragged_fleet(8)]
    kw = dict(chains=2, warmup=20, samples=10, ncp=True, max_tree_depth=4,
              random_seed=0)
    got = fit_spectra_ragged(fleet, mesh=_cpu_mesh(8), device="cpu", **kw)
    want = jax_ragged(fleet, mesh=jax_make_mesh(8), **kw)
    assert got.diagnostics["shard_layout"] == want.diagnostics[
        "shard_layout"]
    assert got.diagnostics["shard_layout"] == EIGHT
    for k, v in want.diagnostics.items():
        if k != "state_cfg":
            assert np.shape(got.diagnostics[k]) == np.shape(v), k
    assert np.isfinite(got.coef).all()


def test_drift_mesh_fit_quality():
    """tests/test_round3.py:596-606: the drift fleet on 8 shards (its
    rank-1 inits sharded too) in both packages, the layout one cell a
    device, every cell's median relative residual < 0.05."""
    freq, times, Zc = sim.make_drift_fleet(4)
    kw = dict(drift_model="x1", random_seed=0, n_restarts=1,
              min_tau_drift=100.0, max_iter=200)
    got = drift_fit_spectra_batch(freq, times, Zc, mesh=_cpu_mesh(8),
                                  **F64, **kw)
    want = jax_drift(freq, times, Zc, mesh=jax_make_mesh(8), **kw)
    assert got.diagnostics["shard_layout"] == want.diagnostics[
        "shard_layout"]
    assert len({d for d, _, _ in got.diagnostics["shard_layout"]}) == 8
    assert (got.diagnostics["median_rel_resid"] < 0.05).all(), \
        got.diagnostics["median_rel_resid"]
