"""SHMCConfig(traj_store=True), the store-then-select trajectory, against
the JAX package's (bayes_drt_tpu/infer/chees.py:617-671) in float64 on
the CPU: a whole run replaying the JAX sampler's own random numbers, the
counterparts of the JAX package's traj_store tests
(tests/test_round4.py:23-56) run on both packages, and the routes
fit_spectra_batch takes with it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer import chees as jax_chees
from bayes_drt_tpu.parallel.batch import fit_spectra_batch as jax_fit
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import chees
from bayes_drt_tpu_torch.parallel import batch
from jax_noise_reference import jax_shmc_stream

torch.set_num_threads(1)


def _corr_gauss(d=8, seed=0):
    """test_round4.py's correlated Gaussian: its covariance, the JAX log
    density, the port's batched value and gradient and the numpy rng."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = a @ a.T / d + np.eye(d)
    prec = np.linalg.inv(cov)
    prec_j = jnp.asarray(prec)
    P = torch.as_tensor(prec)

    def vg(q):
        g = -q @ P
        return 0.5 * torch.sum(q * g, dim=1), g

    return cov, (lambda q: -0.5 * q @ prec_j @ q), vg, rng


def test_traj_store_replays_jax_noise():
    """Two spectra of 3 chains with JAX's random numbers (the Gumbel-max
    uniforms included): the port's store-then-select sampler reproduces
    JAX's sample_shmc(traj_store=True) draw for draw, through the
    adaptation and a tight energy bound that kills legs."""
    d, b, chains, warmup, samples = 4, 2, 3, 30, 10
    _, logp, vg, rng = _corr_gauss(d, seed=2)
    kw = dict(n_steps=5, warm_steps=3, traj_store=True, eps_quantile=0.5,
              init_buffer=5, term_buffer=5, base_window=5,
              max_energy_error=0.5)
    keys = jax.random.split(jax.random.PRNGKey(4), b)
    q0 = rng.standard_normal((b, chains, d))
    cfg_j = jax_chees.SHMCConfig(**kw)
    draws_j, info_j = jax.vmap(lambda qq, k: jax_chees.sample_shmc(
        logp, qq, k, warmup=warmup, samples=samples, cfg=cfg_j))(
        jnp.asarray(q0), keys)
    noise = jax_shmc_stream(keys, d, chains, [3] * warmup + [5] * samples,
                            store=True)
    draws, info = chees.sample_shmc(
        vg, torch.as_tensor(q0.reshape(b * chains, d)), warmup, samples,
        chees.SHMCConfig(**kw), chains, noise=lambda: iter(noise))
    np.testing.assert_allclose(draws.numpy(), np.asarray(draws_j),
                               rtol=1e-9, atol=1e-9)
    for k in ("logp", "accept_prob", "energy", "step_size", "inv_mass"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    for k in ("diverging", "warmup_diverging", "n_leapfrog"):
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k])), k
    # dead legs were replayed too
    assert bool(info["warmup_diverging"].any() or info["diverging"].any())


@pytest.mark.parametrize("package", ["port", "jax"])
def test_traj_store_matches_streaming_statistically(package):
    """test_round4.py:23-40 in either package: the store and streaming
    forms sample the same Gaussian (mean, covariance, acceptance)."""
    d = 8
    cov, logp, vg, rng = _corr_gauss(d)
    q0 = rng.standard_normal((4, d))
    for ts in (False, True):
        if package == "jax":
            cfg = jax_chees.SHMCConfig(n_steps=16, warm_steps=8,
                                       traj_store=ts, eps_quantile=0.5)
            draws, info = jax_chees.sample_shmc(
                logp, jnp.asarray(q0), jax.random.PRNGKey(0), warmup=300,
                samples=500, cfg=cfg)
            x = np.asarray(draws).reshape(-1, d)
            acc = float(np.asarray(info["accept_prob"]).mean())
        else:
            cfg = chees.SHMCConfig(n_steps=16, warm_steps=8, traj_store=ts,
                                   eps_quantile=0.5)
            draws, info = chees.sample_shmc(
                vg, torch.as_tensor(q0), 300, 500, cfg, 4,
                generator=torch.Generator().manual_seed(0))
            x = draws.reshape(-1, d).numpy()
            acc = float(info["accept_prob"].mean())
        assert np.abs(x.mean(0)).max() < 0.15, (ts, x.mean(0))
        rel = np.abs(np.cov(x.T) - cov).max() / np.abs(cov).max()
        assert rel < 0.15, (ts, rel)
        assert acc > 0.6


@pytest.mark.parametrize("package", ["port", "jax"])
def test_traj_store_divergences_never_selected(package):
    """test_round4.py:43-56 in either package: with a tiny energy budget
    most legs die, a dead leg's states carry w = -inf and are never
    selected, so every draw stays finite."""
    _, logp, vg, rng = _corr_gauss(4, seed=1)
    q0 = rng.standard_normal((2, 4))
    kw = dict(n_steps=8, traj_store=True, max_energy_error=0.5, delta=0.05)
    if package == "jax":
        draws, info = jax_chees.sample_shmc(
            logp, jnp.asarray(q0), jax.random.PRNGKey(1), warmup=50,
            samples=100, cfg=jax_chees.SHMCConfig(**kw))
        draws, div = np.asarray(draws), np.asarray(info["diverging"])
    else:
        draws, info = chees.sample_shmc(
            vg, torch.as_tensor(q0), 50, 100, chees.SHMCConfig(**kw), 2,
            generator=torch.Generator().manual_seed(1))
        draws, div = draws.numpy(), info["diverging"].numpy()
    assert np.isfinite(draws).all()
    assert div.mean() > 0.2


def test_fit_spectra_batch_traj_store_routes():
    """fit_spectra_batch(sampler='shmc', traj_store=True) on the single
    series DRT in both packages (the JAX package's generic path, the
    port's generic store form: the trajectory kernel has none), the same
    diagnostics and shapes, finite coefficients; naming the flat-chain
    arm too runs the kernel and ignores traj_store, as JAX's flat arm
    does."""
    freq, Zb = sim.make_benchmark_batch(2, freq=np.logspace(5, -1, 21))
    kw = dict(chains=2, warmup=30, samples=20, ncp=True, sampler="shmc",
              escalate=False)
    cfg_kw = dict(n_steps=8, warm_steps=8, traj_store=True, eps_quantile=0.5)
    got = batch.fit_spectra_batch(freq, Zb, device="cpu",
                                  shmc_cfg=chees.SHMCConfig(**cfg_kw), **kw)
    want = jax_fit(freq, Zb, shmc_cfg=jax_chees.SHMCConfig(**cfg_kw), **kw)
    assert got.diagnostics["shmc_route"] == "generic-store"
    for k, v in want.diagnostics.items():
        if k != "state_cfg":
            assert np.shape(got.diagnostics[k]) == np.shape(v), k
    assert np.isfinite(got.coef).all() and np.isfinite(want.coef).all()
    flat = batch.fit_spectra_batch(
        freq, Zb, device="cpu",
        shmc_cfg=chees.SHMCConfig(**cfg_kw, pallas_traj=True), **kw)
    assert flat.diagnostics["shmc_route"] == "flat-kernel"
    assert np.isfinite(flat.coef).all()
