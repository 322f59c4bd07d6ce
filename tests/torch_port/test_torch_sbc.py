"""Simulation-based calibration (sbc.py) against the JAX package, float64
on the CPU: the (ups_raw, ds) prior marginal's value and gradient, its
non-finite value where M is not positive definite, the dataset
generator's deterministic core fed the JAX package's own draws, the rank
machinery on the same numpy inputs, and the JAX package's small SBC cases
(tests/test_round4.py) run through the port with their own assertions."""

import jax
import jax.numpy as jnp
import jax.random as jrandom
import numpy as np
import pytest
import torch

from bayes_drt_tpu import sbc as jax_sbc
from bayes_drt_tpu.parallel.batch import _build_shared as jax_build_shared
from bayes_drt_tpu_torch import sbc
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.models.posterior import outlier_monitor_indices
from bayes_drt_tpu_torch.parallel import fit_spectra_batch
from bayes_drt_tpu_torch.parallel.batch import _build_shared

torch.set_num_threads(1)

# value and gradient of the marginal, and the generator's deterministic
# core, relative to the JAX package's
RTOL = 1e-10
# the rank statistics are the same numpy arithmetic
RANK_RTOL = 1e-12

FREQ = np.logspace(4, -1, 21)
BF = np.logspace(4.5, -1.5, 25)
GE_TAU = np.array([1e-2, 1.0])


def _models(outliers=False):
    _, tau, eps, cfg_j, data_j, _ = jax_build_shared(
        FREQ, basis_freq=BF, mode="sample", outliers=outliers)
    _, _, _, cfg, data, _ = _build_shared(
        FREQ, basis_freq=BF, mode="sample", outliers=outliers,
        dtype=torch.float64, device="cpu")
    return tau, eps, cfg_j, data_j, cfg, data, _phi(tau, eps, GE_TAU)


def _phi(tau, eps, ge_tau):
    return np.exp(-(eps * np.log(ge_tau[:, None] / tau[None, :])) ** 2)


@pytest.fixture(scope="module")
def small_model():
    return _models()


def test_marginal_logdensity_and_gradient_match_jax(small_model):
    _, _, cfg_j, data_j, cfg, data, _ = small_model
    k = data.L[0].shape[-1]
    rng = np.random.default_rng(3)
    u = np.concatenate([rng.normal(-1, 0.4, (6, k)),
                        rng.normal(0, 0.4, (6, 3))], axis=1)
    logp_j, k_j = jax_sbc._marginal_logdensity(cfg_j, data_j)
    vg_j = jax.vmap(jax.value_and_grad(logp_j))
    want_v, want_g = (np.asarray(a) for a in vg_j(jnp.asarray(u)))
    logp, k_p = sbc._marginal_logdensity(cfg, data)
    got_v, got_g = sbc.marginal_value_and_grad(logp)(torch.as_tensor(u))
    assert k_p == k_j == k
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=RTOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=RTOL,
                               atol=RTOL * np.abs(want_g).max())


def test_marginal_not_positive_definite_is_nonfinite(small_model):
    """ds -> 0 makes M singular: the JAX package's Cholesky gives NaN, the
    port's cholesky_ex reports it and the value is NaN (never the partial
    factor's finite value); the other rows are untouched."""
    _, _, cfg_j, data_j, cfg, data, _ = small_model
    k = data.L[0].shape[-1]
    u = np.zeros((2, k + 3))
    u[1, k:] = -800.0                  # ds = exp(-800) = 0 in float64
    logp_j, _ = jax_sbc._marginal_logdensity(cfg_j, data_j)
    logp, _ = sbc._marginal_logdensity(cfg, data)
    got = logp(torch.as_tensor(u)).numpy()
    assert not np.isfinite(float(logp_j(jnp.asarray(u[1]))))
    assert not np.isfinite(got[1])
    np.testing.assert_allclose(got[0], float(logp_j(jnp.asarray(u[0]))),
                               rtol=RTOL)


def _jax_draws(seed, n_sets, k, n, outliers, so_alpha):
    """The standard draws of the JAX package's generate_datasets (its
    threefry keys and splits, gen_one's order)."""
    keys = jrandom.split(jrandom.PRNGKey(
        np.random.default_rng(seed).integers(2 ** 31)), n_sets)
    d = {"xi": [], "hn": [], "eps": [], "so_exp": [], "so_gamma": []}
    f64 = jnp.float64
    for key in keys:
        if outliers:
            k1, k2, k3, k4, k5 = jrandom.split(key, 5)
            d["so_exp"].append(jrandom.exponential(k4, (n,), dtype=f64))
            d["so_gamma"].append(jrandom.gamma(k5, so_alpha, (n,),
                                               dtype=f64))
        else:
            k1, k2, k3 = jrandom.split(key, 3)
        d["xi"].append(jrandom.normal(k1, (k,), dtype=f64))
        d["hn"].append(jrandom.normal(k2, (6,), dtype=f64))
        d["eps"].append(jrandom.normal(k3, (2 * n,), dtype=f64))
    return {key: (np.stack([np.asarray(a) for a in v]) if v else None)
            for key, v in d.items()}


@pytest.mark.parametrize("outliers", [False, True])
def test_dataset_core_matches_jax(outliers):
    _, _, cfg_j, data_j, cfg, data, phi = _models(outliers)
    k, n, n_sets = data.L[0].shape[-1], len(FREQ), 6
    rng = np.random.default_rng(4)
    ups_raw = np.exp(rng.normal(-1.5, 0.3, (n_sets, k)))
    ds = np.exp(rng.normal(0, 0.3, (n_sets, 3)))
    z_j, tr_j = jax_sbc.generate_datasets(cfg_j, data_j, ups_raw, ds,
                                          jnp.asarray(phi), seed=5)
    draws = _jax_draws(5, n_sets, k, n, outliers,
                       float(data_j.sigma_out_alpha))
    z, tr = sbc.datasets_from_draws(cfg, data, ups_raw, ds, phi, **draws)
    assert tr.shape == tr_j.shape == (n_sets, 6 + 2 + (3 if outliers else 0))
    np.testing.assert_allclose(z, z_j, rtol=RTOL)
    np.testing.assert_allclose(tr, tr_j, rtol=RTOL)
    # the port's own generator: the same shapes, finite, positive scalars
    z2, tr2 = sbc.generate_datasets(cfg, data, ups_raw, ds, phi, seed=5)
    assert z2.shape == z.shape and tr2.shape == tr.shape
    assert np.isfinite(z2).all() and (tr2[:, :6] >= 0).all()


def test_rank_machinery_matches_jax():
    rng = np.random.default_rng(9)
    chains, s, n_mon, n_sets = 4, 37, 5, 40
    md = np.cumsum(rng.standard_normal((n_sets, chains, s, n_mon)), axis=2)
    md = md.reshape(n_sets, chains * s, n_mon)
    np.testing.assert_allclose(sbc.monitor_ess(md, chains),
                               jax_sbc.monitor_ess(md, chains),
                               rtol=RANK_RTOL)
    truths = rng.standard_normal((n_sets, n_mon)) * 3.0
    ranks = sbc.sbc_ranks(truths, md)
    np.testing.assert_array_equal(ranks, jax_sbc.sbc_ranks(truths, md))
    for n_bins in (8, 16):
        got = sbc.rank_uniformity(ranks, md.shape[1], n_bins=n_bins)
        want = jax_sbc.rank_uniformity(ranks, md.shape[1], n_bins=n_bins)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RANK_RTOL)
    np.testing.assert_array_equal(
        sbc.ecdf_envelope_violations(ranks, md.shape[1]),
        jax_sbc.ecdf_envelope_violations(ranks, md.shape[1]))
    assert sbc.MONITOR_SCALARS == jax_sbc.MONITOR_SCALARS


# --- the JAX package's small SBC cases (tests/test_round4.py), port side --

def test_sbc_generate_and_rank_machinery(small_model):
    tau, eps, _, _, cfg, data, _ = small_model
    rng = np.random.default_rng(4)
    n_sets = 24
    k = data.L[0].shape[-1]
    ups_raw = np.exp(rng.normal(-1.5, 0.3, (n_sets, k)))
    ds = np.exp(rng.normal(0, 0.3, (n_sets, 3)))
    ge_tau = np.array([1e-3, 1e-1, 10.0])
    phi = _phi(tau, eps, ge_tau)
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds, phi, seed=5)
    assert z.shape == (n_sets, 21) and np.isfinite(z).all()
    assert truths.shape == (n_sets, 6 + 3) and np.isfinite(truths).all()
    assert (truths[:, 0] > 0).all()    # Rinf half-normal

    L_draws = 40
    cal = rng.standard_normal((200, L_draws, 2))
    tr = rng.standard_normal((200, 2))
    ranks = sbc.sbc_ranks(tr, cal)
    assert ranks.shape == (200, 2) and ranks.min() >= 0
    assert ranks.max() <= L_draws
    p_ok, _ = sbc.rank_uniformity(ranks, L_draws, n_bins=8)
    assert (p_ok > 1e-4).all(), p_ok
    p_bad, _ = sbc.rank_uniformity(
        sbc.sbc_ranks(tr + 1.5, cal), L_draws, n_bins=8)
    assert (p_bad < 1e-6).all(), p_bad


def test_sbc_end_to_end_small(small_model):
    """Prior draws -> datasets -> the production batched fit (z_scale=1,
    monitor_thin) -> ranks, at the JAX test's small budget."""
    tau, _, _, _, cfg, data, phi = small_model
    n_sets = 8
    ups_raw, ds, diag = sbc.sample_prior_marginal(cfg, data, n_sets, seed=2,
                                                  warmup=150)
    assert diag["divergence_rate"] < 0.2
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds, phi, seed=6)
    res = fit_spectra_batch(
        FREQ, z, mode="sample", chains=2, warmup=60, samples=60,
        random_seed=0, ncp=True, sampler="shmc",
        shmc_cfg=SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5),
        basis_freq=1.0 / (2 * np.pi * tau), gamma_eval_tau=GE_TAU,
        z_scale=1.0, monitor_thin=6, device="cpu", dtype=torch.float64)
    md = res.diagnostics["monitor_draws"]
    assert md.shape == (n_sets, 2 * 10, 8)
    ranks = sbc.sbc_ranks(truths, md)
    assert ranks.shape == (n_sets, 8)
    assert (ranks >= 0).all() and (ranks <= md.shape[1]).all()
    np.testing.assert_allclose(res.z_scales, 1.0)


def test_sbc_outlier_model_generate_and_fit():
    tau, _, _, _, cfg, data, phi = _models(outliers=True)
    assert cfg.outliers
    rng = np.random.default_rng(7)
    n_sets = 24
    k = data.L[0].shape[-1]
    ups_raw = np.exp(rng.normal(-1.5, 0.3, (n_sets, k)))
    ds = np.exp(rng.normal(0, 0.3, (n_sets, 3)))
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds, phi, seed=8)
    idx = outlier_monitor_indices(len(FREQ))
    assert truths.shape == (n_sets, 6 + 2 + len(idx))
    so = truths[:, 8:]
    assert (so > 0).all()
    # E[sigma_out] = 0.05 * (1/lambda) * b/(a-1)
    lam = float(data.sigma_out_lambda)
    a, b = float(data.sigma_out_alpha), float(data.sigma_out_beta)
    want_mean = 0.05 * (1.0 / lam) * b / (a - 1.0)
    assert 0.5 * want_mean < so.mean() < 2.0 * want_mean, (so.mean(),
                                                          want_mean)
    res = fit_spectra_batch(
        FREQ, z[:8], mode="sample", chains=2, warmup=40, samples=40,
        random_seed=0, ncp=True, sampler="shmc", outliers=True,
        shmc_cfg=SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5),
        basis_freq=1.0 / (2 * np.pi * tau), gamma_eval_tau=GE_TAU,
        z_scale=1.0, monitor_thin=8, device="cpu", dtype=torch.float64)
    md = res.diagnostics["monitor_draws"]
    assert md.shape == (8, 2 * 5, 6 + 2 + len(idx))
    assert np.isfinite(md).all()
    ranks = sbc.sbc_ranks(truths[:8], md)
    assert ranks.shape == (8, md.shape[-1])
    assert (ranks >= 0).all() and (ranks <= md.shape[1]).all()
