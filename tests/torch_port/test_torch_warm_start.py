"""Resumed and preconditioned sampling against the JAX package (CPU):
the warm-start guards with the JAX package's messages, the dual
averaging seeded at the carried step size, the SHMC resume's chain means,
chained NUTS, SHMC and ragged refits at the JAX tests' gates, the pooled
metric from one pilot array fed to both packages, and the pooled fit at
the JAX test's gates."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer import nuts as jax_nuts
from bayes_drt_tpu.parallel import batch as jax_batch
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import nuts
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.parallel import (evaluate_gamma, fit_spectra_batch,
                                          fit_spectra_ragged)
from bayes_drt_tpu_torch.parallel import batch
from jax_noise_reference import jax_nuts_stream

torch.set_num_threads(1)

FREQ = np.logspace(5, -1, 31)
# the JAX tests' NUTS runs md6 with tree_scan=True at 150-draw warmups;
# on the CPU the fits here run md5 (at most 31 leaves a tree) and the
# early-stop form (the same draws as tree_scan), at the budgets each test
# names
NUTS_KW = dict(mode="sample", chains=2, max_tree_depth=5, ncp=True,
               device="cpu", dtype=torch.float64)


def _spectra(b=2, scale=1.0, noise=0.002, seed=0):
    freq, Zb = sim.make_benchmark_batch(b, freq=FREQ, noise_level=noise,
                                        seed=seed)
    return freq, scale * Zb


def _rmse_mean(res, scale=1.0):
    """RMSE of the batch-mean gamma against the scaled ZARC truth, and
    the truth's Rp (the JAX tests' figures)."""
    tau = res.tau
    truth = scale * sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(truth, np.log(tau))
    g = evaluate_gamma(res, tau)
    return float(np.sqrt(np.mean((g.mean(axis=0) - truth) ** 2))), rp


@pytest.fixture(scope="module")
def tiny_nuts():
    freq, Zb = _spectra()
    return freq, Zb, fit_spectra_batch(freq, Zb, warmup=20, samples=10,
                                       random_seed=0, **NUTS_KW)


def test_warm_start_guards(tiny_nuts):
    """Every guard of the JAX package's warm start, with its message."""
    freq, Zb, res0 = tiny_nuts
    kw = dict(NUTS_KW, warmup=5, samples=5)
    for k in ("state_q", "state_inv_mass", "state_step_size"):
        d = {kk: v for kk, v in res0.diagnostics.items() if kk != k}
        with pytest.raises(ValueError, match=f"missing diagnostics\\['{k}'"):
            fit_spectra_batch(freq, Zb, warm_start=res0._replace(
                diagnostics=d), **kw)
    with pytest.raises(ValueError, match="different model configuration "
                       r"\(Series, ncp=True\)"):
        fit_spectra_batch(freq, Zb, warm_start=res0, **{**kw, "ncp": False})
    with pytest.raises(ValueError, match="batch layout \\(same spectra"):
        fit_spectra_batch(freq, _spectra(3)[1], warm_start=res0, **kw)
    with pytest.raises(ValueError, match="carries 2 chains, this fit "
                       "requests 4"):
        fit_spectra_batch(freq, Zb, warm_start=res0, **{**kw, "chains": 4})
    with pytest.raises(ValueError, match="mutually exclusive"):
        fit_spectra_batch(freq, Zb, warm_start=res0, precondition="pooled",
                          **kw)
    with pytest.raises(ValueError, match="builds a dense metric"):
        fit_spectra_batch(freq, Zb, precondition="pooled", sampler="shmc",
                          **kw)
    # ChEES (ported) resumes only from a result carrying its trajectory
    # time, which a NUTS fit lacks
    with pytest.raises(ValueError, match=r"sampler='chees' needs "
                       r"diagnostics\['state_traj_time'\] \(a previous "
                       "chees fit\)"):
        fit_spectra_batch(freq, Zb, warm_start=res0, sampler="chees", **kw)
    spectra = [(freq, z) for z in Zb]
    with pytest.raises(ValueError, match="different model configuration "
                       "than this fit"):
        fit_spectra_ragged(spectra, warm_start=res0, **{**kw, "ncp": False})
    with pytest.raises(ValueError, match="keep the batch layout across"):
        fit_spectra_ragged(spectra[:1], warm_start=res0, **kw)


def test_da_init_seeds_eps_bar():
    """The JAX package's test_da_init_seeds_eps_bar, and a warmup=0
    resume that samples at the step size its search found from the
    carried one, as JAX's does draw for draw."""
    da = nuts._da_init(torch.tensor([0.37, 0.05], dtype=torch.float64))
    np.testing.assert_allclose(torch.exp(da.log_eps_bar).numpy(),
                               [0.37, 0.05], rtol=1e-12)
    d, chains, md = 4, 2, 4
    prec = np.diag(np.linspace(1.0, 4.0, d))
    P = torch.as_tensor(prec)
    prec_j = jnp.asarray(prec)

    def vg(q):
        g = -(q @ P)
        return 0.5 * (q * g).sum(-1), g

    eps_c = np.array([0.3, 0.6])
    m_c = np.array([[1.0, 0.5, 0.4, 0.3], [0.9, 0.6, 0.4, 0.2]])
    keys = jax.random.split(jax.random.PRNGKey(7), chains)
    q0 = np.random.default_rng(2).standard_normal((chains, d))
    cfg_j = jax_nuts.NUTSConfig(max_depth=md, tree_scan=True,
                                adapt_mass=False)
    draws_j, info_j = jax.vmap(lambda qq, k, m, e: jax_nuts.sample_nuts(
        lambda x: -0.5 * x @ (prec_j @ x), qq, k, warmup=0, samples=6,
        cfg=cfg_j, metric=m, init_step_size=e))(
        jnp.asarray(q0), keys, jnp.asarray(m_c), jnp.asarray(eps_c))
    noise = jax_nuts_stream(keys, d, md, 6)
    draws, info = nuts.sample_nuts(
        vg, torch.as_tensor(q0), 0, 6,
        nuts.NUTSConfig(max_depth=md, tree_scan=True, adapt_mass=False),
        noise=lambda: iter(noise), metric=torch.as_tensor(m_c),
        init_step_size=torch.as_tensor(eps_c))
    np.testing.assert_allclose(info["step_size"].numpy(),
                               np.asarray(info_j["step_size"]), rtol=1e-12)
    np.testing.assert_allclose(draws.numpy(),
                               np.asarray(draws_j).transpose(1, 0, 2),
                               rtol=1e-10, atol=1e-12)


def test_shmc_resume_takes_the_jax_chain_means():
    """A SHMC resume's per-spectrum metric and step size are the means
    over each spectrum's chains, as the JAX package's vmapped
    wm_.mean(axis=0) and weps_.mean() compute them; NUTS keeps every
    chain's own, each metric held fixed."""
    rng = np.random.default_rng(3)
    b, c, d = 8, 3, 5
    warm = (rng.standard_normal((b, c, d)), rng.uniform(0.1, 2, (b, c, d)),
            rng.uniform(0.01, 0.2, (b, c)))
    q0, cfg, metric, eps = batch._warm_run(
        "shmc", SHMCConfig(), warm, torch.float64, "cpu")
    want_m = jax.vmap(lambda w: w.mean(axis=0))(jnp.asarray(warm[1]))
    want_e = jax.vmap(lambda w: w.mean())(jnp.asarray(warm[2]))
    np.testing.assert_allclose(metric.numpy(), np.asarray(want_m),
                               rtol=1e-15)
    np.testing.assert_allclose(eps.numpy(), np.asarray(want_e), rtol=1e-15)
    assert cfg.adapt_mass is False
    np.testing.assert_array_equal(q0.numpy(), warm[0].reshape(b * c, d))
    q0, cfg, metric, eps = batch._warm_run(
        "nuts", nuts.NUTSConfig(), warm, torch.float64, "cpu")
    np.testing.assert_array_equal(metric.numpy(), warm[1].reshape(b * c, d))
    np.testing.assert_array_equal(eps.numpy(), warm[2].reshape(-1))
    assert cfg.adapt_mass is False


def test_warm_start_chained_refit():
    """The JAX package's test_warm_start_chained_refit on simulated
    spectra (cold fits at 2 x (100 + 60)): the evolved batch (x 1.03)
    resumed at a fifth of the warmup recovers gamma within max(1.5x a
    cold fit's RMSE, 5% Rp), with < 5% divergences; the state carries
    over per chain."""
    freq, Zb0 = _spectra()
    Zb1 = 1.03 * Zb0
    res0 = fit_spectra_batch(freq, Zb0, warmup=100, samples=60,
                             random_seed=0, **NUTS_KW)
    assert res0.diagnostics["state_q"].shape[:2] == (2, 2)
    res1 = fit_spectra_batch(freq, Zb1, warmup=20, samples=60,
                             random_seed=1, warm_start=res0, **NUTS_KW)
    cold = fit_spectra_batch(freq, Zb1, warmup=100, samples=60,
                             random_seed=1, **NUTS_KW)
    rmse_warm, rp = _rmse_mean(res1, 1.03)
    rmse_cold, _ = _rmse_mean(cold, 1.03)
    assert rmse_warm < max(1.5 * rmse_cold, 0.05 * rp), (rmse_warm,
                                                          rmse_cold)
    assert res1.diagnostics["divergence_rate"].mean() < 0.05
    # the metric is held: the resumed fit ends with the carried one
    np.testing.assert_array_equal(res1.diagnostics["state_inv_mass"],
                                  res0.diagnostics["state_inv_mass"])
    assert "escalated" not in res1.diagnostics


def test_shmc_warm_start_refit():
    """The JAX package's test_shmc_warm_start_refit through the
    flat-chain sampler (the trajectory kernel's plain version here):
    RMSE < max(2x the source fit's, 8% Rp)."""
    freq, Zb = _spectra()
    kw = dict(mode="sample", chains=2, ncp=True, sampler="shmc",
              escalate=False, device="cpu", dtype=torch.float64,
              shmc_cfg=SHMCConfig(n_steps=16, warm_steps=16,
                                  eps_quantile=0.5))
    res0 = fit_spectra_batch(freq, Zb, warmup=60, samples=60,
                             random_seed=0, **kw)
    res1 = fit_spectra_batch(freq, Zb, warmup=10, samples=60,
                             random_seed=1, warm_start=res0, **kw)
    assert np.isfinite(res1.coef).all()
    r0, rp = _rmse_mean(res0)
    r1, _ = _rmse_mean(res1)
    assert r1 < max(2.0 * r0, 0.08 * rp), (r0, r1)
    # the held metric is the carried per-spectrum one
    np.testing.assert_allclose(res1.diagnostics["state_inv_mass"],
                               res0.diagnostics["state_inv_mass"],
                               rtol=1e-12)


def test_ragged_warm_start_refit():
    """The JAX package's test_ragged_warm_start_refit on two grids of the
    same ZARC spectrum: the resumed fit's first spectrum within 15% Rp."""
    f1 = np.logspace(5, -1, 31)
    f2 = np.logspace(4.5, -0.5, 23)
    spectra = [(f, sim.noisy_replicas(sim.reference_circuit("ZARC", f), 1,
                                      0.002, seed=i)[0])
               for i, f in enumerate((f1, f2))]
    kw = dict(mode="sample", chains=2, max_tree_depth=5, ncp=True,
              device="cpu", dtype=torch.float64)
    res0 = fit_spectra_ragged(spectra, warmup=60, samples=50, random_seed=0,
                              **kw)
    res1 = fit_spectra_ragged(spectra, warmup=10, samples=50, random_seed=1,
                              warm_start=res0, **kw)
    assert np.isfinite(res1.coef).all()
    tau = res1.tau
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    g1 = evaluate_gamma(res1, tau)
    assert np.sqrt(np.mean((g1[0] - gt) ** 2)) < 0.15 * rp


def test_pooled_metric_matches_jax():
    """One pilot array fed to both packages: the JAX package's pooled
    fit takes it in place of its pilot run, and the metric it hands its
    main run equals the port's pooled_metric at 1e-12 (its Cholesky
    factor too)."""
    freq, Zb = _spectra()
    rng = np.random.default_rng(8)
    b, c, s, d = 8, 2, 25, 12
    mix = rng.standard_normal((d, d))
    pilot = (rng.standard_normal((b, c, s, d)) @ mix
             + rng.standard_normal((b, c, 1, d)))
    seen = {}

    class Stop(Exception):
        pass

    real = jax_batch._cached_program

    def fake(key, builder):
        if "pilot" in key:
            return lambda *a: jnp.asarray(pilot)
        if "pooled-main" in key:
            def main(*args):
                seen["args"] = args
                raise Stop
            return main
        return real(key, builder)

    jax_batch._cached_program = fake
    try:
        with pytest.raises(Stop):
            jax_batch.fit_spectra_batch(freq, Zb, mode="sample", chains=c,
                                        warmup=150, samples=100,
                                        precondition="pooled",
                                        pilot_samples=s, dtype=jnp.float64)
    finally:
        jax_batch._cached_program = real
    # the main run's shared arguments: (data, m_inv, chol, phi_mon, phi_eval)
    m_j, chol_j = (np.asarray(a) for a in seen["args"][-4:-2])
    m_inv, chol = batch.pooled_metric(pilot)
    np.testing.assert_allclose(m_inv, m_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(chol, chol_j, rtol=1e-12, atol=1e-12)


def test_pooled_preconditioned_batch_matches():
    """The JAX package's test_pooled_preconditioned_batch_matches on
    simulated spectra: RMSE < 6% Rp, divergences < 5%; the main run
    samples with one dense metric (the pilot's pooled one)."""
    freq, Zb = _spectra(b=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = fit_spectra_batch(freq, Zb, chains=2, warmup=150, samples=100,
                                max_tree_depth=5, random_seed=1,
                                precondition="pooled", pilot_warmup=50,
                                pilot_samples=25, escalate=False,
                                mode="sample", device="cpu",
                                dtype=torch.float64)
    rmse, rp = _rmse_mean(res)
    assert rmse < 0.06 * rp, (rmse, rp)
    assert res.diagnostics["divergence_rate"].mean() < 0.05
    m = res.diagnostics["state_inv_mass"]
    assert m.shape[:2] == (4, 2) and m.shape[2] == m.shape[3]
    np.testing.assert_array_equal(m[0, 0], m[-1, -1])
