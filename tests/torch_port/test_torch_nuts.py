"""The port's NUTS against the JAX package: one transition with the JAX
key schedule's random numbers replayed (float64), whole samplers with
replayed noise, the two tree forms, and the moments of a correlated
Gaussian."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu import sim as jax_sim
from bayes_drt_tpu.infer import nuts as jax_nuts
from bayes_drt_tpu.models.posterior import log_density
from bayes_drt_tpu.parallel.batch import _build_shared
from bayes_drt_tpu_torch.convert import (flat_shared_from_numpy,
                                         posterior_from_numpy)
from bayes_drt_tpu_torch.infer import nuts
from bayes_drt_tpu_torch.infer.shmc_flat import (flat_spec_for,
                                                 flat_value_and_grad)
from bayes_drt_tpu_torch.models.posterior import init_unconstrained, ravel
from bayes_drt_tpu_torch.parallel.batch import _ridge_init_values
from jax_noise_reference import jax_draw_noise, jax_nuts_stream

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def drt_rows():
    """16 rows of the ncp series-DRT posterior at a ridge-seeded start (4
    spectra x 4 chains, N=21), the port's value and gradient, and the JAX
    package's per-row value and gradient."""
    b, chains = 4, 4
    freq, Zb = jax_sim.make_benchmark_batch(b, freq=np.logspace(5, -1, 21),
                                            noise_level=0.003, seed=5)
    frequencies, _, _, cfg_j, data_j, _ = _build_shared(
        freq, mode="sample", ncp=True, dtype=jnp.float64)
    Zb = Zb[:, np.argsort(freq)[::-1]]
    zs = np.std(np.abs(Zb), axis=1) / np.sqrt(len(freq) / 81)
    Zs = Zb / zs[:, None]
    targets = np.repeat(np.concatenate([Zs.real, Zs.imag], axis=1), chains,
                        axis=0)
    cfg, data = posterior_from_numpy(cfg_j, data_j, dtype=torch.float64,
                                     device="cpu")
    spec = flat_spec_for(cfg, data)
    from bayes_drt_tpu.infer.shmc_flat import flat_shared_for
    sh = flat_shared_from_numpy(flat_shared_for(cfg_j, data_j, jnp.float64),
                                dtype=torch.float64, device="cpu")
    iv_x, iv_r, iv_l = _ridge_init_values(frequencies, Zb, b, zs, spec.K,
                                          None, torch.float64, "cpu")
    gen = torch.Generator().manual_seed(0)
    q = ravel(cfg, init_unconstrained(
        cfg, data, gen, batch_shape=(b, chains),
        init_values={"x_0": iv_x[:, None], "Rinf_raw": iv_r[:, None],
                     "induc_raw": iv_l[:, None]})).reshape(b * chains, -1)
    tgt = torch.as_tensor(targets)

    def vg(qq):
        return flat_value_and_grad(spec, sh.A, sh.L, sh.vecs, sh.scal, qq,
                                   tgt)

    _, unravel = ravel_pytree(jax.tree.map(
        jnp.asarray, {k: v[0, 0].numpy() for k, v in init_unconstrained(
            cfg, data, gen, batch_shape=(1, 1)).items()}))

    def lp_j(qq, tg):
        return log_density(cfg_j, data_j._replace(target=tg), unravel(qq))

    return vg, q, tgt, lp_j


@pytest.mark.parametrize("max_depth", [3, 4, 5, 6])
def test_transition_replays_jax_noise(drt_rows, max_depth):
    """One draw of every row with the random numbers of JAX's key
    schedule: identical trees, and q, logp and grad within rtol 1e-9 of
    JAX's nuts_transition_flat(tree_scan=True)."""
    vg, q, tgt, lp_j = drt_rows
    R, D = q.shape
    rng = np.random.default_rng(max_depth)
    eps = np.exp(rng.uniform(-7.0, -3.0, R))
    m_inv = np.exp(rng.uniform(-1.0, 1.0, (R, D)))
    keys = jax.random.split(jax.random.PRNGKey(10 + max_depth), R)

    def one(qq, tg, k, e, m):
        vg_j = jax.value_and_grad(lambda x: lp_j(x, tg))
        lp0, g0 = vg_j(qq)
        return jax_nuts.nuts_transition_flat(vg_j, qq, lp0, g0, k, e, m,
                                             max_depth=max_depth,
                                             tree_scan=True)

    want = jax.jit(jax.vmap(one))(jnp.asarray(q.numpy()),
                                  jnp.asarray(tgt.numpy()), keys,
                                  jnp.asarray(eps), jnp.asarray(m_inv))
    lp, g = vg(q)
    got = nuts.nuts_transition_flat(vg, q, lp, g,
                                    jax_draw_noise(keys, D, max_depth),
                                    torch.as_tensor(eps),
                                    torch.as_tensor(m_inv),
                                    max_depth=max_depth, tree_scan=True)
    info, info_j = got[3], want[3]
    for k in ("n_leapfrog", "tree_depth", "diverging"):
        assert np.array_equal(getattr(info, k).numpy(),
                              np.asarray(getattr(info_j, k))), k
    for a, b, name in ((got[0], want[0], "q"), (got[1], want[1], "logp"),
                       (got[2], want[2], "grad"),
                       (info.accept_prob, info_j.accept_prob, "accept"),
                       (info.energy, info_j.energy, "energy")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max(), err_msg=name)
    # the rows took trees of more than one shape
    assert len(np.unique(info.n_leapfrog.numpy())) > 1


def _gaussian(d, seed, jitter=0.5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d))
    cov = A @ A.T + jitter * np.eye(d)
    prec = np.linalg.inv(cov)
    P = torch.as_tensor(prec)

    def vg(q):
        g = -(q @ P.T)
        return 0.5 * (q * g).sum(-1), g

    return vg, prec, cov


def test_sampler_replays_jax_noise():
    """sample_nuts with JAX's random numbers reproduces JAX's sample_nuts
    chain by chain: warmup 40 exercises the step-size search, dual
    averaging and one mass-adaptation window."""
    d, chains, warmup, samples, md = 5, 4, 40, 10, 5
    vg, prec, _ = _gaussian(d, 11)
    prec_j = jnp.asarray(prec)
    cfg_j = jax_nuts.NUTSConfig(max_depth=md, tree_scan=True)
    keys = jax.random.split(jax.random.PRNGKey(2), chains)
    q0 = np.random.default_rng(3).standard_normal((chains, d))
    draws_j, info_j = jax.vmap(lambda qq, k: jax_nuts.sample_nuts(
        lambda x: -0.5 * x @ (prec_j @ x), qq, k, warmup=warmup,
        samples=samples, cfg=cfg_j))(jnp.asarray(q0), keys)

    noise = jax_nuts_stream(keys, d, md, warmup + samples)
    draws, info = nuts.sample_nuts(
        vg, torch.as_tensor(q0), warmup, samples,
        nuts.NUTSConfig(max_depth=md, tree_scan=True),
        noise=lambda: iter(noise))
    np.testing.assert_allclose(draws.numpy(),
                               np.asarray(draws_j).transpose(1, 0, 2),
                               rtol=1e-8, atol=1e-10)
    for k in ("logp", "accept_prob", "energy"):
        np.testing.assert_allclose(info[k].numpy(),
                                   np.asarray(info_j[k]).T, rtol=1e-8,
                                   atol=1e-10, err_msg=k)
    for k in ("step_size", "inv_mass"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]),
                                   rtol=1e-8, err_msg=k)
    for k in ("diverging", "n_leapfrog", "warmup_diverging"):
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k]).T), k


@pytest.mark.parametrize("form", ["nested", "flat_tree"])
def test_tree_forms_give_identical_draws(form):
    """The early-stop form (the nested default and flat_tree) and the
    static tree_scan form give the same draws from the same generator."""
    vg, _, _ = _gaussian(10, 7)
    q0 = torch.zeros((6, 10), dtype=torch.float64)
    runs = {}
    for name, cfg in (("scan", nuts.NUTSConfig(max_depth=6, tree_scan=True)),
                      (form, nuts.NUTSConfig(max_depth=6,
                                             flat_tree=form == "flat_tree"))):
        gen = torch.Generator().manual_seed(4)
        runs[name] = nuts.sample_nuts(vg, q0, 50, 50, cfg, generator=gen)
    (d1, i1), (d2, i2) = runs["scan"], runs[form]
    assert torch.equal(d1, d2)
    for k in ("n_leapfrog", "diverging", "inv_mass", "step_size"):
        assert torch.equal(i1[k], i2[k]), k


def test_correlated_gaussian_moments():
    """NUTS recovers the mean and covariance of a correlated Gaussian
    within Monte-Carlo error (the JAX package's tests/test_nuts.py:10)."""
    d = 8
    rng = np.random.default_rng(3)
    A = rng.standard_normal((d, d))
    cov = A @ A.T + d * np.eye(d)
    mu = rng.standard_normal(d)
    P = torch.as_tensor(np.linalg.inv(cov))
    mu_t = torch.as_tensor(mu)

    def vg(q):
        g = -((q - mu_t) @ P.T)
        return 0.5 * ((q - mu_t) * g).sum(-1), g

    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((4, d), generator=gen, dtype=torch.float64)
    draws, info = nuts.sample_nuts(vg, q0, 500, 1000, generator=gen)
    draws = draws.reshape(-1, d).numpy()
    assert info["diverging"].double().mean() < 0.01
    sd = np.sqrt(np.diag(cov))
    mc_err = sd / np.sqrt(len(draws) / 10)
    assert np.all(np.abs(draws.mean(axis=0) - mu) < 5 * mc_err)
    est = np.cov(draws.T)
    np.testing.assert_allclose(np.diag(est), np.diag(cov), rtol=0.2)
    assert np.linalg.norm(est - cov) / np.linalg.norm(cov) < 0.25


def test_unported_nuts_options_raise():
    """fused_draws still raises, naming item 12; dense_mass and metric=
    (ported with the metric family) run."""
    vg, _, _ = _gaussian(3, 0)
    q0 = torch.zeros((2, 3), dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="item 12"):
        nuts.sample_nuts(vg, q0, 5, 5, nuts.NUTSConfig(fused_draws=True),
                         generator=gen)
    draws, info = nuts.sample_nuts(vg, q0, 5, 5,
                                   nuts.NUTSConfig(dense_mass=True),
                                   generator=gen)
    assert info["inv_mass"].shape == (2, 3, 3)
    assert torch.isfinite(draws).all()
    draws, info = nuts.sample_nuts(vg, q0, 5, 5, generator=gen,
                                   metric=torch.ones(3, dtype=torch.float64))
    assert info["inv_mass"].shape == (2, 3)
    assert torch.isfinite(draws).all()
