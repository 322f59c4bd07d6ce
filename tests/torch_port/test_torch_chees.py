"""The port's ChEES-HMC sampler (infer/chees.py:sample_chees) against the
JAX package's sample_chees in float64 on the CPU: the configuration and
Adam helpers, whole runs replaying the JAX sampler's own random numbers
on a correlated Gaussian and on the tiny DRT posterior, the JAX package's
Gaussian bars (tests/test_round3.py:55-69), and the batch and ragged
routes, cold and warm, beside the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.infer import chees as jax_chees
from bayes_drt_tpu.infer.diagnostics import ess
from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu.models.posterior import log_density as jax_log_density
from bayes_drt_tpu.parallel import fit_spectra_batch as jax_fit
from bayes_drt_tpu.parallel import fit_spectra_ragged as jax_ragged
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import chees
from bayes_drt_tpu_torch.models.posterior import (flat_dim,
                                                  posterior_value_and_grad)
from bayes_drt_tpu_torch.parallel import batch
from jax_noise_reference import jax_chees_stream
from test_torch_shmc import FREQ, _posteriors

torch.set_num_threads(1)

# shrunk windows (two mass-adaptation window ends inside 24 warmup
# draws) and leapfrog counts (the leaf uniforms are drawn to max_steps)
SMALL = dict(max_steps=12, min_steps=3, init_buffer=4, term_buffer=4,
             base_window=4)
WARMUP, SAMPLES = 24, 8
INFO_KEYS = ("logp", "accept_prob", "energy", "step_size", "inv_mass",
             "traj_time", "warmup_accept", "warmup_step_size",
             "warmup_traj_time")
INT_KEYS = ("diverging", "n_leapfrog", "warmup_diverging",
            "warmup_n_leapfrog")


def test_chees_config_and_adam_match_jax():
    """ChEESConfig's fields and defaults are the JAX package's; the Adam
    helpers agree elementwise over a run of gradients."""
    assert chees.ChEESConfig._fields == jax_chees.ChEESConfig._fields
    assert chees.ChEESConfig() == tuple(jax_chees.ChEESConfig())
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((6, 5)) * np.array([1e-3, 1, 10, 1e3, 0])
    st = chees._adam_init(5, torch.float64)
    assert all(float(a.abs().max()) == 0.0 for a in st)
    for g in grads:
        want, step_j = jax.vmap(
            lambda m, v, t, gg: jax_chees._adam_update(
                jax_chees._AdamState(m, v, t), gg, 0.025))(
            *(jnp.asarray(a.numpy()) for a in st), jnp.asarray(g))
        st, step = chees._adam_update(st, torch.as_tensor(g), 0.025)
        np.testing.assert_allclose(step.numpy(), np.asarray(step_j),
                                   rtol=1e-14, atol=1e-300)
        for a, b in zip(st, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


def _gaussian(d, seed):
    """test_round3's correlated Gaussian: (cov, JAX logp, port value and
    gradient)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d))
    cov = a @ a.T / d + np.eye(d) * 0.1
    prec = np.linalg.inv(cov)
    pj, pt = jnp.asarray(prec), torch.as_tensor(prec)

    def vg(q):
        g = -q @ pt
        return 0.5 * torch.sum(q * g, dim=1), g

    return cov, (lambda q: -0.5 * q @ pj @ q), vg


def _compare(draws, info, draws_j, info_j, tol=1e-10):
    np.testing.assert_allclose(draws.numpy(), np.asarray(draws_j), rtol=tol,
                               atol=tol)
    for k in INFO_KEYS:
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    for k in INT_KEYS:
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k])), k


@pytest.mark.parametrize("warm", [False, True])
def test_sample_chees_replays_jax_gaussian(warm):
    """Two spectra of a correlated Gaussian (D=5, 4 chains each) from the
    same starts and random numbers: the port's sample_chees over (8, 5)
    rows reproduces JAX's sample_chees vmapped over spectra (draws, logp,
    traj_time, step_size, inv_mass and the warmup traces at 1e-10; the
    leapfrog counts and divergences exactly). ``warm`` starts from a
    given metric, step size and trajectory time with the metric held (a
    warm start's arguments)."""
    b, c, d = 2, 4, 5
    _, logp_j, vg = _gaussian(d, 0)
    rng = np.random.default_rng(1)
    q0 = rng.normal(size=(b, c, d))
    keys = jnp.stack([jax.random.PRNGKey(3 + i) for i in range(b)])
    cfg_kw = dict(SMALL, adapt_mass=not warm)
    extra = (dict(metric=rng.uniform(0.5, 2.0, (b, d)),
                  init_step_size=rng.uniform(0.2, 0.6, b),
                  init_traj_time=rng.uniform(1.0, 3.0, b)) if warm else {})

    def run(q0b, key, *args):
        kw = dict(zip(extra, args))
        return jax_chees.sample_chees(logp_j, q0b, key, warmup=WARMUP,
                                      samples=SAMPLES,
                                      cfg=jax_chees.ChEESConfig(**cfg_kw),
                                      **kw)

    draws_j, info_j = jax.jit(jax.vmap(run))(
        jnp.asarray(q0), keys, *(jnp.asarray(v) for v in extra.values()))
    noise = jax_chees_stream(keys, d, c, SMALL["max_steps"],
                             WARMUP + SAMPLES)
    draws, info = chees.sample_chees(
        vg, torch.as_tensor(q0.reshape(b * c, d)), WARMUP, SAMPLES,
        chees.ChEESConfig(**cfg_kw), c, noise=lambda: iter(noise),
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    _compare(draws, info, draws_j, info_j)
    assert len(info["leaf_max"]) == WARMUP + SAMPLES
    assert (np.asarray(info["leaf_max"])
            == info_j["warmup_n_leapfrog"].max(axis=(0, 1)).tolist()
            + np.asarray(info_j["n_leapfrog"]).max(axis=(0, 1)).tolist()
            ).all()
    # the trajectory time moved off its start and the leapfrog counts
    # vary over chains
    assert not np.allclose(np.asarray(info_j["warmup_traj_time"])[:, -1],
                           np.asarray(info_j["warmup_traj_time"])[:, 0])
    if not warm:
        assert not np.allclose(info["inv_mass"].numpy(), 1.0)


def test_sample_chees_replays_jax_drt():
    """The tiny DRT posterior (two spectra, two chains, ncp): the port's
    sample_chees over the autograd value and gradient reproduces JAX's
    sample_chees vmapped over spectra at 1e-10."""
    cfg_j, data_j, cfg, data, targets = _posteriors("Series")
    b, c = 2, 2
    key0 = jax.random.PRNGKey(11)
    _, unravel_j = ravel_pytree(jax_init(cfg_j, data_j, key0))
    q0 = np.stack([np.asarray(ravel_pytree(jax_init(
        cfg_j, data_j, jax.random.fold_in(key0, i)))[0])
        for i in range(b * c)]).reshape(b, c, -1)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), i)
                      for i in range(b)])
    cfg_c = dict(SMALL, max_steps=16)

    def run(target, q0b, key):
        def logp(q):
            return jax_log_density(cfg_j, data_j._replace(target=target),
                                   unravel_j(q), jacobian=True)
        return jax_chees.sample_chees(logp, q0b, key, warmup=WARMUP,
                                      samples=SAMPLES,
                                      cfg=jax_chees.ChEESConfig(**cfg_c))

    draws_j, info_j = jax.jit(jax.vmap(run))(jnp.asarray(targets),
                                             jnp.asarray(q0), keys)
    dim = flat_dim(cfg, len(FREQ))
    noise = jax_chees_stream(keys, dim, c, cfg_c["max_steps"],
                             WARMUP + SAMPLES)
    vg = posterior_value_and_grad(cfg, data, torch.as_tensor(
        np.repeat(targets, c, axis=0)))
    draws, info = chees.sample_chees(
        vg, torch.as_tensor(q0.reshape(b * c, dim)), WARMUP, SAMPLES,
        chees.ChEESConfig(**cfg_c), c, noise=lambda: iter(noise))
    _compare(draws, info, draws_j, info_j)
    assert not np.allclose(info["inv_mass"].numpy(), 1.0)


def test_sample_chees_correlated_gaussian_bars():
    """The port reaches the JAX package's bars on its correlated Gaussian
    (tests/test_round3.py:55-69): mean, covariance, divergences, a
    finite trajectory time and min ESS > 100, at 4 x (400 + 400)."""
    cov, _, vg = _gaussian(8, 0)
    d = cov.shape[0]
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((4, d), generator=gen, dtype=torch.float64)
    draws, info = chees.sample_chees(vg, q0, 400, 400, chees.ChEESConfig(),
                                     4, generator=gen)
    flat = draws.reshape(-1, d).numpy()
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    emp = np.cov(flat.T)
    assert np.max(np.abs(emp - cov) / (np.abs(cov) + 0.2)) < 0.5
    assert float(info["diverging"].double().mean()) < 0.01
    assert np.isfinite(float(info["traj_time"][0]))
    assert float(ess(draws[0].numpy()).min()) > 100


def _batch(b=3, seed=5):
    freq = np.logspace(5, -1, 31)
    return sim.make_benchmark_batch(b, freq=freq, seed=seed)


BATCH_KW = dict(chains=2, warmup=40, samples=30, ncp=True, sampler="chees",
                chees_cfg=None)
SMALL_CFG = dict(max_steps=24, min_steps=4)
KEYS = ("min_ess", "ess_logp", "gamma_eval_mean", "gamma_eval_lo",
        "gamma_eval_hi", "state_q", "state_inv_mass", "state_step_size",
        "state_traj_time")


def _check_keys(res, b, chains, dim):
    d = res.diagnostics
    assert np.isfinite(res.coef).all()
    for k in KEYS:
        assert k in d, k
    assert (d["gamma_eval_lo"] <= d["gamma_eval_hi"] + 1e-12).all()
    assert (d["min_ess"] > 0).all()
    assert np.shape(d["state_traj_time"]) == (b,)
    assert np.shape(d["state_q"]) == (b, chains, dim)
    assert np.isfinite(d["state_traj_time"]).all()


def test_fit_spectra_batch_chees_cold_and_warm():
    """fit_spectra_batch(sampler='chees') in both packages on sim spectra:
    the JAX test's keys (tests/test_round3.py:161-178) with
    state_traj_time (B,), the same result shapes, finite coefficients;
    escalation off. A warm start on spectra scaled by 1.03 from the
    port's own result and from the JAX package's (its (B, C, D) state
    crossing into the port's flat rows) resumes with the trajectory time
    carried. The missing-state_traj_time and pooled-preconditioner
    ValueErrors."""
    freq, Zb = _batch()
    tau = np.logspace(-6, 1, 15)
    kw = dict(BATCH_KW, chees_cfg=chees.ChEESConfig(**SMALL_CFG),
              gamma_eval_tau=tau)
    got = batch.fit_spectra_batch(freq, Zb, device="cpu",
                                  dtype=torch.float64, **kw)
    want = jax_fit(freq, Zb, **dict(kw, chees_cfg=jax_chees.ChEESConfig(
        **SMALL_CFG)))
    dim = got.diagnostics["state_q"].shape[-1]
    for res in (got, want):
        _check_keys(res, 3, 2, dim)
    assert "escalated" not in got.diagnostics
    for k, v in want.diagnostics.items():
        if k in ("state_cfg",):
            continue
        assert k in got.diagnostics, k
        assert np.shape(got.diagnostics[k]) == np.shape(v), k
    gt = sim.reference_gamma("ZARC", got.tau)
    rp = np.trapezoid(gt, np.log(got.tau))
    for res in (got, want):
        rmse = np.sqrt(np.mean((batch.evaluate_gamma(res, res.tau)
                                - gt) ** 2, axis=1)) / rp
        assert rmse.max() < 0.2, rmse
    for src in (got, want):
        res = batch.fit_spectra_batch(freq, 1.03 * Zb, device="cpu",
                                      dtype=torch.float64, warm_start=src,
                                      **dict(kw, warmup=10))
        _check_keys(res, 3, 2, dim)
        # the metric was held: every chain carries its spectrum's mean
        np.testing.assert_allclose(
            res.diagnostics["state_inv_mass"],
            np.broadcast_to(np.asarray(src.diagnostics["state_inv_mass"])
                            .mean(axis=1, keepdims=True), (3, 2, dim)),
            rtol=1e-12)
    no_tt = dict(got.diagnostics)
    del no_tt["state_traj_time"]
    with pytest.raises(ValueError, match="state_traj_time"):
        batch.fit_spectra_batch(freq, Zb, device="cpu", **kw,
                                warm_start=got._replace(diagnostics=no_tt))
    with pytest.raises(ValueError, match="builds a dense metric"):
        batch.fit_spectra_batch(freq, Zb, device="cpu", **kw,
                                precondition="pooled")


def test_fit_spectra_batch_mesh_and_chees_cfg_keywords():
    """fit_spectra_batch takes the JAX signature's mesh= and chees_cfg=
    keywords: mesh=None and a ChEESConfig are accepted in both packages
    (here beside the default sampler, which ignores chees_cfg), and a
    two-device mesh (ported with the device mesh) runs ChEES in both,
    with the same layout and shapes."""
    freq, Zb = _batch(2)
    kw = dict(chains=2, warmup=20, samples=10, max_tree_depth=4,
              escalate=False, mesh=None)
    got = batch.fit_spectra_batch(freq, Zb, device="cpu",
                                  chees_cfg=chees.ChEESConfig(), **kw)
    want = jax_fit(freq, Zb, chees_cfg=jax_chees.ChEESConfig(), **kw)
    assert got.coef.shape == want.coef.shape
    assert np.isfinite(got.coef).all()
    from bayes_drt_tpu.parallel import make_mesh as jax_make_mesh
    from bayes_drt_tpu_torch.parallel import make_mesh
    ck = dict(chains=2, warmup=20, samples=10, sampler="chees", ncp=True)
    got = batch.fit_spectra_batch(
        freq, Zb, device="cpu", mesh=make_mesh(2, device="cpu"),
        chees_cfg=chees.ChEESConfig(**SMALL_CFG), **ck)
    want = jax_fit(freq, Zb, mesh=jax_make_mesh(2),
                   chees_cfg=jax_chees.ChEESConfig(**SMALL_CFG), **ck)
    assert got.diagnostics["shard_layout"] == want.diagnostics["shard_layout"]
    for k, v in want.diagnostics.items():
        if k != "state_cfg":
            assert np.shape(got.diagnostics[k]) == np.shape(v), k
    assert np.isfinite(got.coef).all()


def test_fit_spectra_ragged_chees_cold_and_warm():
    """fit_spectra_ragged(sampler='chees') in both packages on a small
    ragged fleet, cold and warm (the JAX package's ragged ChEES routes,
    parallel/batch.py:1612-1699): the same diagnostics and shapes,
    state_traj_time (B,), finite coefficients."""
    fleet = [(f[::4], z[::4]) for f, z in sim.make_ragged_fleet(3)]
    kw = dict(chains=2, warmup=30, samples=20, ncp=True, sampler="chees")
    got = batch.fit_spectra_ragged(fleet, device="cpu", dtype=torch.float64,
                                   chees_cfg=chees.ChEESConfig(**SMALL_CFG),
                                   **kw)
    want = jax_ragged(fleet, chees_cfg=jax_chees.ChEESConfig(**SMALL_CFG),
                      **kw)
    d = got.diagnostics
    for k, v in want.diagnostics.items():
        if k != "state_cfg":
            assert k in d, k
            assert np.shape(d[k]) == np.shape(v), k
    assert np.shape(d["state_traj_time"]) == (3,)
    assert np.isfinite(got.coef).all()
    for src in (got, want):
        res = batch.fit_spectra_ragged(
            [(f, 1.03 * z) for f, z in fleet], device="cpu",
            dtype=torch.float64, warm_start=src,
            chees_cfg=chees.ChEESConfig(**SMALL_CFG), **dict(kw, warmup=10))
        assert np.isfinite(res.coef).all()
        assert np.isfinite(res.diagnostics["state_traj_time"]).all()
    no_tt = dict(d)
    del no_tt["state_traj_time"]
    with pytest.raises(ValueError, match="state_traj_time"):
        batch.fit_spectra_ragged(fleet, device="cpu", **kw,
                                 warm_start=got._replace(diagnostics=no_tt))
