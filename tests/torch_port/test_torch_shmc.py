"""The port's generic SHMC sampler (infer/chees.py:sample_shmc) against the
JAX package's sample_shmc in float64 on the CPU: whole runs replaying the
JAX sampler's own random numbers on three posterior families, the generic
trajectory against the flat-chain kernel's plain version, the moments of
a correlated Gaussian, and fit_spectra_batch(sampler="shmc") and the
"fast" preset beyond the single series DRT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.infer import chees as jax_chees
from bayes_drt_tpu.models import build as jax_build
from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu.models.posterior import log_density as jax_log_density
from bayes_drt_tpu.ops.matrices import construct_A as jax_construct_A
from bayes_drt_tpu.ops.matrices import construct_L as jax_construct_L
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import chees
from bayes_drt_tpu_torch.infer.shmc_flat import (_traj_plain,
                                                 flat_shared_for,
                                                 flat_spec_for)
from bayes_drt_tpu_torch.models import build
from bayes_drt_tpu_torch.models.posterior import (flat_dim,
                                                  posterior_value_and_grad)
from bayes_drt_tpu_torch.ops.matrices import default_epsilon
from bayes_drt_tpu_torch.parallel import batch
from jax_noise_reference import jax_shmc_stream
from parallel_seed_reference import jax_parallel_ridge_seed

torch.set_num_threads(1)

FREQ = np.logspace(3, -1, 16)
BASIS = np.logspace(3.2, -1.2, 11)
DRT = {"kernel": "DRT", "dist_type": "series"}
TP = {"kernel": "DDT", "symmetry": "planar", "bc": "transmissive",
      "dist_type": "parallel", "x_scale": 0.8}
FAMILIES = {
    "Series": ({"DRT": DRT}, {}),
    "Series_outliers": ({"DRT": DRT}, {"outliers": True}),
    "Series-Parallel": ({"DRT": DRT, "TP-DDT": TP}, {}),
}
B, CHAINS, WARMUP, SAMPLES = 2, 2, 24, 4
# shrunk windows: two mass-adaptation window ends inside 24 warmup draws
WINDOWS = dict(init_buffer=4, term_buffer=4, base_window=4)


def _posteriors(family):
    """JAX and port posteriors of ``family`` on FREQ / BASIS (float64,
    sample mode, ncp) and B noisy replicas' scaled targets (B, 2N)."""
    dists, opts = FAMILIES[family]
    tau = 1.0 / (2 * np.pi * BASIS)
    eps = default_epsilon(tau)
    mats = {}
    for name, info in dists.items():
        kw = dict(tau=tau, epsilon=eps, kernel=info["kernel"],
                  dist_type=info["dist_type"],
                  symmetry=info.get("symmetry", "planar"),
                  bc=info.get("bc", "transmissive"), dtype=jnp.float64)
        mats[name] = {f"A_{p[:2]}": np.asarray(jax_construct_A(FREQ, p, **kw))
                      for p in ("real", "imag")}
        for o in (0, 1, 2):
            mats[name][f"L{o}"] = np.asarray(jax_construct_L(
                BASIS, tau=tau, epsilon=eps, order=o, dtype=jnp.float64))
    z = (sim.series_parallel_circuit(FREQ) if len(dists) > 1
         else sim.reference_circuit("ZARC", FREQ))
    zb = sim.noisy_replicas(z, B, 0.003, seed=4)
    zb = zb / np.std(np.abs(zb), axis=1, keepdims=True)
    kw = dict(mode="sample", nonneg=True, ncp=True, **opts)
    cfg_j, data_j = jax_build.build_posterior(dists, mats, FREQ, zb[0],
                                              dtype=jnp.float64, **kw)
    cfg, data = build.build_posterior(dists, mats, FREQ, zb[0],
                                      dtype=torch.float64, device="cpu", **kw)
    return cfg_j, data_j, cfg, data, np.concatenate([zb.real, zb.imag], 1)


# (family, recompute_grad, eps_quantile, warm): every family, both
# recompute arms and all three pooling rules, each value at least twice;
# ``warm`` starts from a given per-spectrum metric and step size (the
# arguments a warm start passes)
CASES = [("Series", False, 0.0, False), ("Series", True, -1.0, True),
         ("Series_outliers", True, 0.5, False),
         ("Series_outliers", False, -1.0, False),
         ("Series-Parallel", True, 0.0, False),
         ("Series-Parallel", False, 0.5, True)]


@pytest.mark.parametrize("family,recompute,eps_q,warm", CASES)
def test_sample_shmc_replays_jax(family, recompute, eps_q, warm):
    """Same posterior, starts and random numbers: the port's sample_shmc
    over (B*C, D) rows reproduces JAX's sample_shmc vmapped over spectra
    (draws, logp, accept, energy, step size, metric; rtol 1e-9)."""
    cfg_j, data_j, cfg, data, targets = _posteriors(family)
    key0 = jax.random.PRNGKey(11)
    p0 = jax_init(cfg_j, data_j, key0)
    _, unravel_j = ravel_pytree(p0)
    q0 = np.stack([np.asarray(ravel_pytree(jax_init(
        cfg_j, data_j, jax.random.fold_in(key0, i)))[0])
        for i in range(B * CHAINS)]).reshape(B, CHAINS, -1)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), i)
                      for i in range(B)])
    cfg_sj = jax_chees.SHMCConfig(n_steps=3, warm_steps=2, **WINDOWS,
                                  recompute_grad=recompute,
                                  eps_quantile=eps_q)

    dim = flat_dim(cfg, len(FREQ))
    assert dim == q0.shape[-1]
    rng = np.random.default_rng(2)
    metric = rng.uniform(0.5, 2.0, (B, dim)) if warm else np.ones((B, dim))
    eps_init = rng.uniform(0.01, 0.1, B) if warm else np.ones(B)

    def run(target, q0b, key, m, e):
        def logp(q):
            return jax_log_density(cfg_j, data_j._replace(target=target),
                                   unravel_j(q), jacobian=True)
        return jax_chees.sample_shmc(logp, q0b, key, warmup=WARMUP,
                                     samples=SAMPLES, cfg=cfg_sj,
                                     init_step_size=e, metric=m)

    draws_j, info_j = jax.jit(jax.vmap(run))(
        jnp.asarray(targets), jnp.asarray(q0), keys, jnp.asarray(metric),
        jnp.asarray(eps_init))
    noise = jax_shmc_stream(keys, dim, CHAINS,
                            [2] * WARMUP + [3] * SAMPLES)
    vg = posterior_value_and_grad(cfg, data, torch.as_tensor(
        np.repeat(targets, CHAINS, axis=0)))
    cfg_s = chees.SHMCConfig(n_steps=3, warm_steps=2, **WINDOWS,
                             recompute_grad=recompute, eps_quantile=eps_q)
    warm_kw = (dict(metric=torch.as_tensor(metric),
                    init_step_size=torch.as_tensor(eps_init)) if warm
               else {})
    draws, info = chees.sample_shmc(
        vg, torch.as_tensor(q0.reshape(B * CHAINS, -1)), WARMUP, SAMPLES,
        cfg_s, CHAINS, noise=lambda: iter(noise), **warm_kw)
    np.testing.assert_allclose(draws.numpy(), np.asarray(draws_j),
                               rtol=1e-9, atol=1e-9)
    for k in ("logp", "accept_prob", "energy", "step_size", "inv_mass"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    for k in ("diverging", "warmup_diverging", "n_leapfrog"):
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k])), k
    # the adaptation moved the metric off the identity
    assert not np.allclose(info["inv_mass"].numpy(), 1.0)


@pytest.mark.parametrize("j", [0, 2, 5])
def test_generic_trajectory_matches_flat_plain(j):
    """On the single series DRT, the generic trajectory over the autograd
    value and gradient equals the trajectory kernel's plain version (the
    generic trajectory on the hand-written gradient) in float64, with and
    without recompute_grad."""
    _, _, cfg, data, targets = _posteriors("Series")
    spec = flat_spec_for(cfg, data)
    shared = flat_shared_for(cfg, data, torch.float64)
    R, n_leap = 6, 5
    rng = np.random.default_rng(j)
    tg = torch.as_tensor(np.repeat(targets, 3, axis=0))
    q = torch.as_tensor(rng.uniform(-1.0, 1.0, (R, spec.D)))
    vg = posterior_value_and_grad(cfg, data, tg)
    lp, g = vg(q)
    args = (q, torch.as_tensor(rng.standard_normal((R, spec.D))), g, lp,
            torch.as_tensor(rng.uniform(0.005, 0.02, R)),
            torch.as_tensor(rng.uniform(0.5, 2.0, (R, spec.D))))
    u_sel = torch.as_tensor(rng.uniform(size=(n_leap, R)))
    want = _traj_plain(spec, n_leap, 1000.0, shared, *args, tg, j, u_sel)
    for rc in (False, True):
        got = chees.shmc_trajectory(vg, n_leap, 1000.0, *args,
                                    torch.tensor(j), u_sel,
                                    recompute_grad=rc)
        for a, b, name in zip(got, want, ("q", "logp", "grad", "kin",
                                          "sacc", "div")):
            np.testing.assert_allclose(a.double().numpy(),
                                       b.double().numpy(), rtol=1e-9,
                                       atol=1e-9, err_msg=f"{name} rc={rc}")


def _gaussian_target():
    """JAX test_round3's correlated Gaussian."""
    d = 5
    rng = np.random.default_rng(0)
    a = rng.standard_normal((d, d))
    cov = a @ a.T / d + 0.5 * np.eye(d)
    return cov, np.linalg.inv(cov)


def test_sample_shmc_moments_correlated_gaussian():
    """The port's sample_shmc samples the JAX package's correlated
    Gaussian target (test_round3.py:72's checks: mean, covariance,
    divergences, static trajectory length)."""
    cov, prec = _gaussian_target()
    d = cov.shape[0]
    P = torch.as_tensor(prec)

    def vg(q):
        g = -q @ P
        return 0.5 * torch.sum(q * g, dim=1), g

    gen = torch.Generator().manual_seed(1)
    q0 = torch.randn((4, d), generator=gen, dtype=torch.float64)
    draws, info = chees.sample_shmc(vg, q0, 400, 400,
                                    chees.SHMCConfig(n_steps=16), 4,
                                    generator=gen)
    flat = draws.reshape(-1, d).numpy()
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    emp = np.cov(flat.T)
    assert np.max(np.abs(emp - cov) / (np.abs(cov) + 0.2)) < 0.5
    assert float(info["diverging"].double().mean()) < 0.01
    assert (info["n_leapfrog"] == 16).all()


def test_shmc_config_fields_and_raises():
    """The JAX package's fields construct the port's config (the ragged
    bench's call); the arms the port does not have raise."""
    cfg = chees.SHMCConfig(n_steps=32, warm_steps=32, leaf_unroll=2,
                           draw_unroll=2, recompute_grad=True,
                           eps_quantile=0.5, traj_block=128)
    cfg.validate()
    assert chees.SHMCConfig._fields == jax_chees.SHMCConfig._fields
    assert chees.SHMCConfig() == tuple(jax_chees.SHMCConfig())
    with pytest.raises(NotImplementedError, match="item 12"):
        chees.SHMCConfig(traj_store=True).validate()
    # the TPU's RngBitGenerator stream is dropped: the port draws Philox
    with pytest.raises(NotImplementedError,
                       match="dropped.*RngBitGenerator.*Philox"):
        chees.SHMCConfig(rng_impl="rbg").validate()
    fast = batch.QUALITY_PRESETS["fast"]["shmc_cfg"]
    assert fast.recompute_grad is True
    from bayes_drt_tpu.parallel.batch import QUALITY_PRESETS as JQ
    assert fast._replace(precision="high") == tuple(JQ["fast"]["shmc_cfg"])


def _sp_batch(b=2, seed=3):
    freq = np.logspace(3, -1, 16)
    z = sim.series_parallel_circuit(freq)
    return freq, sim.noisy_replicas(z, b, 0.003, seed)


SP = {"DRT": dict(DRT, basis_freq=BASIS),
      "TP-DDT": dict(TP, basis_freq=BASIS)}
TINY = dict(chains=2, warmup=20, samples=8, ncp=True, nonneg=True,
            device="cpu")


def test_fit_spectra_batch_shmc_series_parallel():
    """sampler="shmc" on Series-Parallel runs the generic sampler: shapes,
    finite values, ordered bands, escalation on by default (a forced
    flag refits with NUTS, unseeded for two distributions)."""
    freq, zb = _sp_batch()
    cfg = chees.SHMCConfig(n_steps=4, warm_steps=4, eps_quantile=0.5,
                           recompute_grad=True)
    res = batch.fit_spectra_batch(freq, zb, distributions=SP,
                                  sampler="shmc", shmc_cfg=cfg, timing=True,
                                  escalate_gate=dict(ess_bulk_min=0.0),
                                  **TINY)
    d = res.diagnostics
    assert res.coef.shape == (2, len(BASIS))
    assert d["coef_1"].shape == (2, len(BASIS))
    assert np.isfinite(res.coef).all() and np.isfinite(d["coef_1"]).all()
    assert (res.gamma_lo <= res.gamma_hi).all()
    assert "escalated" in d and not d["escalated"].any()
    assert d["state_inv_mass"].shape == (2, 2, 4 * len(BASIS) + 12)
    assert len(d["draw_s"]) == 28 and "capture_s" in d
    forced = batch.fit_spectra_batch(
        freq, zb, distributions=SP, sampler="shmc", shmc_cfg=cfg,
        escalate_gate=dict(ess_bulk_min=np.inf),
        escalate_kw=dict(max_tree_depth=3), **TINY)
    assert forced.diagnostics["escalated"].all()
    assert np.isfinite(forced.coef).all()


def test_fast_preset_reaches_generic_sampler(monkeypatch):
    """quality="fast" on the outlier model and on Series-Parallel hands the
    preset's configuration to the generic sampler (the budget is the
    preset's, so the call stops at the sampler)."""
    seen = []

    class Reached(Exception):
        pass

    def stop(vg, q0, warmup, samples, cfg, chains, **kw):
        seen.append((warmup, samples, cfg, chains, q0.shape))
        raise Reached

    monkeypatch.setattr(batch, "sample_shmc", stop)
    freq, zb = _sp_batch(1)
    for kw in (dict(outliers=True), dict(distributions=SP, nonneg=True)):
        with pytest.raises(Reached):
            batch.fit_spectra_batch(freq, zb, quality="fast", device="cpu",
                                    **kw)
    for warmup, samples, cfg, chains, shape in seen:
        assert (warmup, samples, chains) == (150, 250, 4)
        assert cfg == batch.QUALITY_PRESETS["fast"]["shmc_cfg"]
    assert seen[0][4][0] == 8 * 4     # the batch padded to 8 spectra


def test_shmc_raises(monkeypatch):
    """pallas_traj / flat_chain name the single series family on any other
    model (JAX's flat_spec_for ValueError); a single parallel distribution
    runs the default escalation, its NUTS refit seeded by the Inverter's
    admittance ridge (held to the JAX package's seed at 1e-8), and runs
    with escalate=False."""
    freq, zb = _sp_batch(1)
    for kw in (dict(pallas_traj=True), dict(flat_chain=True)):
        with pytest.raises(ValueError, match="single series"):
            batch.fit_spectra_batch(freq, zb, distributions=SP,
                                    sampler="shmc",
                                    shmc_cfg=chees.SHMCConfig(**kw), **TINY)
    ddt = {"DDT": dict(TP, basis_freq=BASIS)}
    seeds = []
    seed_fn = batch._ridge_seed

    def spy(*args):
        seeds.append(seed_fn(*args))
        return seeds[-1]

    monkeypatch.setattr(batch, "_ridge_seed", spy)
    res = batch.fit_spectra_batch(
        freq, zb, distributions=ddt, sampler="shmc",
        escalate_gate=dict(ess_bulk_min=np.inf),
        escalate_kw=dict(max_tree_depth=3), dtype=torch.float64,
        shmc_cfg=chees.SHMCConfig(n_steps=3, warm_steps=3), **TINY)
    assert res.diagnostics["escalated"].all()
    assert np.isfinite(res.coef).all()
    want = jax_parallel_ridge_seed(freq, zb, ddt)
    for k, v in want.items():
        got = seeds[0][k][:len(zb)]
        np.testing.assert_allclose(got, v, rtol=1e-8,
                                   atol=1e-8 * np.abs(v).max(), err_msg=k)
    res = batch.fit_spectra_batch(
        freq, zb, distributions=ddt, sampler="shmc", escalate=False,
        shmc_cfg=chees.SHMCConfig(n_steps=3, warm_steps=3), **TINY)
    assert np.isfinite(res.coef).all()