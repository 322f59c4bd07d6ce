"""The port's dense NUTS metrics against the JAX package (float64 on the
CPU): one transition with a shared and a per-row dense metric given the
JAX key schedule's normals, the dense Welford accumulator, whole dense
adaptation runs replayed draw for draw, and the JAX package's dense and
fixed-metric Gaussian tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer import nuts as jax_nuts
from bayes_drt_tpu_torch.infer import nuts
from jax_noise_reference import jax_draw_noise, jax_nuts_stream

torch.set_num_threads(1)


def _gaussian(d, seed, jitter):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d))
    cov = A @ A.T + jitter * np.eye(d)
    prec = np.linalg.inv(cov)
    P = torch.as_tensor(prec)

    def vg(q):
        g = -(q @ P.T)
        return 0.5 * (q * g).sum(-1), g

    return vg, prec, cov


def _spd(rng, d, rows=None):
    shape = (d, d) if rows is None else (rows, d, d)
    a = rng.standard_normal(shape)
    return a @ np.swapaxes(a, -1, -2) / d + 0.5 * np.eye(d)


@pytest.mark.parametrize("form", ["dense", "dense_rows"])
@pytest.mark.parametrize("max_depth", [3, 5])
def test_dense_transition_matches_jax(form, max_depth):
    """One draw of every row with a dense metric (one shared, or one per
    row) and the momenta of JAX's key schedule through the triangular
    solve: identical trees, q, logp and grad within 1e-10 of JAX's
    nuts_transition_flat(mass_chol=...)."""
    d, R = 7, 6
    vg, prec, _ = _gaussian(d, 3, 0.3)
    prec_j = jnp.asarray(prec)
    rng = np.random.default_rng(max_depth)
    q = rng.standard_normal((R, d))
    eps = np.exp(rng.uniform(-2.5, -1.0, R))
    m = _spd(rng, d) if form == "dense" else _spd(rng, d, R)
    chol = np.linalg.cholesky(m)
    keys = jax.random.split(jax.random.PRNGKey(20 + max_depth), R)

    def one(qq, k, e, mm, cc):
        vg_j = jax.value_and_grad(lambda x: -0.5 * x @ (prec_j @ x))
        lp0, g0 = vg_j(qq)
        return jax_nuts.nuts_transition_flat(
            vg_j, qq, lp0, g0, k, e, mm, max_depth=max_depth,
            mass_chol=cc, tree_scan=True)

    axes = (0, 0, 0, None, None) if form == "dense" else (0, 0, 0, 0, 0)
    want = jax.jit(jax.vmap(one, in_axes=axes))(
        jnp.asarray(q), keys, jnp.asarray(eps), jnp.asarray(m),
        jnp.asarray(chol))
    qt = torch.as_tensor(q)
    lp, g = vg(qt)
    m_t, c_t = torch.as_tensor(m), torch.as_tensor(chol)
    if form == "dense":
        m_t, c_t = m_t[None], c_t[None]
    assert nuts.metric_form(m_t) == form
    got = nuts.nuts_transition_flat(vg, qt, lp, g,
                                    jax_draw_noise(keys, d, max_depth),
                                    torch.as_tensor(eps), m_t,
                                    max_depth=max_depth, tree_scan=True,
                                    mass_chol=c_t)
    info, info_j = got[3], want[3]
    for k in ("n_leapfrog", "tree_depth", "diverging"):
        assert np.array_equal(getattr(info, k).numpy(),
                              np.asarray(getattr(info_j, k))), k
    for a, b, name in ((got[0], want[0], "q"), (got[1], want[1], "logp"),
                       (got[2], want[2], "grad"),
                       (info.accept_prob, info_j.accept_prob, "accept"),
                       (info.energy, info_j.energy, "energy")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


def test_dense_momentum_and_velocity_forms_agree():
    """The three metric forms agree where they describe one metric: a
    shared dense metric, the same matrix on every row, and (for a
    diagonal matrix) the diagonal form give the same velocities, kinetic
    energies and, from one set of normals, momenta with covariance M."""
    d, R = 5, 4
    rng = np.random.default_rng(0)
    m = torch.as_tensor(_spd(rng, d))
    chol = torch.linalg.cholesky(m)
    p = torch.as_tensor(rng.standard_normal((R, d)))
    z = torch.as_tensor(rng.standard_normal((R, d)))
    rows = m.expand(R, d, d).contiguous()
    crow = chol.expand(R, d, d).contiguous()
    torch.testing.assert_close(nuts._vel(p, m[None]), nuts._vel(p, rows),
                               rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(nuts._vel(p, m[None]), p @ m, rtol=1e-14,
                               atol=1e-14)
    torch.testing.assert_close(nuts._kinetic(p, m[None]),
                               nuts._kinetic(p, rows), rtol=1e-14, atol=0)
    p0 = nuts._sample_momentum(z, m[None], chol[None])
    torch.testing.assert_close(p0, nuts._sample_momentum(z, rows, crow),
                               rtol=1e-13, atol=1e-13)
    # p = L^-T z: L^T p recovers z, so cov(p) = (L L^T)^-1 = M
    torch.testing.assert_close(p0 @ chol, z, rtol=1e-12, atol=1e-12)
    diag = torch.as_tensor(rng.uniform(0.5, 2.0, d))
    dm = torch.diag(diag)[None]
    torch.testing.assert_close(nuts._vel(p, dm),
                               nuts._vel(p, diag.expand(R, d)), rtol=1e-15,
                               atol=0)
    torch.testing.assert_close(
        nuts._sample_momentum(z, dm, torch.sqrt(dm)),
        nuts._sample_momentum(z, diag.expand(R, d)), rtol=1e-14, atol=0)


def test_dense_welford_matches_jax():
    """The dense Welford accumulator over rows equals JAX's per-row
    _welford_add(dense_mass=True) at 1e-12, and the window's regularized
    covariance is finite and positive definite."""
    d, R, n = 6, 3, 9
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((n, R, d)) * np.arange(1, d + 1)
    wf = nuts._welford_init(R, d, torch.float64, "cpu", dense=True)
    wf_j = [jax_nuts._welford_init(d, jnp.float64, True, True)
            for _ in range(R)]
    for x in xs:
        wf = nuts._welford_add(wf, torch.as_tensor(x))
        wf_j = [jax_nuts._welford_add(w, jnp.asarray(x[r]), True)
                for r, w in enumerate(wf_j)]
    for i in range(2):
        want = np.stack([np.asarray(w[i]) for w in wf_j])
        np.testing.assert_allclose(wf[i].numpy(), want, rtol=1e-12,
                                   atol=1e-12)
    assert wf[2] == float(wf_j[0][2]) == n
    m_inv, chol = nuts._window_metric(
        wf, torch.eye(d, dtype=torch.float64).expand(R, d, d),
        torch.eye(d, dtype=torch.float64).expand(R, d, d))
    torch.testing.assert_close(chol @ chol.mT, m_inv, rtol=1e-12,
                               atol=1e-12)
    assert bool((torch.linalg.eigvalsh(m_inv) > 0).all())


@pytest.mark.parametrize("case", ["dense_mass", "fixed_dense"])
def test_dense_sampler_replays_jax_noise(case):
    """sample_nuts with JAX's random numbers reproduces JAX's sample_nuts
    chain by chain with a dense metric: dense_mass adapts a per-row dense
    metric over one window (the dense Welford, the regularized covariance
    and its Cholesky factor); fixed_dense holds one (cov, chol) pair and
    adapts the step size only."""
    d, chains, warmup, samples, md = 5, 3, 40, 10, 5
    vg, prec, cov = _gaussian(d, 11, 0.5)
    prec_j = jnp.asarray(prec)
    chol = np.linalg.cholesky(cov)
    if case == "dense_mass":
        cfg_j = jax_nuts.NUTSConfig(max_depth=md, tree_scan=True,
                                    dense_mass=True)
        cfg = nuts.NUTSConfig(max_depth=md, tree_scan=True, dense_mass=True)
        metric_j = metric = None
    else:
        cfg_j = jax_nuts.NUTSConfig(max_depth=md, tree_scan=True,
                                    adapt_mass=False)
        cfg = nuts.NUTSConfig(max_depth=md, tree_scan=True,
                              adapt_mass=False)
        metric_j = (jnp.asarray(cov), jnp.asarray(chol))
        metric = (torch.as_tensor(cov), torch.as_tensor(chol))
    keys = jax.random.split(jax.random.PRNGKey(5), chains)
    q0 = np.random.default_rng(3).standard_normal((chains, d))
    draws_j, info_j = jax.vmap(lambda qq, k: jax_nuts.sample_nuts(
        lambda x: -0.5 * x @ (prec_j @ x), qq, k, warmup=warmup,
        samples=samples, cfg=cfg_j, metric=metric_j))(jnp.asarray(q0), keys)
    noise = jax_nuts_stream(keys, d, md, warmup + samples)
    draws, info = nuts.sample_nuts(vg, torch.as_tensor(q0), warmup, samples,
                                   cfg, noise=lambda: iter(noise),
                                   metric=metric)
    np.testing.assert_allclose(draws.numpy(),
                               np.asarray(draws_j).transpose(1, 0, 2),
                               rtol=1e-10, atol=1e-10)
    for k in ("logp", "accept_prob", "energy"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]).T,
                                   rtol=1e-10, atol=1e-10, err_msg=k)
    np.testing.assert_allclose(info["step_size"].numpy(),
                               np.asarray(info_j["step_size"]), rtol=1e-10)
    m_j = np.asarray(info_j["inv_mass"])            # (chains, d, d)
    m = info["inv_mass"].expand(chains, d, d).numpy()
    np.testing.assert_allclose(m, m_j, rtol=1e-10, atol=1e-12)
    if case == "dense_mass":
        assert not np.allclose(m_j, np.eye(d))       # the window adapted
    for k in ("diverging", "n_leapfrog", "warmup_diverging"):
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k]).T), k


def test_dense_mass_correlated_gaussian():
    """The JAX package's test_dense_mass_correlated_gaussian on four
    chains: the adapted dense metric recovers the covariance (relative
    Frobenius error < 0.3) with trajectories under 0.7x the diagonal
    metric's."""
    d = 6
    vg, _, cov = _gaussian(d, 11, 0.05)
    q0 = torch.zeros((4, d), dtype=torch.float64)
    draws, info = nuts.sample_nuts(
        vg, q0, 300, 300, nuts.NUTSConfig(dense_mass=True),
        generator=torch.Generator().manual_seed(4))
    est = np.cov(draws.reshape(-1, d).numpy().T)
    rel_f = np.linalg.norm(est - cov) / np.linalg.norm(cov)
    assert rel_f < 0.3, rel_f
    _, info2 = nuts.sample_nuts(vg, q0, 300, 300,
                                generator=torch.Generator().manual_seed(4))
    n_dense = float(info["n_leapfrog"].double().mean())
    n_diag = float(info2["n_leapfrog"].double().mean())
    assert n_dense < 0.7 * n_diag, (n_dense, n_diag)


def test_fixed_metric_step_size_only():
    """The JAX package's test_fixed_metric_step_size_only on four chains:
    the exact covariance as a fixed dense metric leaves an isotropic
    target (moments right, mean trajectory < 20 leapfrogs); its diagonal
    as a fixed diagonal metric diverges on < 2% of draws."""
    d = 12
    vg, _, cov = _gaussian(d, 5, 0.05)
    chol = np.linalg.cholesky(cov)
    cfg = nuts.NUTSConfig(adapt_mass=False)
    q0 = torch.zeros((4, d), dtype=torch.float64)
    draws, info = nuts.sample_nuts(
        vg, q0, 150, 250, cfg, generator=torch.Generator().manual_seed(9),
        metric=(torch.as_tensor(cov), torch.as_tensor(chol)))
    est = np.cov(draws.reshape(-1, d).numpy().T)
    rel_f = np.linalg.norm(est - cov) / np.linalg.norm(cov)
    assert rel_f < 0.3, rel_f
    assert float(info["n_leapfrog"].double().mean()) < 20
    assert info["inv_mass"].shape == (1, d, d)
    _, info2 = nuts.sample_nuts(
        vg, q0, 150, 125, cfg, generator=torch.Generator().manual_seed(9),
        metric=torch.as_tensor(np.diag(cov).copy()))
    assert float(info2["diverging"].double().mean()) < 0.02


def test_initial_metric_forms():
    """What sample_nuts reads from ``metric``: a (D,) vector or (R, D)
    rows are diagonal; a (D, D) matrix or (m_inv, chol) pair is one
    shared dense metric; (R, D, D) is dense per row; dense_mass adapts
    per row; a dense metric adapts only with dense_mass."""
    R, d = 3, 4
    rng = np.random.default_rng(1)
    m = torch.as_tensor(_spd(rng, d))

    def form(metric, **kw):
        m_inv, chol = nuts._initial_metric(metric, nuts.NUTSConfig(**kw), R,
                                           d, torch.float64, "cpu")
        return nuts.metric_form(m_inv), chol is None

    assert form(None) == ("diag", True)
    assert form(torch.ones(d)) == ("diag", True)
    assert form(torch.ones(R, d)) == ("diag", True)
    assert form(m, adapt_mass=False) == ("dense", False)
    assert form((m, torch.linalg.cholesky(m)), adapt_mass=False) == (
        "dense", False)
    assert form(m.expand(R, d, d), adapt_mass=False) == ("dense_rows", False)
    assert form(None, dense_mass=True) == ("dense_rows", False)
    assert form(m, dense_mass=True) == ("dense_rows", False)
    with pytest.raises(ValueError, match="dense_mass"):
        form(m)
