"""The port's MAP path against the JAX package: the MAP objective, the
batched L-BFGS (optax's L-BFGS with the zoom line search), the Newton
polish, fit_spectra_batch(mode='optimize') from matched initial points
and predict_Z_batch (float64 on the CPU unless stated; the JAX side runs
as the JAX package's tests run it, with x64 on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.infer.map import newton_polish as jax_newton_polish
from bayes_drt_tpu.infer.map import run_lbfgs as jax_run_lbfgs
from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu.models.posterior import log_density as jax_log_density
from bayes_drt_tpu.parallel import batch as jax_batch
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.convert import posterior_from_numpy
from bayes_drt_tpu_torch.infer import map as tmap
from bayes_drt_tpu_torch.infer.shmc_flat import (flat_shared_for,
                                                 flat_spec_for,
                                                 flat_value_and_grad)
from bayes_drt_tpu_torch.models.posterior import log_density, unravel
from bayes_drt_tpu_torch.parallel import batch

torch.set_num_threads(1)

# 31 frequencies over two decades: K = 41 basis functions, D = 91
FREQ = np.logspace(3, 1, 31)


def _batch(b=2, seed=1):
    return sim.make_benchmark_batch(b, freq=FREQ, noise_level=0.0025,
                                    seed=seed)


def _torch_vg(fn):
    """Batched value and autograd gradient of a row-wise torch loss."""
    def vg(x):
        x = x.detach().requires_grad_(True)
        f = fn(x)
        g, = torch.autograd.grad(f.sum(), x)
        return f.detach(), g
    return vg


# ---- the MAP objective ----

def _posterior(nonneg, ncp=False, b=3):
    freq, Zb = _batch(b)
    fr, _, _, cfg_j, data_j, _ = jax_batch._build_shared(
        freq, mode="optimize", nonneg=nonneg, ncp=ncp, dtype=jnp.float64)
    Zb = Zb[:, np.argsort(freq)[::-1]]
    zs = np.std(np.abs(Zb), axis=1) / np.sqrt(Zb.shape[1] / 81)
    Zs = Zb / zs[:, None]
    targets = np.concatenate([Zs.real, Zs.imag], axis=1)
    cfg, data = posterior_from_numpy(cfg_j, data_j, dtype=torch.float64,
                                     device="cpu")
    return cfg_j, data_j, cfg, data, targets


def _jax_loss(cfg_j, data_j):
    _, unravel_j = ravel_pytree(jax_init(cfg_j, data_j,
                                         jax.random.PRNGKey(0)))

    def loss(q, t):
        return -jax_log_density(cfg_j, data_j._replace(target=t),
                                unravel_j(q), jacobian=False)
    return loss


@pytest.mark.parametrize("nonneg,ncp", [(False, False), (True, False),
                                        (False, True)])
def test_map_objective_matches_jax_and_autograd(nonneg, ncp):
    """The hand-written value and gradient with jacobian=False (which also
    drops the non-centred change of variables) against jax.value_and_grad
    of the JAX log_density(jacobian=False) and against port autograd, and
    MapObjective's Hessian against jax.hessian, at rtol 1e-10 on random
    unconstrained rows."""
    cfg_j, data_j, cfg, data, targets = _posterior(nonneg, ncp)
    rng = np.random.default_rng(5)
    q = rng.uniform(-2.0, 2.0, (3, flat_spec_for(cfg, data).D))
    loss_j = _jax_loss(cfg_j, data_j)
    f_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(loss_j)))(
        jnp.asarray(q), jnp.asarray(targets))
    h_j = jax.jit(jax.vmap(jax.hessian(loss_j)))(jnp.asarray(q),
                                                 jnp.asarray(targets))
    qt, tt = torch.tensor(q), torch.tensor(targets)
    spec, sh = flat_spec_for(cfg, data), flat_shared_for(cfg, data,
                                                         torch.float64)
    lp, g = flat_value_and_grad(spec, sh.A, sh.L, sh.vecs, sh.scal, qt, tt,
                                jacobian=False)
    np.testing.assert_allclose(-lp.numpy(), np.asarray(f_j), rtol=1e-10)
    np.testing.assert_allclose(-g.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10 * np.abs(g_j).max())
    for i in range(3):
        qi = qt[i].clone().requires_grad_(True)
        lp_i = log_density(cfg, data._replace(target=tt[i]),
                           unravel(cfg, qi), jacobian=False)
        g_i, = torch.autograd.grad(lp_i, qi)
        np.testing.assert_allclose(lp[i].item(), lp_i.item(), rtol=1e-10)
        np.testing.assert_allclose(g[i].numpy(), g_i.numpy(), rtol=1e-10,
                                   atol=1e-10 * g_i.abs().max().item())
    obj = batch.MapObjective(cfg, data, tt)
    f_o, g_o = obj.value_and_grad(qt[1:], torch.tensor([1, 2]))
    np.testing.assert_array_equal(f_o.numpy(), -lp[1:].numpy())
    h = obj.hessian(qt).numpy()
    np.testing.assert_allclose(h, np.asarray(h_j), rtol=1e-10,
                               atol=1e-10 * np.abs(h_j).max())


# ---- the batched L-BFGS against optax's, row by row ----

_H_ILL = np.logspace(0, 4, 6)          # condition number 1e4
_C_ILL = np.linspace(-1.0, 2.0, 6)


def _quadratic(xp):
    def f(x):
        h = xp.asarray(_H_ILL, dtype=x.dtype)
        c = xp.asarray(_C_ILL, dtype=x.dtype)
        return 0.5 * xp.sum(h * (x - c) ** 2, -1)
    return f


def _rosenbrock(x):
    return (100.0 * ((x[..., 1:] - x[..., :-1] ** 2) ** 2).sum(-1)
            + ((1.0 - x[..., :-1]) ** 2).sum(-1))


# name: (torch loss, jax loss, dimension, optimum, branches taken); the
# last row of every case starts at its optimum and stops after one
# iteration. Every line search starts with the interval search; the
# branches held by the spy below are "extended", the interval search past
# its first trial step (step sizes above 1: rosenbrock_2d), and in the
# zoom "cubic" and "quad", the interpolant chosen, and "bisect" (on a
# quadratic the cubic interpolant degenerates and is never chosen).
LBFGS_CASES = {
    "ill_conditioned_quadratic": (_quadratic(torch), _quadratic(jnp), 6,
                                  _C_ILL, {"quad", "bisect"}),
    "rosenbrock_2d": (_rosenbrock, _rosenbrock, 2, np.ones(2),
                      {"extended", "cubic", "quad", "bisect"}),
    "rosenbrock_10d": (_rosenbrock, _rosenbrock, 10, np.ones(10),
                       {"cubic", "quad", "bisect"}),
}


@pytest.fixture
def branch_spy(monkeypatch):
    """Counts the zoom's choices (cubic, quadratic, bisection) over the
    rows in the zoom, and the line searches that ended past step 1."""
    seen = {"cubic": 0, "quad": 0, "bisect": 0, "extended": 0}
    nxt, post = tmap._next_stepsize, tmap._LBFGS.post

    def next_spy(zoom, search_step, low, vl, sl, high, vh, cref, vcref):
        out = nxt(zoom, search_step, low, vl, sl, high, vh, cref, vcref)
        mc = tmap._cubicmin(low, vl, sl, high, vh, cref, vcref)
        mq = tmap._quadmin(low, vl, sl, high, vh)
        seen["cubic"] += int((zoom & (out == mc)).sum())
        seen["quad"] += int((zoom & (out == mq) & (out != mc)).sum())
        seen["bisect"] += int((zoom & (out != mq) & (out != mc)).sum())
        return out

    def post_spy(self, s):
        seen["extended"] += int((s["act"] & (s["ls_stepsize"] > 1.0)).sum())
        return post(self, s)

    monkeypatch.setattr(tmap, "_next_stepsize", next_spy)
    monkeypatch.setattr(tmap._LBFGS, "post", post_spy)
    return seen


@pytest.mark.parametrize("case", sorted(LBFGS_CASES))
def test_run_lbfgs_matches_optax_row_by_row(case, branch_spy):
    f_t, f_j, d, opt, branches = LBFGS_CASES[case]
    # the two frameworks sum in different orders, and from some starts the
    # 10-D valley amplifies those last-bit differences past 1e-8 (one row in
    # ~50 drew a different stop iteration); these seeded starts stay within
    # 5e-9 of optax (24 rows of this seed checked in 2-D and 10-D)
    x0 = np.random.default_rng(7).uniform(-2.0, 2.0, (8, d))
    x0[-1] = opt
    want = jax.vmap(lambda x: jax_run_lbfgs(f_j, x, max_iter=500))(
        jnp.asarray(x0))
    got = tmap.run_lbfgs(_torch_vg(f_t), torch.tensor(x0), max_iter=500)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-8, atol=1e-8)
    assert int(got.n_iter[-1]) == 1
    assert {k for k, v in branch_spy.items() if v > 0} == branches, \
        branch_spy


def test_run_lbfgs_float32_tolerance_floor():
    """In float32 the stagnation tolerance is floored at 10 eps (1.2e-6):
    every row stops on it, where float64 runs on from the same start, and
    on the iteration optax stops."""
    h, c = np.logspace(0, 2, 8), np.linspace(-1.0, 1.0, 8)

    def quartic(xp):
        def f(x):
            hh, cc = xp.asarray(h, dtype=x.dtype), xp.asarray(c, dtype=x.dtype)
            return (0.5 * xp.sum(hh * (x - cc) ** 2, -1)
                    + 0.25 * xp.sum((x - cc) ** 4, -1))
        return f

    x0 = np.random.default_rng(0).uniform(-3.0, 3.0, (4, 8))
    want = jax.vmap(lambda x: jax_run_lbfgs(quartic(jnp), x, max_iter=200))(
        jnp.asarray(x0, jnp.float32))
    got = tmap.run_lbfgs(_torch_vg(quartic(torch)),
                         torch.tensor(x0, dtype=torch.float32), max_iter=200)
    assert got.params.dtype == torch.float32
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    assert bool(got.converged.all())
    eps32 = float(np.finfo(np.float32).eps)
    assert bool((got.grad_norm > 50 * eps32).all())     # not the gradient
    f64 = tmap.run_lbfgs(_torch_vg(quartic(torch)), torch.tensor(x0),
                         max_iter=200)
    assert bool((f64.n_iter > got.n_iter).all())


def _map_rows(b=2, seed=3):
    """MapObjective of a small batch and Stan-random starts."""
    freq, Zb = _batch(b)
    _, _, _, cfg, data, _ = batch._build_shared(
        freq, mode="optimize", dtype=torch.float64, device="cpu")
    Zb = Zb[:, np.argsort(freq)[::-1]]
    _, targets = batch._scaled_targets(Zb, b, None, torch.float64, "cpu")
    obj = batch.MapObjective(cfg, data, targets)
    q0 = np.random.default_rng(seed).uniform(-2.0, 2.0, (b, obj.spec.D))
    return obj, q0


def _jax_obj(obj):
    """The JAX package's MAP loss of the same posterior, one row a target."""
    _, _, _, cfg_j, data_j, _ = jax_batch._build_shared(
        np.asarray(obj.data.freq), mode="optimize", dtype=jnp.float64)
    return _jax_loss(cfg_j, data_j), jnp.asarray(obj.targets.numpy())


def test_run_lbfgs_on_the_map_posterior_matches_jax():
    obj, q0 = _map_rows()
    loss_j, t_j = _jax_obj(obj)
    want = jax.vmap(lambda q, t: jax_run_lbfgs(lambda x: loss_j(x, t), q,
                                               max_iter=30))(
        jnp.asarray(q0), t_j)
    got = tmap.run_lbfgs(obj.value_and_grad, torch.tensor(q0), max_iter=30)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    for name in ("value", "params", "grad_norm"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max())


# ---- the Newton polish ----

def _quartic_chain(x):
    # tests/test_round4.py's Rosenbrock-flavoured quartic
    return (100.0 * ((x[..., 1:] - x[..., :-1] ** 2) ** 2).sum(-1)
            + ((1.0 - x[..., :-1]) ** 2).sum(-1))


def test_newton_polish_certifies_capped_lbfgs_like_jax():
    """L-BFGS capped at 10 iterations from three starts leaves a large
    gradient; the polish certifies every row as the JAX polish does."""
    x0 = np.stack([np.zeros(12), np.full(12, 0.5),
                   np.linspace(-1.0, 1.0, 12)])
    j1 = jax.vmap(lambda x: jax_run_lbfgs(_quartic_chain, x, max_iter=10))(
        jnp.asarray(x0))
    j2 = jax.vmap(lambda x: jax_newton_polish(_quartic_chain, x,
                                              max_iter=100))(j1.params)
    vg = _torch_vg(_quartic_chain)
    t1 = tmap.run_lbfgs(vg, torch.tensor(x0), max_iter=10)
    assert not bool(t1.converged.any())
    hess = torch.func.vmap(torch.func.hessian(_quartic_chain))
    t2 = tmap.newton_polish(lambda x, rows: vg(x), lambda x, rows: hess(x),
                            t1.params, max_iter=100)
    np.testing.assert_array_equal(t2.n_iter.numpy(), np.asarray(j2.n_iter))
    np.testing.assert_array_equal(t2.converged.numpy(),
                                  np.asarray(j2.converged))
    assert bool(t2.converged.all()) and float(t2.grad_norm.max()) < 1e-5
    np.testing.assert_allclose(t2.value.numpy(), np.asarray(j2.value),
                               rtol=1e-10, atol=1e-10)
    assert bool((t2.value <= t1.value + 1e-12).all())


def test_newton_polish_on_the_map_posterior_matches_jax():
    obj, q0 = _map_rows()
    loss_j, t_j = _jax_obj(obj)
    start = tmap.run_lbfgs(obj.value_and_grad, torch.tensor(q0),
                           max_iter=150).params
    want = jax.vmap(lambda q, t: jax_newton_polish(lambda x: loss_j(x, t),
                                                   q, max_iter=40))(
        jnp.asarray(start.numpy()), t_j)
    got = tmap.newton_polish(obj.value_and_grad, obj.hessian, start,
                             max_iter=40)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-10)


def test_run_lbfgs_restarts_keeps_the_best_finite_optimum():
    """Each problem keeps its restart of lowest finite value; a restart
    whose value is NaN is never kept."""
    vg = _torch_vg(_rosenbrock)
    x0 = torch.tensor([[[-1.5, 2.0], [0.9, 0.8]], [[1.0, 1.0], [-1.0, 1.0]]],
                      dtype=torch.float64)
    res = tmap.run_lbfgs_restarts(vg, x0, max_iter=3)
    each = tmap.run_lbfgs(vg, x0.reshape(4, 2), max_iter=3)
    pick = torch.argmin(each.value.reshape(2, 2), dim=1) + torch.tensor([0, 2])
    for got, rows in zip(res, each):
        torch.testing.assert_close(got, rows[pick], rtol=0, atol=0)

    def nan_where_x0_large(x):
        f, g = vg(x)
        return torch.where(x[:, 0] > 0.5, float("nan"), f), g

    res = tmap.run_lbfgs_restarts(nan_where_x0_large, x0, max_iter=3)
    assert bool(torch.isfinite(res.value).all())


# ---- fit_spectra_batch(mode='optimize') from matched initial points ----

RIDGE_DEFAULTS = dict(penalty="integral", hyper_lambda=True, lambda_0=1.0,
                      hl_beta=5, weights="modulus")


def _jax_starts(freq, Zb, seed, n_restarts, init_from_ridge,
                basis_freq=None):
    """The starts the JAX package's fit_spectra_batch(mode='optimize')
    draws: its spectrum keys, and its ridge seed, rebuilt as it builds
    them (the padded batch at descending frequencies). Returns (b, D) or
    (b, n_restarts, D)."""
    order = np.argsort(freq)[::-1]
    freq_d = freq[order]
    Zp, _ = jax_batch._pad_pow2(Zb[:, order])
    b = Zp.shape[0]
    _, _, _, cfg_j, data_j, _ = jax_batch._build_shared(
        freq_d, basis_freq, None, mode="optimize", dtype=jnp.float64)
    zs = np.std(np.abs(Zp), axis=1) / np.sqrt(Zp.shape[1] / 81)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)

    def flat(p):
        return np.asarray(ravel_pytree(p)[0])

    if not init_from_ridge:
        return np.stack([[flat(jax_init(cfg_j, data_j, k))
                          for k in jax.random.split(keys[i], n_restarts)]
                         for i in range(b)])
    rres = jax_batch.ridge_fit_spectra_batch(freq_d, Zp,
                                             basis_freq=basis_freq,
                                             **RIDGE_DEFAULTS)
    iv = {"x_0": np.asarray(rres.coef) / zs[:, None],
          "Rinf_raw": np.maximum(np.asarray(rres.r_inf) / zs, 1e-10) / 100.0,
          "induc_raw": np.maximum(np.asarray(rres.inductance) / zs, 1e-10)}
    return np.stack([flat(jax_init(cfg_j, data_j, keys[i], init_values={
        k: v[i] for k, v in iv.items()})) for i in range(b)])


# L-BFGS from Stan-random starts on this posterior is chaotic: the two
# packages' last-bit differences (the hand-written gradient against JAX's
# autodiff) grow to ~1e-7 by iteration 50 and ~1e-2 by 100, so the restart
# case caps L-BFGS at 30 and leaves the rest to the polish; the ridge seed
# starts near the optimum
FIT_CASES = {
    "restarts": dict(n_restarts=2, max_iter=30),
    "ridge_custom_basis": dict(init_from_ridge=True, max_iter=300,
                               basis_freq=np.logspace(3.5, 0.5, 33)),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_optimize_matches_jax_from_matched_starts(case, monkeypatch):
    """Both branches of the MAP fit, each package from the same starts
    (the port's init replaced by the JAX package's draws): coef and r_inf
    within 1e-6 of each spectrum's largest entry, and the objective within
    1e-6 relative, after L-BFGS and the Newton polish. In the ridge case
    the port's own seed (its ridge on the case's basis, through its
    init's transform) is first held to the JAX package's at 1e-12 of each
    parameter's largest entry (measured: 4e-14); the fit then starts from
    the JAX package's, since 300 L-BFGS iterations on this posterior
    amplify even that gap to ~7e-3."""
    kw = FIT_CASES[case]
    freq, Zb = _batch(2, seed=4)
    q0 = _jax_starts(freq, Zb, 0, kw.get("n_restarts", 2),
                     kw.get("init_from_ridge", False), kw.get("basis_freq"))
    port_init, seeded = batch.init_unconstrained, []

    def matched_init(cfg, data, gen, batch_shape=(), init_values=None):
        drawn = unravel(cfg, torch.tensor(q0).reshape(
            tuple(batch_shape) + q0.shape[-1:]))
        if init_values is not None:
            own = port_init(cfg, data, gen, batch_shape, init_values)
            for name in init_values:
                want = drawn[name].numpy()
                np.testing.assert_allclose(
                    own[name].numpy(), want, rtol=1e-12,
                    atol=1e-12 * np.abs(want).max())
                seeded.append(name)
        return drawn

    monkeypatch.setattr(batch, "init_unconstrained", matched_init)
    got = batch.fit_spectra_batch(freq, Zb, mode="optimize", device="cpu",
                                  dtype=torch.float64, **kw)
    assert sorted(seeded) == (["Rinf_raw", "induc_raw", "x_0"]
                              if kw.get("init_from_ridge") else [])
    want = jax_batch.fit_spectra_batch(freq, Zb, mode="optimize", **kw)
    np.testing.assert_allclose(got.tau, want.tau, rtol=1e-12)
    assert got.gamma_lo is None and got.gamma_hi is None
    full = lambda r: np.concatenate([r.coef, r.r_inf[:, None]], axis=1)
    scale = np.abs(full(want)).max(axis=1, keepdims=True)
    err = np.abs(full(got) - full(want)) / scale
    assert err.max() < 1e-6, err.max(axis=1)
    d, dj = got.diagnostics, want.diagnostics
    np.testing.assert_allclose(d["value"], dj["value"], rtol=1e-6)
    assert set(d) == set(dj) == {"value", "n_iter", "grad_norm", "converged",
                                 "dist_geometry"}
    assert d["n_iter"].dtype == np.float32 and d["converged"].dtype == bool


# ---- predict_Z_batch, options, errors ----

def _jax_result(res):
    """The JAX package's BatchFitResult for a port result (the geometry
    record its predict_Z_batch reads)."""
    geometry = ({"name": "DRT", "kernel": "DRT", "dist_type": "series",
                 "symmetry": "planar", "bc": "transmissive", "ct": False,
                 "k_ct": None, "basis": res.basis, "tau": res.tau,
                 "epsilon": res.epsilon},)
    return jax_batch.BatchFitResult(
        coef=res.coef, r_inf=res.r_inf, inductance=res.inductance,
        gamma_lo=res.gamma_lo, gamma_hi=res.gamma_hi, z_scales=res.z_scales,
        tau=res.tau, epsilon=res.epsilon,
        diagnostics={**res.diagnostics, "dist_geometry": geometry},
        basis=res.basis)


def test_predict_Z_batch_matches_jax():
    """At new frequencies (ascending, 2x denser) and at the training grid:
    a MAP result's prediction from its coefficients, and a sample-mode
    result's stored draws' mean at the training grid in any order."""
    freq, Zb = _batch(3)
    rng = np.random.default_rng(2)
    tau = batch.get_tau_basis(np.sort(freq)[::-1])
    res = batch.BatchFitResult(
        coef=rng.uniform(0.0, 0.2, (3, len(tau))), r_inf=rng.uniform(
            0.5, 1.5, 3), inductance=rng.uniform(0.0, 1e-6, 3),
        gamma_lo=None, gamma_hi=None, z_scales=np.ones(3), tau=tau,
        epsilon=batch.default_epsilon(tau), diagnostics={})
    dense = np.logspace(0.8, 3.2, 61)
    for f in (dense, freq):
        got = batch.predict_Z_batch(res, f, device="cpu")
        want = jax_batch.predict_Z_batch(_jax_result(res), f)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    f_desc = np.sort(freq)[::-1]
    zm = rng.standard_normal((3, 2 * len(freq)))
    sampled = res._replace(diagnostics={"f_train": f_desc, "z_hat_mean": zm})
    perm = rng.permutation(len(freq))
    got = batch.predict_Z_batch(sampled, freq[perm], device="cpu")
    want = jax_batch.predict_Z_batch(_jax_result(sampled), freq[perm])
    np.testing.assert_array_equal(got, want)
    at = [int(np.flatnonzero(f_desc == f)[0]) for f in freq[perm]]
    n = len(freq)
    at = np.array(at)
    np.testing.assert_array_equal(got, zm[:, at] + 1j * zm[:, n + at])


@pytest.mark.parametrize("mode", ["sample", "optimize"])
def test_build_shared_options_match_jax(mode):
    """basis_freq, epsilon and sigma_min reach the posterior as in the JAX
    package, in both modes (the mode's L scales and ups prior included)."""
    bf = np.logspace(3.5, 0.5, 25)
    kw = dict(basis_freq=bf, epsilon=3.0, sigma_min=0.01)
    _, tau, eps, cfg, data, _ = batch._build_shared(
        FREQ, mode=mode, dtype=torch.float64, device="cpu", **kw)
    _, tau_j, eps_j, cfg_j, data_j, _ = jax_batch._build_shared(
        FREQ, mode=mode, dtype=jnp.float64, **kw)
    np.testing.assert_allclose(tau, tau_j, rtol=1e-14)
    assert eps == eps_j == 3.0
    assert cfg.dists[0].K == cfg_j.dists[0].K == 25
    for name in ("A", "L"):
        np.testing.assert_allclose(getattr(data, name)[0].numpy(),
                                   np.asarray(getattr(data_j, name)[0]),
                                   rtol=1e-10, atol=1e-13)
    for name in ("sigma_min", "ups_alpha", "ups_beta", "sigma_out_alpha"):
        np.testing.assert_allclose(getattr(data, name).item(),
                                   float(getattr(data_j, name)), rtol=1e-15)


def test_optimize_errors_and_options():
    freq, Zb = _batch(1)
    ddt = {"DDT": {"kernel": "DDT", "bc": "transmissive"}}
    with pytest.raises(NotImplementedError, match="item 11"):
        batch.fit_spectra_batch(freq, Zb, mode="optimize", distributions=ddt,
                                init_from_ridge=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        batch.fit_spectra_batch(freq, Zb, outliers=True, sampler="shmc",
                                device="cpu")
    with pytest.raises(ValueError, match="mode='sample'"):
        batch.fit_spectra_batch(freq, Zb, mode="optimize", quality="strict",
                                device="cpu")
    with pytest.raises(ValueError, match="Invalid mode"):
        batch.fit_spectra_batch(freq, Zb, mode="map", device="cpu")
    # no polish, timing and z_scale: phases and the L-BFGS counts alone
    res = batch.fit_spectra_batch(freq, Zb, mode="optimize", max_iter=5,
                                  n_restarts=3, polish=False, z_scale=2.0,
                                  timing=True, device="cpu")
    assert set(res.diagnostics["phase_s"]) == {"setup", "lbfgs"}
    np.testing.assert_array_equal(res.diagnostics["n_iter"], [5.0])
    np.testing.assert_array_equal(res.diagnostics["n_iter_lbfgs"], [5.0])
    np.testing.assert_array_equal(res.z_scales, [2.0])
    assert res.coef.shape == (1, 41) and np.isfinite(res.coef).all()
