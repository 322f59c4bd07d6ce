"""The port's ridge options against the JAX package: the lambda and
weight update functions, ``run_hyper_lambda`` with each option (dZ
reweighting, hyper-a/b, the LM and f-beta solutions), ``run_hyper_weights``
and ``ridge_fit_spectra_batch``'s Re-Im cross-validation and
hyper-weights modes (float64 on the CPU)."""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer import ridge as jax_ridge
from bayes_drt_tpu.parallel.batch import \
    ridge_fit_spectra_batch as jax_ridge_batch
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import ridge
from bayes_drt_tpu_torch.ops.matrices import (construct_A, construct_L,
                                              construct_M, default_epsilon)
from bayes_drt_tpu_torch.parallel import ridge_fit_spectra_batch

torch.set_num_threads(1)

# the update functions are closed forms or fixed loops: held at 1e-10
FN_RTOL = 1e-10
# but the hyper-a golden-section search: its objective is flat at the
# minimum, so the two packages' last-bit differences in lgamma and the
# log-sum flip comparisons once the bracket is ~sqrt(eps) wide; the
# minimizer is held at 1e-7 and the objective there at 1e-14
A_RTOL = 1e-7
A_OBJ_RTOL = 1e-14
# the iterations (QP re-solves) at 1e-8 of the largest coefficient
RUN_RTOL = 1e-8

FREQ = np.logspace(5, -1, 31)
BASIS = np.logspace(5.5, -1.5, 29)


def _t(a):
    return torch.as_tensor(np.asarray(a, float))


def _lx_inputs(seed, b=3, kl=9, k=11):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((kl, k))
    coef = np.abs(rng.standard_normal((b, k)))
    return rng, L, coef


def test_hyper_lambda_fbeta_matches_jax():
    _, L, coef = _lx_inputs(0)
    got = ridge.hyper_lambda_fbeta(_t(L), _t(coef), 0.1, 0.3).numpy()
    for i in range(len(coef)):
        want = jax_ridge.hyper_lambda_fbeta(jnp.asarray(L),
                                            jnp.asarray(coef[i]), 0.1, 0.3)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=FN_RTOL)


def test_hyper_lambda_lm_matches_jax():
    rng, L, coef = _lx_inputs(1)
    prev = rng.uniform(1e-3, 2.0, (len(coef), L.shape[0]))
    beta = rng.uniform(2.0, 6.0, (len(coef), L.shape[0]))
    got = ridge.hyper_lambda_lm(_t(L), _t(coef), _t(prev), _t(beta),
                                0.05).numpy()
    for i in range(len(coef)):
        want = jax_ridge.hyper_lambda_lm(jnp.asarray(L), jnp.asarray(coef[i]),
                                         jnp.asarray(prev[i]),
                                         jnp.asarray(beta[i]), 0.05)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=FN_RTOL)


def test_hyper_a_and_b_updates_match_jax():
    rng = np.random.default_rng(2)
    lam = rng.uniform(0.01, 3.0, (4, 13))
    a = rng.uniform(1.2, 3.0, 4)
    b_got = ridge.hyper_b_update(_t(lam), _t(a), 0.7, 11).numpy()
    a_got = ridge.hyper_a_update(_t(lam), _t(b_got), 2.0, 1.5).numpy()
    for i in range(4):
        b_want = jax_ridge.hyper_b_update(jnp.asarray(lam[i]), a[i], 0.7, 11)
        np.testing.assert_allclose(b_got[i], float(b_want), rtol=FN_RTOL)
        a_want = jax_ridge.hyper_a_update(jnp.asarray(lam[i]), b_want, 2.0,
                                          1.5)
        np.testing.assert_allclose(a_got[i], float(a_want), rtol=A_RTOL)

        def obj(a):
            return (-2.0 * a * np.sum(np.log(b_got[i] * lam[i]))
                    + 2.0 * math.lgamma(a) + 2.0 * 1.5 * (a - 1.0)
                    - 2.0 * (2.0 - 1.0) * np.log(a - 1.0))

        np.testing.assert_allclose(obj(a_got[i]), obj(float(a_want)),
                                   rtol=A_OBJ_RTOL)


@pytest.mark.parametrize("shared_design", [True, False])
def test_hyper_weights_update_matches_jax(shared_design):
    rng = np.random.default_rng(3)
    b, n, k = 3, 15, 8
    A_re = rng.standard_normal((n, k) if shared_design else (b, n, k))
    A_im = rng.standard_normal(A_re.shape)
    coef, T_re, T_im = (rng.standard_normal(s) for s in ((b, k), (b, n),
                                                        (b, n)))
    wbar_re, wbar_im = (rng.uniform(0.5, 2.0, (b, n)) for _ in range(2))
    got = ridge.hyper_weights_update(*map(_t, (coef, A_re, A_im, T_re, T_im)),
                                     2.0, _t(wbar_re), _t(wbar_im))
    for i in range(b):
        ar = A_re if shared_design else A_re[i]
        ai = A_im if shared_design else A_im[i]
        want = jax_ridge.hyper_weights_update(
            *map(jnp.asarray, (coef[i], ar, ai, T_re[i], T_im[i])), 2.0,
            jnp.asarray(wbar_re[i]), jnp.asarray(wbar_im[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=FN_RTOL)


def _series_problem(penalty, b=2, seed=4):
    """Weighted ridge data of ``b`` noisy ZARC spectra on FREQ with the
    R_inf and inductance columns (the Inverter's layout), numpy."""
    _, Zb = sim.make_benchmark_batch(b, freq=FREQ, noise_level=0.003,
                                     seed=seed)
    tau = 1.0 / (2 * np.pi * BASIS)
    eps = default_epsilon(tau)
    kw = dict(tau=tau, epsilon=eps, device="cpu")
    kb, n = len(tau), len(FREQ)
    k = kb + 2
    A_re, A_im = np.zeros((n, k)), np.zeros((n, k))
    A_re[:, 0] = 1.0
    A_im[:, 1] = 2 * np.pi * FREQ * 1e-4
    A_re[:, 2:] = construct_A(FREQ, "real", **kw).numpy()
    A_im[:, 2:] = construct_A(FREQ, "imag", **kw).numpy()
    f_coll = 1.0 / (2 * np.pi * tau)
    if penalty == "integral":
        L2 = np.zeros((3, k, k))
        for o in range(3):
            L2[o, 2:, 2:] = construct_M(f_coll, order=o, epsilon=eps,
                                        device="cpu").numpy()
        L_ops = np.zeros((3, kb, k))
    else:
        L_ops = np.stack([np.concatenate(
            [np.zeros((kb, 2)), construct_L(f_coll, order=o, **kw).numpy()],
            axis=1) for o in range(3)])
        L2 = np.einsum("nik,nil->nkl", L_ops, L_ops)
    z_scale = np.std(np.abs(Zb), axis=1)[:, None]
    Zs = Zb / z_scale
    w = 1.0 / np.abs(Zs)
    # the dZ reweighting's dZ'/dlntau matrix (inverter.py:295-307)
    dlnt = np.mean(np.diff(np.log(tau)))
    b_tau = np.logspace(np.log10(np.exp(np.log(tau[0]) - dlnt / 2)),
                        np.log10(np.exp(np.log(tau[-1]) + dlnt / 2)), kb + 1)
    B_pre = construct_A(1.0 / (2 * np.pi * b_tau), "real", **kw).numpy()
    B = np.concatenate([np.zeros((kb, 2)), B_pre[1:] - B_pre[:-1]], axis=1)
    return dict(A_re=A_re, A_im=A_im, T_re=Zs.real, T_im=Zs.imag, w=w,
                L2_base=L2, L_ops=L_ops, B=B, dZ_scale=dlnt / 0.23026, k=k)


def _ridge_data(pb, i=None, lib="torch"):
    """RidgeData of spectrum i (JAX) or of all spectra (the port)."""
    sl = slice(None) if i is None else i
    w = pb["w"][sl]
    f = dict(WA_re=w[..., None] * pb["A_re"], WA_im=w[..., None] * pb["A_im"],
             WT_re=w * pb["T_re"][sl], WT_im=w * pb["T_im"][sl],
             L2_base=pb["L2_base"], L_ops=pb["L_ops"],
             L1_vec=np.zeros(pb["k"]), reg_frac=np.array([0.0, 0.0, 1.0]),
             lb=np.zeros(pb["k"]), ub=np.full(pb["k"], np.inf))
    if lib == "jax":
        return jax_ridge.RidgeData(**{n: jnp.asarray(v) for n, v in f.items()})
    return ridge.RidgeData(**{n: _t(v) for n, v in f.items()})


HL_CASES = {
    "dZ": dict(penalty="discrete", cfg=dict(use_dZ=True)),
    "hyper_a": dict(penalty="discrete", cfg=dict(use_hyper_a=True)),
    "hyper_b": dict(penalty="discrete", cfg=dict(use_hyper_b=True)),
    "hyper_ab_integral": dict(penalty="integral",
                              cfg=dict(use_hyper_a=True, use_hyper_b=True)),
    "lm": dict(penalty="discrete", cfg=dict(use_lm=True)),
    "fbeta": dict(penalty="discrete", cfg=dict(use_fbeta=True)),
}


@pytest.mark.parametrize("case", sorted(HL_CASES))
def test_run_hyper_lambda_option_matches_jax(case):
    spec = HL_CASES[case]
    pb = _series_problem(spec["penalty"])
    cfg_kw = dict(part="both", penalty=spec["penalty"], n_fixed=2,
                  max_iter=12, **spec["cfg"])
    kw = dict(hl_fbeta=0.2, dZ_scale=pb["dZ_scale"], dZ_power=0.5,
              xtol=1e-6)
    x0 = np.full(pb["k"], 1e-6)
    mask = np.ones(pb["k"])
    got = ridge.run_hyper_lambda(
        ridge.HyperLambdaConfig(**cfg_kw), _ridge_data(pb), _t(x0),
        _t([4.0, 4.0, 4.0]), 0.05, sb=_t([1.5] * 3), alpha_a=_t([2.5] * 3),
        beta_a=_t([1.5] * 3), B=_t(pb["B"]), delta_mask=_t(mask), **kw)
    for i in range(2):
        want = jax_ridge.run_hyper_lambda(
            jax_ridge.HyperLambdaConfig(**cfg_kw), _ridge_data(pb, i, "jax"),
            jnp.asarray(x0), jnp.full(3, 4.0), 0.05, sb=jnp.full(3, 1.5),
            alpha_a=jnp.full(3, 2.5), beta_a=jnp.full(3, 1.5),
            B=jnp.asarray(pb["B"]), delta_mask=jnp.asarray(mask), **kw)
        assert int(got.n_iter[i]) == int(want.n_iter)
        c = got.coef[i].numpy()
        np.testing.assert_allclose(c, np.asarray(want.coef), rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(c).max())
        lam = got.lam_vectors[i].numpy()
        np.testing.assert_allclose(lam, np.asarray(want.lam_vectors),
                                   rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(lam).max())
        np.testing.assert_allclose(float(got.cost[i]), float(want.cost),
                                   rtol=RUN_RTOL)


def test_run_hyper_weights_matches_jax():
    pb = _series_problem("discrete", b=3, seed=6)
    pb["T_re"][:, 9] += 0.4       # one corrupted point per spectrum
    wbar = pb["w"]
    got = ridge.run_hyper_weights(
        "both", _ridge_data(pb), _t(pb["A_re"]), _t(pb["A_im"]),
        _t(pb["T_re"]), _t(pb["T_im"]), 0.1, 2.0, _t(wbar), _t(wbar),
        max_iter=15, xtol=1e-6)
    for i in range(3):
        want = jax_ridge.run_hyper_weights(
            "both", _ridge_data(pb, i, "jax"), jnp.asarray(pb["A_re"]),
            jnp.asarray(pb["A_im"]), jnp.asarray(pb["T_re"][i]),
            jnp.asarray(pb["T_im"][i]), 0.1, 2.0, jnp.asarray(wbar[i]),
            jnp.asarray(wbar[i]), max_iter=15, xtol=1e-6)
        assert int(got.n_iter[i]) == int(want.n_iter)
        c = got.coef[i].numpy()
        np.testing.assert_allclose(c, np.asarray(want.coef), rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(c).max())
        for g, w in ((got.weights_re, want.weights_re),
                     (got.weights_im, want.weights_im)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=RUN_RTOL)
        # the corrupted point is the least weighted against its prior
        assert int(np.argmin(got.weights_re[i].numpy() / wbar[i])) == 9


def test_hyper_lambda_rows_with_own_lambda_0():
    """A per-row lambda_0 (the batched CV's form) gives each row its own
    scalar fit (to the last bits that a different batch composition
    moves)."""
    pb = _series_problem("integral", b=2, seed=7)
    cfg = ridge.HyperLambdaConfig(penalty="integral", n_fixed=2)
    lams = [0.3, 3.0]
    both = ridge.run_hyper_lambda(cfg, _ridge_data(pb), _t(np.full(
        pb["k"], 1e-6)), _t([5.0] * 3), _t(lams))
    for i, lam in enumerate(lams):
        one = ridge.run_hyper_lambda(cfg, _ridge_data(pb), _t(np.full(
            pb["k"], 1e-6)), _t([5.0] * 3), lam)
        np.testing.assert_allclose(both.coef[i].numpy(),
                                   one.coef[i].numpy(), rtol=1e-12,
                                   atol=1e-15)


CV_GRID = np.logspace(-10, 5, 16)


@pytest.mark.parametrize("hyper_lambda", [True, False])
def test_ridge_batch_cv_matches_jax(hyper_lambda):
    freq, Zb = sim.make_benchmark_batch(3, freq=FREQ, noise_level=0.004,
                                        seed=8)
    kw = dict(basis_freq=BASIS, penalty="integral", hl_beta=5,
              hyper_lambda=hyper_lambda, cv_lambdas=CV_GRID)
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        got = ridge_fit_spectra_batch(freq, Zb, dtype=torch.float64,
                                      device="cpu", **kw)
    with warnings.catch_warnings(record=True) as w_want:
        warnings.simplefilter("always")
        want = jax_ridge_batch(freq, Zb, dtype=jnp.float64, **kw)
    # the same boundary warning (spectra at a grid end), or none
    assert ([str(w.message) for w in w_got if "boundary" in str(w.message)]
            == [str(w.message) for w in w_want
                if "boundary" in str(w.message)])
    d, dj = got.diagnostics, want.diagnostics
    np.testing.assert_array_equal(d["cv_lambda"], np.asarray(dj["cv_lambda"]))
    for name in ("cv_recv", "cv_imcv", "cv_totcv"):
        np.testing.assert_allclose(d[name], np.asarray(dj[name]),
                                   rtol=RUN_RTOL, err_msg=name)
    for name in ("coef", "r_inf", "inductance"):
        a = getattr(got, name)
        np.testing.assert_allclose(a, np.asarray(getattr(want, name)),
                                   rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(got.coef).max(),
                                   err_msg=name)


def test_ridge_batch_hyper_weights_matches_jax():
    freq, Zb = sim.make_benchmark_batch(3, freq=FREQ, noise_level=0.003,
                                        seed=9)
    Zb[:, 7] += 0.3
    # the caller's point order is scrambled: weights come back in it
    perm = np.random.default_rng(0).permutation(len(freq))
    kw = dict(basis_freq=BASIS, penalty="discrete", hyper_lambda=False,
              hyper_weights=True, hw_beta=2.0, hw_wbar="modulus",
              lambda_0=0.1)
    got = ridge_fit_spectra_batch(freq[perm], Zb[:, perm],
                                  dtype=torch.float64, device="cpu", **kw)
    want = jax_ridge_batch(freq[perm], Zb[:, perm], dtype=jnp.float64, **kw)
    for name in ("coef", "r_inf", "inductance"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(got.coef).max(),
                                   err_msg=name)
    for name in ("weights_re", "weights_im", "n_iter"):
        np.testing.assert_allclose(got.diagnostics[name],
                                   np.asarray(want.diagnostics[name]),
                                   rtol=RUN_RTOL, err_msg=name)
    at = int(np.flatnonzero(perm == 7)[0])
    wbar = 1.0 / np.abs(Zb[:, perm])
    assert (np.argmin(got.diagnostics["weights_re"] / wbar, axis=1)
            == at).all()
