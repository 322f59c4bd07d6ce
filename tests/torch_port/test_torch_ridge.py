"""The port's integral penalty matrix, box QP and batched ridge against
the JAX package (float64 on the CPU unless stated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer import nnls as jax_nnls
from bayes_drt_tpu.infer import ridge as jax_ridge
from bayes_drt_tpu.ops.matrices import construct_M as jax_construct_M
from bayes_drt_tpu.parallel.batch import \
    ridge_fit_spectra_batch as jax_ridge_batch
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import nnls, ridge
from bayes_drt_tpu_torch.ops.matrices import construct_M
from bayes_drt_tpu_torch.parallel import ridge_fit_spectra_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("order", [0, 1, 2, (0.2, 0.5, 0.3)])
def test_construct_M_matches_jax(order):
    f_coll = 1.0 / (2 * np.pi * np.logspace(-7, 2, 91))
    eps = 1.3
    got = construct_M(f_coll, order=list(order) if isinstance(order, tuple)
                      else order, epsilon=eps, device="cpu").numpy()
    want = np.asarray(jax_construct_M(
        f_coll, order=list(order) if isinstance(order, tuple) else order,
        epsilon=eps, dtype=jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def _spd_batch(seed, b=5, k=12, n=20, cond_cols=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, n, k))
    if cond_cols:
        A = A * np.logspace(-3, 3, k)[None, None, :]
    P = np.einsum("bnk,bnl->bkl", A, A) + 1e-8 * np.eye(k)
    q = -np.einsum("bnk,bn->bk", A, rng.standard_normal((b, n)) + 0.5)
    return P, q


def _extreme_columns(rng_seed=42):
    # the f32 regression shape of tests/test_nnls.py:95: column scales over
    # six orders of magnitude
    rng = np.random.default_rng(rng_seed)
    n, k = 80, 50
    A = np.abs(rng.standard_normal((n, k)))
    x_true = np.abs(rng.standard_normal(k)) * (rng.uniform(size=k) > 0.4)
    b = A @ x_true + 0.01 * rng.standard_normal(n)
    P = A.T @ A + 1e-10 * np.eye(k)
    q = -A.T @ b
    s = np.logspace(-3, 3, k)
    return (s[:, None] * P * s[None, :])[None], (s * q)[None]


QP_CASES = {
    "spd_nonneg": lambda: (*_spd_batch(0), np.zeros(12), np.full(12, np.inf)),
    "spd_mixed_bounds": lambda: (*_spd_batch(1), np.linspace(-0.5, 0.0, 12),
                                 np.linspace(0.2, 1.0, 12)),
    "spd_wide_scales": lambda: (*_spd_batch(2, cond_cols=True), np.zeros(12),
                                np.full(12, np.inf)),
    "f32_extreme_columns": lambda: (*_extreme_columns(), np.zeros(50),
                                    np.full(50, np.inf)),
}


@pytest.mark.parametrize("case", sorted(QP_CASES))
def test_solve_qp_box_matches_jax(case):
    P, q, lb, ub = QP_CASES[case]()
    f32 = case.startswith("f32")
    np_dt, t_dt = ((np.float32, torch.float32) if f32
                   else (np.float64, torch.float64))
    got = nnls.solve_qp_box(torch.as_tensor(P, dtype=t_dt),
                            torch.as_tensor(q, dtype=t_dt),
                            torch.as_tensor(lb, dtype=t_dt),
                            torch.as_tensor(ub, dtype=t_dt))
    assert bool(got.converged.all())
    rtol = 1e-4 if f32 else 1e-9
    for i in range(P.shape[0]):
        want = jax_nnls.solve_qp_box(jnp.asarray(P[i], np_dt),
                                     jnp.asarray(q[i], np_dt),
                                     jnp.asarray(lb, np_dt),
                                     jnp.asarray(ub, np_dt))
        assert np.array_equal(got.at_lb[i].numpy(), np.asarray(want.at_lb))
        assert np.array_equal(got.at_ub[i].numpy(), np.asarray(want.at_ub))
        assert int(got.n_iter[i]) == int(want.n_iter)
        x = got.x[i].numpy()
        np.testing.assert_allclose(x, np.asarray(want.x), rtol=rtol,
                                   atol=rtol * np.abs(x).max())


def test_qp_cold_sets_and_warm_start_match_jax():
    P, q = _spd_batch(3)
    lb, ub = np.zeros(12), np.full(12, np.inf)
    t = [torch.as_tensor(a) for a in (P, q, lb, ub)]
    cold = nnls.qp_cold_sets(*t)
    res = nnls.solve_qp_box(*t, warm_sets=cold)
    for i in range(P.shape[0]):
        a = [jnp.asarray(v) for v in (P[i], q[i], lb, ub)]
        c_j = jax_nnls.qp_cold_sets(*a)
        assert np.array_equal(cold[0][i].numpy(), np.asarray(c_j[0]))
        r_j = jax_nnls.solve_qp_box(*a, warm_sets=c_j)
        np.testing.assert_allclose(res.x[i].numpy(), np.asarray(r_j.x),
                                   rtol=1e-9, atol=1e-12)
        assert int(res.n_iter[i]) == int(r_j.n_iter)


def test_run_hyper_lambda_rows_equal_single_jax_fits():
    """Rows stop at different iterations (xtol met at different times);
    each row equals its own JAX fit."""
    rng = np.random.default_rng(5)
    b, n, k = 4, 30, 14
    WA_re = np.abs(rng.standard_normal((b, n, k)))
    WA_im = np.abs(rng.standard_normal((b, n, k)))
    scale = np.array([1.0, 3.0, 10.0, 30.0])[:, None]
    WT_re = rng.uniform(0.5, 2.0, (b, n)) * scale
    WT_im = rng.uniform(0.5, 2.0, (b, n)) * scale
    L = rng.standard_normal((3, k - 2, k - 2))
    L_ops = np.concatenate([np.zeros((3, k - 2, 2)), L], axis=2)
    L2 = np.einsum("nik,nil->nkl", L_ops, L_ops)
    shared = dict(L2_base=L2, L_ops=L_ops, L1_vec=np.zeros(k),
                  reg_frac=np.array([0.3, 0.3, 0.4]), lb=np.zeros(k),
                  ub=np.full(k, np.inf))
    cfg_kw = dict(part="both", penalty="discrete", n_fixed=2, max_iter=12)
    data = ridge.RidgeData(**{f: torch.as_tensor(v) for f, v in dict(
        WA_re=WA_re, WA_im=WA_im, WT_re=WT_re, WT_im=WT_im,
        **shared).items()})
    res = ridge.run_hyper_lambda(ridge.HyperLambdaConfig(**cfg_kw), data,
                                 torch.full((k,), 1e-6),
                                 torch.full((3,), 3.0), 0.1, xtol=1e-6)
    iters = []
    for i in range(b):
        d_j = jax_ridge.RidgeData(
            WA_re=jnp.asarray(WA_re[i]), WA_im=jnp.asarray(WA_im[i]),
            WT_re=jnp.asarray(WT_re[i]), WT_im=jnp.asarray(WT_im[i]),
            **{f: jnp.asarray(v) for f, v in shared.items()})
        r_j = jax_ridge.run_hyper_lambda(
            jax_ridge.HyperLambdaConfig(**cfg_kw), d_j, jnp.full(k, 1e-6),
            jnp.full(3, 3.0), 0.1, xtol=1e-6)
        iters.append(int(r_j.n_iter))
        assert int(res.n_iter[i]) == int(r_j.n_iter)
        np.testing.assert_allclose(res.coef[i].numpy(), np.asarray(r_j.coef),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(res.cost[i].numpy(), np.asarray(r_j.cost),
                                   rtol=1e-8)
    assert len(set(iters)) > 1, iters


RIDGE_CASES = {
    "integral_hyper": dict(penalty="integral", hyper_lambda=True,
                           lambda_0=1.0, hl_beta=5),
    "discrete_hyper": dict(penalty="discrete", hyper_lambda=True),
    "integral_ordinary": dict(penalty="integral", hyper_lambda=False),
    "discrete_ordinary_mixed": dict(penalty="discrete", hyper_lambda=False,
                                    nonneg=False, reg_ord=[0.2, 0.5, 0.3],
                                    weights="Orazem"),
}


@pytest.mark.parametrize("case", sorted(RIDGE_CASES))
def test_ridge_fit_spectra_batch_matches_jax(case):
    kw = RIDGE_CASES[case]
    freq, Zb = sim.make_benchmark_batch(4, freq=np.logspace(5, -1, 31),
                                        noise_level=0.003, seed=3)
    got = ridge_fit_spectra_batch(freq, Zb, dtype=torch.float64,
                                  device="cpu", **kw)
    want = jax_ridge_batch(freq, Zb, dtype=jnp.float64, **kw)
    np.testing.assert_array_equal(got.diagnostics["n_iter"],
                                  np.asarray(want.diagnostics["n_iter"]))
    np.testing.assert_allclose(got.tau, want.tau, rtol=1e-14)
    for name in ("coef", "r_inf", "inductance", "z_scales"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-8 * np.abs(got.coef).max(),
                                   err_msg=name)


def test_ridge_unported_options_raise():
    """The options that raised until the ridge options were ported now
    run and match the JAX package (the cross-validation and hyper-weights
    modes at 1e-8 of the largest coefficient; every HyperLambdaConfig
    option is held in test_torch_ridge_options.py); combining
    hyper_lambda with hyper_weights still raises."""
    freq, Zb = sim.make_benchmark_batch(2, freq=np.logspace(5, -1, 21))
    for kw in (dict(cv_lambdas=[0.1, 1.0]),
               dict(hyper_lambda=False, hyper_weights=True)):
        got = ridge_fit_spectra_batch(freq, Zb, dtype=torch.float64,
                                      device="cpu", **kw)
        want = jax_ridge_batch(freq, Zb, dtype=jnp.float64, **kw)
        np.testing.assert_allclose(got.coef, np.asarray(want.coef),
                                   rtol=1e-8,
                                   atol=1e-8 * np.abs(got.coef).max())
    with pytest.raises(ValueError, match="cannot be"):
        ridge_fit_spectra_batch(freq, Zb, hyper_weights=True, device="cpu")
    for name in ("use_dZ", "use_hyper_a", "use_hyper_b", "use_fbeta",
                 "use_lm"):
        assert getattr(ridge.HyperLambdaConfig(**{name: True}), name)
