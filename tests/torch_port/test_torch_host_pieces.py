"""The port's host pieces against the JAX package: the numpy MCMC
diagnostics, solve_nnls, the rest of sim.py, utils.py and the stage
timer (float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu import sim as jax_sim
from bayes_drt_tpu import utils as jax_utils
from bayes_drt_tpu.infer import diagnostics as jax_diag
from bayes_drt_tpu.infer import nnls as jax_nnls
from bayes_drt_tpu_torch import sim, utils
from bayes_drt_tpu_torch.infer import diagnostics, nnls
from bayes_drt_tpu_torch.profiling import StageTimer

# the host estimators are the same numpy code: 1e-12
DIAG_RTOL = 1e-12


def _draws(seed=0, c=3, n=60, d=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, n, d)).cumsum(axis=1) * 0.1
    return x + rng.standard_normal((c, 1, d))


@pytest.mark.parametrize("name", ["rhat", "ess", "rhat_rank", "ess_bulk",
                                  "ess_tail"])
def test_host_diagnostics_match_jax(name):
    for seed, n in ((0, 60), (1, 7), (2, 3)):
        x = _draws(seed, n=n)
        np.testing.assert_allclose(getattr(diagnostics, name)(x),
                                   getattr(jax_diag, name)(x),
                                   rtol=DIAG_RTOL)


def test_split_chains_e_bfmi_and_summary_match_jax():
    x = _draws(3)
    np.testing.assert_array_equal(diagnostics.split_chains(x),
                                  jax_diag.split_chains(x))
    energy = np.random.default_rng(4).standard_normal((3, 50)).cumsum(1)
    np.testing.assert_allclose(diagnostics.e_bfmi(energy),
                               jax_diag.e_bfmi(energy), rtol=DIAG_RTOL)
    np.testing.assert_allclose(diagnostics.e_bfmi(energy[0]),
                               jax_diag.e_bfmi(energy[0]), rtol=DIAG_RTOL)
    got, want = diagnostics.summary(x), jax_diag.summary(x)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=DIAG_RTOL,
                                   err_msg=k)


def test_solve_nnls_matches_jax():
    rng = np.random.default_rng(5)
    b, n, k = 4, 20, 9
    A = rng.standard_normal((b, n, k))
    P = np.einsum("bnk,bnl->bkl", A, A) + 1e-8 * np.eye(k)
    q = -np.einsum("bnk,bn->bk", A, rng.standard_normal((b, n)) + 0.3)
    got = nnls.solve_nnls(torch.as_tensor(P), torch.as_tensor(q))
    assert bool(got.converged.all())
    assert (got.x.numpy() >= 0).all()
    for i in range(b):
        want = jax_nnls.solve_nnls(jnp.asarray(P[i]), jnp.asarray(q[i]))
        np.testing.assert_allclose(got.x[i].numpy(), np.asarray(want.x),
                                   rtol=1e-9, atol=1e-12)
        assert np.array_equal(got.at_lb[i].numpy(), np.asarray(want.at_lb))
        assert int(got.n_iter[i]) == int(want.n_iter)


@pytest.mark.parametrize("model", ["Orazem", "Macdonald"])
def test_add_model_noise_is_the_jax_package_draw_for_draw(model):
    z = jax_sim.reference_circuit("2ZARC", np.logspace(5, -2, 36))
    got = sim.add_model_noise(z, 7, 0.01, 0.02, model)
    want = jax_sim.add_model_noise(z, 7, 0.01, 0.02, model)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="Invalid model"):
        sim.add_model_noise(z, 7, 0.01, 0.02, "Gaussian")


def test_hn_elements_match_jax():
    tau = np.logspace(-6, 2, 40)
    freq = np.logspace(5, -2, 30)
    for t0, alpha, beta in ((1e-3, 0.8, 1.0), (1e-2, 1.0, 0.7),
                            (1e-1, 0.5, 1.0), (3e-3, 0.6, 0.9)):
        np.testing.assert_allclose(sim.hn_drt(tau, t0, alpha, beta),
                                   jax_sim.hn_drt(tau, t0, alpha, beta),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(sim.z_hn(freq, 2.0, t0, alpha, beta),
                                   jax_sim.z_hn(freq, 2.0, t0, alpha, beta),
                                   rtol=1e-12)
    np.testing.assert_array_equal(sim.z_inductor(freq, 1e-6),
                                  jax_sim.z_inductor(freq, 1e-6))
    # HN with alpha = 1 is the ZARC
    np.testing.assert_allclose(sim.hn_drt(tau, 1e-3, 1.0, 0.8),
                               sim.zarc_drt(tau, 1e-3, 0.8), rtol=1e-10)


def test_utils_match_jax():
    x = np.array([1.23456789e-3, 9.87654321e5, 5.0, 7.7777777777e-9])
    np.testing.assert_array_equal(utils.rel_round(x, 4),
                                  jax_utils.rel_round(x, 4))
    for f in (np.logspace(5, -1, 31), np.array([1.0, 2.0, 10.0]),
              np.array([3.0])):
        assert utils.is_loguniform(f) == jax_utils.is_loguniform(f)
    nested = {"a": np.arange(3.0), "b": {"c": 1}}
    assert utils.check_equality(nested, {"a": np.arange(3.0), "b": {"c": 1}})
    assert not utils.check_equality(nested, {"a": np.arange(3.0),
                                             "b": {"c": 2}})
    y = np.random.default_rng(6).standard_normal(50)
    assert utils.get_outlier_thresh(y, 2.5) == jax_utils.get_outlier_thresh(
        y, 2.5)
    y_hat = y + 0.1
    w = np.linspace(0.5, 2.0, 50)
    for kw in ({}, {"weights": w}):
        assert utils.r2_score(y, y_hat, **kw) == jax_utils.r2_score(
            y, y_hat, **kw)
    z = np.array([1 + 1j, -2 - 0.5j])
    for g, w_ in zip(utils.polar_from_complex(z),
                     jax_utils.polar_from_complex(z)):
        np.testing.assert_array_equal(g, w_)
    assert utils.camel_case_split("ZarcDRTFit") == \
        jax_utils.camel_case_split("ZarcDRTFit")
    assert utils.is_number("1e-3") and not utils.is_number("x")


def test_stage_timer_accumulates():
    t = StageTimer("cpu")
    for _ in range(2):
        with t.stage("a"):
            sum(range(1000))
    with pytest.raises(RuntimeError):
        with t.stage("b"):
            raise RuntimeError("inside a stage")
    s = t.summary()
    assert set(s) == {"a", "b"} and all(v >= 0 for v in s.values())
