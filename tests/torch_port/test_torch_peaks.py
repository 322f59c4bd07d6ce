"""The port's HN peak fits (peaks.py) and the Inverter's peak methods
against the JAX package's, float64 on the CPU (the JAX side with x64 on,
as its own tests run it)."""

import jax
import numpy as np
import pytest
import torch

from bayes_drt_tpu import Inverter as JaxInverter
from bayes_drt_tpu import peaks as jax_peaks
from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu_torch import Inverter, peaks, sim
from bayes_drt_tpu_torch import inverter as inverter_module

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
# the HN analytics and the residual vector: 1e-12 of the largest entry
HN_TOL = 1e-12
# fitted peak parameters (equal peak counts): within 1e-6
FIT_TOL = 1e-6

TAU = np.logspace(-8, 2, 101)
X_TRUE = np.array([1.0, np.log(1e-4), 1.0, 0.8,
                   2.0, np.log(1e-1), 1.0, 0.7])
# a third, small peak leaning on the second: a shoulder of it
X_SHOULDER = np.concatenate([X_TRUE, [0.25, np.log(3e-3), 0.9, 0.9]])


@pytest.mark.parametrize("t0,alpha,beta", [(1e-3, 1.0, 0.8),
                                           (1e-3, 0.9, 0.85),
                                           (1e-6, 0.5, 1.0),
                                           (10.0, 0.7, 0.35)])
def test_hn_functions_match_jax(t0, alpha, beta):
    tau = np.logspace(-12, 6, 181)
    # omega t0 from 1e-12 to 1e9
    freq = np.logspace(9, -6, 151) / (2 * np.pi) / t0 * 1e-3
    want = np.asarray(jax_peaks.HN_distribution(tau, t0, alpha, beta))
    got = peaks.HN_distribution(tau, t0, alpha, beta, **F64).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HN_TOL * np.abs(want).max())
    want = np.asarray(jax_peaks.HN_impedance(freq, t0, alpha, beta))
    got = peaks.HN_impedance(freq, t0, alpha, beta, **F64).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HN_TOL * np.abs(want).max())


def test_evaluate_and_residuals_match_jax():
    freq = np.logspace(7, -4, 60)
    want = np.asarray(jax_peaks.evaluate_fit_distribution(X_SHOULDER, TAU))
    got = peaks.evaluate_fit_distribution(X_SHOULDER, TAU, **F64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HN_TOL * want.max())
    want = np.asarray(jax_peaks.evaluate_fit_impedance(X_TRUE, freq, 0.3,
                                                       1e-6))
    got = peaks.evaluate_fit_impedance(X_TRUE, freq, 0.3, 1e-6, **F64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=HN_TOL * np.abs(want).max())
    gamma = np.asarray(jax_peaks.evaluate_fit_distribution(X_TRUE, TAU))
    w = 1.0 / (gamma + 0.05)
    x = X_TRUE * 1.01
    want = np.asarray(jax_peaks.peak_fit_residuals(x, TAU, gamma, 3.0, w,
                                                   0.5, 0.01))
    got = peaks.peak_fit_residuals(x, TAU, gamma, 3.0, w, 0.5, 0.01,
                                   **F64).numpy()
    assert got.shape == want.shape == (101 + 2 + 2 + 1,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HN_TOL * np.abs(want).max())
    assert peaks.evaluate_fit_distribution([], TAU, **F64).shape == (101,)
    with pytest.raises(ValueError, match="multiple of 4"):
        peaks.evaluate_fit_distribution(X_TRUE[:5], TAU, **F64)


def _assert_same_peaks(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=FIT_TOL, atol=FIT_TOL)


@pytest.mark.parametrize("case", ["two", "shoulders", "chi_sq",
                                  "negative"])
def test_fit_peaks_matches_jax(case):
    x_true = X_SHOULDER if case == "shoulders" else X_TRUE
    gamma = np.asarray(jax_peaks.evaluate_fit_distribution(x_true, TAU))
    kw = {"shoulders": dict(check_shoulders=True),
          "chi_sq": dict(check_chi_sq=True, chi_sq_thresh=1e-6,
                         chi_sq_delta=0.0, R_rthresh=0.2),
          "negative": dict(nonneg=False), "two": {}}[case]
    if case == "negative":
        # a negative lobe below the first peak
        gamma = gamma - 0.6 * np.asarray(jax_peaks.evaluate_fit_distribution(
            [1.0, np.log(1e-6), 1.0, 0.9], TAU))
    want = jax_peaks.fit_peaks(TAU, gamma, 3.0, **kw)
    got = peaks.fit_peaks(TAU, gamma, 3.0, **kw, **F64)
    _assert_same_peaks(got, want)
    if case == "two":
        # the JAX package's own recovery gate (tests/test_peaks.py)
        t0 = np.sort(np.exp(got[1::4]))
        assert abs(np.log10(t0[0] / 1e-4)) < 0.3
        assert abs(np.log10(t0[1] / 1e-1)) < 0.3
    if case == "negative":
        assert (got[::4] < 0).any()


def test_fit_pos_peaks_weights_and_errors():
    gamma = np.asarray(jax_peaks.evaluate_fit_distribution(X_TRUE, TAU))
    w = np.linspace(1.0, 2.0, len(TAU))
    _assert_same_peaks(peaks.fit_pos_peaks(TAU, gamma, 3.0, weights=w, **F64),
                       jax_peaks.fit_pos_peaks(TAU, gamma, 3.0, weights=w))
    assert len(peaks.fit_pos_peaks(TAU, np.zeros(101), 3.0, **F64)) == 0
    with pytest.raises(ValueError, match="same length"):
        peaks.fit_pos_peaks(TAU, gamma[:-1], 3.0, **F64)
    with pytest.raises(ValueError, match="Length of weights"):
        peaks.fit_pos_peaks(TAU, gamma, 3.0, weights=w[:-1], **F64)


def test_constrained_peak_fit_and_fit_data_match_jax():
    gamma = np.asarray(jax_peaks.evaluate_fit_distribution(X_TRUE, TAU))
    want = jax_peaks.constrained_peak_fit(TAU, gamma, [2e-4, 5e-2], 3.0,
                                          nonneg=True)
    got = peaks.constrained_peak_fit(TAU, gamma, [2e-4, 5e-2], 3.0,
                                     nonneg=True, **F64)
    _assert_same_peaks(got["x"], want["x"])
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=FIT_TOL)
    t0 = np.sort(np.exp(got["x"][1::4]))
    assert abs(np.log10(t0[0] / 1e-4)) < 0.5
    assert abs(np.log10(t0[1] / 1e-1)) < 0.5

    freq = np.logspace(5, -2, 50)
    Z = sim.add_simple_noise(
        1.0 + np.asarray(jax_peaks.evaluate_fit_impedance(X_TRUE, freq)), 2,
        0.005)[0]
    x0 = X_TRUE * np.array([1.1, 1.0, 0.95, 1.05] * 2)
    # the weight forms that differ in kind: unity, a modulus form and the
    # percentile-adjusted proportional one
    for weights in (None, "modulus", "prop_adj"):
        want = jax_peaks.fit_data(x0, freq, Z, R_inf=1.0, weights=weights)
        got = peaks.fit_data(x0, freq, Z, R_inf=1.0, weights=weights, **F64)
        _assert_same_peaks(got["x"], want["x"])
        np.testing.assert_allclose(got["cost"], want["cost"], rtol=FIT_TOL)
    with pytest.raises(ValueError, match="Invalid weights"):
        peaks.fit_data(x0, freq, Z, weights="bogus", **F64)


# ---- the Inverter's peak methods ----

# the JAX package's peak workflow test fits 2ZARC with Macdonald noise at
# 0.25% (a reference data file); here the same from sim on a 41-point grid
PK_FREQ = np.logspace(5, -1, 41)
PK_Z = sim.add_model_noise(sim.reference_circuit("2ZARC", PK_FREQ), 3,
                           0.0025, 0.0025, "Macdonald")[0]


@pytest.fixture(scope="module")
def fits():
    """A MAP fit of a noisy 2ZARC spectrum in each package, the port from
    the JAX package's own start. The two optima need not be one (4000
    L-BFGS iterations amplify last-bit differences across this
    posterior's optima; MAP parity is test_torch_inverter_fit's), so the
    peak methods are held on one fit and the gates on the port's own."""
    a = JaxInverter()
    a.fit(PK_FREQ, PK_Z, init_from_ridge=True, random_seed=0)
    cfg, data = a._posterior
    start = {k: np.array(v) for k, v in jax_init(
        cfg, data, jax.random.PRNGKey(0),
        init_values=a._init_params).items()}

    def jax_start(cfg, data, gen, batch_shape=(), init_values=None):
        return {k: torch.as_tensor(v, dtype=data.freq.dtype).expand(
            tuple(batch_shape) + v.shape).clone() for k, v in start.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inverter_module, "init_unconstrained", jax_start)
        b = Inverter(**F64)
        b.fit(PK_FREQ, PK_Z, init_from_ridge=True, random_seed=0)
    return a, b


def _peak_state(inv):
    f = inv.distribution_fits["DRT"]
    return f["peak_params"], f["peak_chi_sq"]


def test_inverter_peak_methods_match_jax(fits):
    """Each peak method on the same fit in both packages (the JAX MAP fit,
    loaded into the port: the peak fits amplify the ~1e-6 gap of two MAP
    optima ~40-fold), then the JAX package's peak workflow gates on the
    port's own MAP fit. The distribution dips below zero, so fit_peaks
    takes its joint positive/negative solve; with ``check_chi_sq`` its
    extra peak makes that solve stop unconverged on this spectrum (lam
    past 1e11 in the port, at gradient norm 2e-4 in the JAX package), its
    iterates parting at rounding level, so that option is held on the
    well-posed cases of test_fit_peaks_matches_jax."""
    a, own = fits
    b = Inverter(**F64)
    b.load_fit_data(a.save_fit_data())
    eval_tau = b.distributions["DRT"]["tau"]
    for call in (lambda inv: inv.fit_peaks(),
                 lambda inv: inv.fit_peaks_constrained([1e-3, 1e-2]),
                 lambda inv: inv.fit_peaks(fit_data=True,
                                           frequencies=PK_FREQ, Z=PK_Z)):
        call(a)
        call(b)
        (xa, ca), (xb, cb) = _peak_state(a), _peak_state(b)
        _assert_same_peaks(xb, xa)
        np.testing.assert_allclose(cb, ca, rtol=FIT_TOL)
        for k in ("num_peaks", "chi_sq", "R", "tau_0", "alpha", "beta"):
            np.testing.assert_allclose(b.extract_peak_info()[k],
                                       a.extract_peak_info()[k],
                                       rtol=FIT_TOL, atol=FIT_TOL)
        np.testing.assert_allclose(b.predict_peak_Z(PK_FREQ),
                                   a.predict_peak_Z(PK_FREQ), rtol=FIT_TOL)
        np.testing.assert_allclose(
            b.predict_peak_distribution(eval_tau=eval_tau, peak_index=0),
            a.predict_peak_distribution(eval_tau=eval_tau, peak_index=0),
            rtol=FIT_TOL, atol=FIT_TOL)
        np.testing.assert_allclose(b.score_peak_fit(), a.score_peak_fit(),
                                   rtol=FIT_TOL)
    # the JAX package's peak workflow gates (tests/test_peaks.py)
    b = own
    b.fit_peaks()
    info = b.extract_peak_info()
    assert abs(np.sum(info["R"]) - 2.0) < 0.3
    assert 1e-4 < info["tau_0"][np.argmax(np.abs(info["R"]))] < 1e-1
    g_peaks = b.predict_peak_distribution(eval_tau=eval_tau)
    g_drt = b.predict_distribution()
    assert np.max(np.abs(g_peaks - g_drt)) < 0.3 * np.max(g_drt)
    z_peaks = b.predict_peak_Z(PK_FREQ)
    assert np.median(np.abs(z_peaks - PK_Z) / np.abs(PK_Z)) < 0.05
    with pytest.raises(ValueError, match="fit_data==True"):
        b.fit_peaks(fit_data=True)
