"""The port's Inverter.ridge_fit against the JAX package's Inverter, option
by option, and the predictions and score from the same fits (float64 on
the CPU)."""

import warnings

import numpy as np
import pytest
import torch

from bayes_drt_tpu import Inverter as JaxInverter
from bayes_drt_tpu_torch import Inverter, sim

torch.set_num_threads(1)

# the ridge fits: coefficients within 1e-8 of the largest
RIDGE_TOL = 1e-8
# but with the hyper-a update, whose golden-section search resolves the
# shape a only to ~sqrt(eps) (a flat objective at its minimum): 1e-7
HYPER_A_TOL = 1e-7
# the Re-Im CV errors: sums of squared held-out residuals of fits held at
# 1e-8
CV_RTOL = 1e-7
# the predictions and score from matching fits
PRED_RTOL = 1e-10

FREQ = np.logspace(5, -1, 31)
Z = sim.add_model_noise(sim.reference_circuit("ZARC", FREQ), 3, 0.005,
                        0.005, "Macdonald")[0]
IE_RANGE = np.repeat([0, 1, 2], [11, 10, 10])

CASES = {
    "default": {},
    "huang": dict(preset="Huang"),
    "ciucci_cv": dict(preset="Ciucci", cv_lambdas=np.logspace(-8, 3, 12)),
    "part_real": dict(part="real"),
    "part_imag": dict(part="imag"),
    "L1": dict(L1_penalty=0.1),
    "dZ": dict(dZ=True, dZ_power=0.6),
    "hyper_a_b": dict(hyper_a=True, hyper_b=True),
    "lm": dict(hl_solution="lm"),
    "hyper_weights": dict(hyper_lambda=False, hyper_weights=True,
                          hw_beta=3, hw_wbar="modulus"),
    "ordinary": dict(hyper_lambda=False, lambda_0=0.1),
    "x0": dict(x0=np.full(83, 0.01)),
    "cholesky": dict(penalty="cholesky"),
    "reg_ord_mixed": dict(penalty="integral", reg_ord=[0.2, 0.3, 0.5],
                          hl_beta=5, nonneg=False, weights="Orazem"),
    "no_inductance": dict(fit_inductance=False),
}


def _pair(case, distributions=None):
    kw = dict(CASES[case]) if case in CASES else {}
    fi = kw.pop("fit_inductance", True)
    a = JaxInverter(fit_inductance=fi, distributions=distributions)
    b = Inverter(fit_inductance=fi, distributions=distributions,
                 device="cpu", dtype=torch.float64)
    return a, b, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_ridge_fit_matches_jax(case):
    a, b, kw = _pair(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.ridge_fit(FREQ, Z, **kw)
        b.ridge_fit(FREQ, Z, **kw)
    tol = HYPER_A_TOL if kw.get("hyper_a") else RIDGE_TOL
    ca = a.distribution_fits["DRT"]["coef"]
    cb = b.distribution_fits["DRT"]["coef"]
    scale = np.abs(ca).max()
    np.testing.assert_allclose(cb, ca, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(b.R_inf, a.R_inf, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(b.inductance, a.inductance, rtol=tol,
                               atol=tol * abs(a.inductance) + 1e-30)
    assert b.fit_type == a.fit_type == "ridge"
    for key in ("lambda_vectors", "weights"):
        if key in a.distribution_fits["DRT"]:
            v = np.asarray(a.distribution_fits["DRT"][key])
            np.testing.assert_allclose(b.distribution_fits["DRT"][key], v,
                                       rtol=tol, atol=tol * np.abs(v).max())
    if case == "ciucci_cv":
        for key in ("recv", "imcv", "totcv"):
            np.testing.assert_allclose(b.cv_result[key],
                                       a.cv_result[key].values, rtol=CV_RTOL)


@pytest.mark.parametrize("init_phase_offset", [False, True])
def test_phase_offset_correction_matches_jax(init_phase_offset):
    """Phase offsets of 2 and -1.5 degrees on two current ranges. The
    alternation stops once the offsets move less than xtol = 1e-3 degrees
    and scipy's BFGS meets an L1 kink at zero, so the two packages agree
    to the stopping rule, not to the ridge's 1e-8: offsets within 10 xtol
    and coefficients within 1e-2 of the largest; the port's final fit is
    its own ridge fit of its adjusted data at 1e-12."""
    off = np.where(IE_RANGE == 1, 2.0, np.where(IE_RANGE == 2, -1.5, 0.0))
    z = np.abs(Z) * np.exp(1j * np.radians(np.angle(Z, deg=True) + off))
    a, b, _ = _pair(None)
    kw = dict(correct_phase_offset=True, IERange=IE_RANGE,
              init_phase_offset=init_phase_offset)
    a.ridge_fit(FREQ, z, **kw)
    b.ridge_fit(FREQ, z, **kw)
    np.testing.assert_allclose(b.phase_offsets, a.phase_offsets, atol=1e-2)
    ca = a.distribution_fits["DRT"]["coef"]
    cb = b.distribution_fits["DRT"]["coef"]
    np.testing.assert_allclose(cb, ca, atol=1e-2 * np.abs(ca).max())
    c = Inverter(device="cpu", dtype=torch.float64)
    c.ridge_fit(FREQ, b.Z_adjusted)
    np.testing.assert_allclose(cb, c.distribution_fits["DRT"]["coef"],
                               rtol=1e-12, atol=1e-12 * np.abs(cb).max())


@pytest.mark.parametrize("bc", ["blocking", "transmissive"])
def test_parallel_ddt_admittance_ridge_matches_jax(bc):
    """A single parallel DDT fits the admittance, rescaled so that Z, not
    Y, is the scaled variable. Rp is held for the transmissive DDT (a
    blocking DDT's low-frequency impedance grows without bound)."""
    dists = {"DDT": {"kernel": "DDT", "bc": bc,
                     "basis_freq": np.logspace(6, -3, 46)}}
    z = 1 + sim.z_ddt_cole_cole(FREQ, 0.1, 0.8, bc=bc)
    z = sim.add_simple_noise(z, 4, 0.003)[0]
    a, b, _ = _pair(None, dists)
    kw = dict(penalty="integral", lambda_0=1, hl_beta=5, weights="modulus")
    a.ridge_fit(FREQ, z, **kw)
    b.ridge_fit(FREQ, z, **kw)
    ca = a.distribution_fits["DDT"]["coef"]
    np.testing.assert_allclose(b.distribution_fits["DDT"]["coef"], ca,
                               rtol=RIDGE_TOL,
                               atol=RIDGE_TOL * np.abs(ca).max())
    assert b.R_inf == a.R_inf == 0.0
    np.testing.assert_allclose(b.predict_Z(FREQ), a.predict_Z(FREQ),
                               rtol=PRED_RTOL)
    if bc == "transmissive":
        np.testing.assert_allclose(b.predict_Rp(), a.predict_Rp(),
                                   rtol=PRED_RTOL)


@pytest.fixture(scope="module")
def huang_pair():
    a, b, kw = _pair("huang")
    a.ridge_fit(FREQ, Z, **kw)
    b.ridge_fit(FREQ, Z, **kw)
    return a, b


def test_predictions_and_score_match_jax(huang_pair):
    """Z at the training grid, a subset of it and a new grid, gamma on a
    new tau grid, Rp, and both scores, at 1e-10."""
    a, b = huang_pair
    f_new = np.logspace(4, -2, 17)
    for f in (FREQ, np.sort(FREQ)[::-1][:12], f_new):
        np.testing.assert_allclose(b.predict_Z(f), a.predict_Z(f),
                                   rtol=PRED_RTOL)
        np.testing.assert_allclose(
            b.predict_Z(f, include_offsets=False),
            a.predict_Z(f, include_offsets=False), rtol=PRED_RTOL)
    tau = np.logspace(-7, 2, 50)
    np.testing.assert_allclose(b.predict_distribution("DRT", eval_tau=tau),
                               a.predict_distribution("DRT", eval_tau=tau),
                               rtol=PRED_RTOL, atol=1e-14)
    np.testing.assert_allclose(b.predict_Rp(), a.predict_Rp(),
                               rtol=PRED_RTOL)
    for metric in ("chi_sq", "r2"):
        for part in ("both", "real", "imag"):
            np.testing.assert_allclose(
                b.score(FREQ, Z, metric=metric, part=part),
                a.score(FREQ, Z, metric=metric, part=part), rtol=PRED_RTOL)
    # the quick-start figures of the JAX package's test_inverter.py
    tau_b = b.distributions["DRT"]["tau"]
    g = b.predict_distribution()
    truth = sim.zarc_drt(tau_b, 1e-3, 0.8)
    assert np.sqrt(np.mean((g - truth) ** 2)) < 0.05
    assert np.median(np.abs(b.predict_Z(FREQ) - Z) / np.abs(Z)) < 0.02
    assert b.score(FREQ, Z, metric="r2") > 0.99


def test_ridge_fit_validation_errors():
    inv = Inverter(device="cpu")
    bad = [dict(preset="Smith"), dict(hl_beta=1.0),
           dict(penalty="integral", hl_beta=2.0), dict(penalty="L2"),
           dict(hyper_weights=True), dict(hl_solution="newton"),
           dict(correct_phase_offset=True), dict(part="both_parts")]
    for kw in bad:
        with pytest.raises(ValueError):
            inv.ridge_fit(FREQ, Z, **kw)
    multi = Inverter(distributions={"a": {"kernel": "DRT"},
                                    "b": {"kernel": "DDT"}}, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        multi.ridge_fit(FREQ, Z)
    with pytest.raises(ValueError, match="Length"):
        inv.ridge_fit(FREQ[:-1], Z)
    with pytest.raises(ValueError):
        Inverter(distributions={"bad": {"kernel": "XYZ"}}, device="cpu")
    with pytest.raises(ValueError, match="k_ct"):
        Inverter(distributions={"d": {"kernel": "DDT", "ct": True}},
                 device="cpu")
    with pytest.warns(UserWarning):
        Inverter(distributions={"d": {"kernel": "DRT",
                                      "dist_type": "parallel"}},
                 device="cpu")


_W = np.random.default_rng(8).uniform(0.5, 2.0, len(FREQ))
WEIGHTS = {"none": None, "unity": "unity", "modulus": "modulus",
           "Orazem": "Orazem", "proportional": "proportional",
           "prop_adj": "prop_adj", "float": 2.5, "int": 3, "complex": 1 + 2j,
           "real_array": _W, "complex_array": _W + 0.5j * _W[::-1],
           "complex_array_real_valued": _W + 0j}


@pytest.mark.parametrize("part", ["both", "real", "imag"])
@pytest.mark.parametrize("name", list(WEIGHTS))
def test_format_weights_matches_jax(name, part):
    """Every weights option of one spectrum, for each part, equals the
    JAX package's Inverter._format_weights exactly (both numpy)."""
    w = WEIGHTS[name]
    got = Inverter(device="cpu")._format_weights(FREQ, Z, w, part)
    want = JaxInverter()._format_weights(FREQ, Z, w, part)
    np.testing.assert_array_equal(got, want)


def test_format_weights_errors():
    for args in (("nope", "both"), (np.ones(3), "both"), (None, "neither")):
        for inv in (Inverter(device="cpu"), JaxInverter()):
            with pytest.raises(ValueError):
                inv._format_weights(FREQ, Z, *args)
