"""The port's equivalent-circuit fits (ecm.py) against the JAX
package's, float64 on the CPU, on the circuits of the JAX package's own
ECM tests (built with ``sim``)."""

import numpy as np
import pytest
import torch

from bayes_drt_tpu import ecm as jax_ecm
from bayes_drt_tpu_torch import ecm, sim

F64 = dict(device="cpu", dtype=torch.float64)
# element and circuit impedances: elementwise at 1e-12 of the largest |Z|
Z_TOL = 1e-12
# fitted log-parameters and chi-square: 1e-6 (relative; chi-square and
# cost also absolutely at 1e-20, where a noiseless fit leaves ~1e-31)
FIT_TOL = 1e-6

ALL_ELEMENTS = [("R", {"R": 0.5}), ("L", {"L": 1e-6}), ("C", {"C": 1e-3}),
                ("RC", {"R": 1.0, "tau": 1e-2}),
                ("ZARC", {"R": 2.0, "tau": 1e-3, "phi": 0.8}),
                ("Gerischer", {"R": 0.5, "tau": 1e-3}),
                ("HN", {"R": 1.0, "tau": 1e-4, "alpha": 0.8, "beta": 0.9})]


@pytest.mark.parametrize("element", [name for name, _ in ALL_ELEMENTS])
def test_ecm_impedance_matches_jax(element):
    # omega tau from ~1e-8 to ~1e9: the complex powers' branch on the
    # whole grid
    freq = np.logspace(9, -5, 57)
    circuit = [e for e in ALL_ELEMENTS if e[0] == element]
    want = np.asarray(jax_ecm.ecm_impedance(circuit, freq))
    got = ecm.ecm_impedance(circuit, freq, **F64).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=Z_TOL * np.abs(want).max())
    # and from a parameter vector (log scale for the positive scales)
    names, _, _, logs = ecm.ELEMENTS[element]
    x = np.array([np.log(circuit[0][1][k]) if lg else circuit[0][1][k]
                  for k, lg in zip(names, logs)]) + 0.01
    np.testing.assert_allclose(
        ecm.ecm_impedance(circuit, freq, x, **F64).numpy(),
        np.asarray(jax_ecm.ecm_impedance(circuit, freq, x)), rtol=0,
        atol=Z_TOL * np.abs(want).max())


def _two_zarc():
    freq = np.logspace(6, -2, 81)
    rng = np.random.default_rng(0)
    Z = sim.reference_circuit("2ZARC", freq) + 0.002 * (
        rng.standard_normal(81) + 1j * rng.standard_normal(81))
    circuit = [("R", {"R": 0.5}),
               ("ZARC", {"R": 0.5, "tau": 3e-3, "phi": 0.7}),
               ("ZARC", {"R": 0.5, "tau": 3e-2, "phi": 0.7})]
    return freq, Z, circuit


def _gerischer():
    freq = np.logspace(5, -1, 61)
    Z = sim.reference_circuit("Gerischer", freq)
    return freq, Z, [("R", {"R": 0.5}), ("Gerischer", {"R": 0.5,
                                                       "tau": 1e-3})]


@pytest.mark.parametrize("case,weights", [("2zarc", "modulus"),
                                          ("2zarc", "unity"),
                                          ("gerischer", "modulus")])
def test_fit_ecm_matches_jax(case, weights):
    freq, Z, circuit = _two_zarc() if case == "2zarc" else _gerischer()
    want = jax_ecm.fit_ecm(freq, Z, circuit, weights=weights)
    got = ecm.fit_ecm(freq, Z, circuit, weights=weights, **F64)
    np.testing.assert_allclose(got["x"], want["x"], rtol=FIT_TOL,
                               atol=FIT_TOL)
    np.testing.assert_allclose(got["chi_sq"], want["chi_sq"], rtol=FIT_TOL,
                               atol=1e-20)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=FIT_TOL,
                               atol=1e-20)
    np.testing.assert_allclose(got["Z_fit"], want["Z_fit"], rtol=FIT_TOL)
    assert [n for n, _ in got["circuit"]] == [n for n, _ in want["circuit"]]
    # the JAX package's own recovery gates (tests/test_ecm.py)
    params = [p for _, p in got["circuit"]]
    if case == "2zarc" and weights == "modulus":
        assert abs(params[0]["R"] - 1.0) < 0.05
        taus = sorted([params[1]["tau"], params[2]["tau"]])
        assert abs(np.log10(taus[0] / 1e-3)) < 0.2
        assert abs(np.log10(taus[1] / 1e-2)) < 0.2
        assert got["chi_sq"] < 1e-4
    elif case == "gerischer":
        assert abs(params[1]["tau"] - 1e-2) / 1e-2 < 0.1
        assert abs(params[0]["R"] - 1.0) < 0.02


def test_estimate_hfr_matches_jax_exactly():
    freq = np.logspace(6, -2, 81)
    with_l = sim.reference_circuit("ZARC", freq) + 1j * 2 * np.pi * freq * 1e-7
    without = sim.reference_circuit("ZARC", freq)
    for Z in (with_l, without, with_l[::-1]):
        f = freq if Z is not with_l[::-1] else freq[::-1]
        assert ecm.estimate_hfr(f, Z) == jax_ecm.estimate_hfr(f, Z)
    assert abs(ecm.estimate_hfr(freq, with_l) - 1.0) < 0.05


def test_ecm_errors():
    freq, Z, circuit = _gerischer()
    with pytest.raises(ValueError, match="Invalid weights"):
        ecm.fit_ecm(freq, Z, circuit, weights="bogus", **F64)
    with pytest.raises(ValueError, match="Unknown element"):
        ecm.ecm_impedance([("Q", {"Q": 1.0})], freq, **F64)
