"""The port's DDT kernels, the DDT branch of construct_A, the Cole-Cole
basis and the DDT simulator against the JAX package (float64 on the CPU,
identical inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu import sim as jax_sim
from bayes_drt_tpu.ops import kernels as jax_kernels
from bayes_drt_tpu.ops.basis import cole_cole_rbf as jax_cole_cole_rbf
from bayes_drt_tpu.ops.matrices import construct_A as jax_construct_A
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.ops import kernels
from bayes_drt_tpu_torch.ops.basis import cole_cole_rbf
from bayes_drt_tpu_torch.ops.matrices import (construct_A, default_epsilon,
                                              get_tau_basis)

torch.set_num_threads(1)

ZD = [("transmissive", "planar"), ("blocking", "planar"),
      ("blocking", "spherical")]


def _points():
    """Complex x on both sides of |x^2| = 0.03 (the series / direct
    switch), at 0, near the switch, and with real parts past the tanh
    clip (|Re x| > 30)."""
    rng = np.random.default_rng(0)
    mags = np.concatenate([np.logspace(-4, 2, 40),
                           np.sqrt(0.03) * np.array([0.999, 1.001]), [45.0]])
    phases = rng.uniform(-np.pi / 2, np.pi / 2, mags.size)
    x = mags * np.exp(1j * phases)
    return np.concatenate([[0.0 + 0.0j], x, x * np.exp(1j * np.pi / 4)])


@pytest.mark.parametrize("bc,symmetry", ZD)
def test_zd_matches_jax(bc, symmetry):
    x = _points()
    small = np.abs(x * x) < 0.03
    assert small.sum() > 10 and (~small).sum() > 10
    want = np.asarray(jax_kernels.get_zd_func(bc, symmetry)(jnp.asarray(x)))
    got = kernels.get_zd_func(bc, symmetry)(torch.as_tensor(x)).numpy()
    assert got.dtype == np.complex128 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-300)
    # complex64 in, complex64 out, as jnp.result_type(arg, complex64)
    g32 = kernels.get_zd_func(bc, symmetry)(
        torch.as_tensor(x.astype(np.complex64)))
    assert g32.dtype == torch.complex64


def _grid(n=24):
    freq = np.logspace(3, -1, n)
    tau = get_tau_basis(freq, ppd=3)
    return freq, tau, default_epsilon(tau)


@pytest.mark.parametrize("dist_type", ["series", "parallel"])
@pytest.mark.parametrize("ct", [False, True])
@pytest.mark.parametrize("bc,symmetry", ZD)
def test_construct_A_ddt_matches_jax(bc, symmetry, dist_type, ct):
    freq, tau, eps = _grid()
    assert 15 <= len(tau) <= 20
    kw = dict(tau=tau, epsilon=eps, kernel="DDT", dist_type=dist_type,
              symmetry=symmetry, bc=bc, ct=ct, k_ct=2.5 if ct else None)
    for part in ("real", "imag"):
        want = np.asarray(jax_construct_A(freq, part, dtype=jnp.float64,
                                          **kw))
        got = construct_A(freq, part, dtype=torch.float64, device="cpu",
                          **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())


def test_construct_A_ddt_defaults_and_errors():
    """bc defaults to transmissive in construct_A (the mini-DSL's blocking
    default lives in fit_spectra_batch); ct needs k_ct; float32 runs in
    complex64 and stays near float64."""
    freq, tau, eps = _grid()
    kw = dict(tau=tau, epsilon=eps, kernel="DDT", dist_type="parallel")
    a = construct_A(freq, "imag", dtype=torch.float64, device="cpu", **kw)
    b = construct_A(freq, "imag", dtype=torch.float64, device="cpu",
                    bc="transmissive", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    a32 = construct_A(freq, "imag", dtype=torch.float32, device="cpu", **kw)
    assert a32.dtype == torch.float32
    np.testing.assert_allclose(a32.double().numpy(), a.numpy(), rtol=1e-4,
                               atol=1e-5 * float(a.abs().max()))
    with pytest.raises(ValueError, match="k_ct"):
        construct_A(freq, "real", ct=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="Invalid"):
        construct_A(freq, "real", bc="reflective", device="cpu", **kw)
    with pytest.raises(ValueError, match="dist_type"):
        construct_A(freq, "real", tau=tau, kernel="DRT", dist_type="parallel",
                    device="cpu")


def test_cole_cole_and_ddt_simulator_match_jax():
    """The basis (ops/basis.py and sim's numpy copy) and the Cole-Cole DDT
    impedance of both boundary conditions on one grid; the Series-Parallel
    check spectrum is its parts."""
    y = np.linspace(-20, 20, 401)
    want = np.asarray(jax_cole_cole_rbf(jnp.asarray(y), 0.8))
    np.testing.assert_allclose(cole_cole_rbf(torch.as_tensor(y), 0.8).numpy(),
                               want, rtol=1e-12)
    np.testing.assert_allclose(sim.cole_cole_rbf(y, 0.8), want, rtol=1e-12)
    freq = np.logspace(6, -2, 41)
    for bc in ("transmissive", "blocking"):
        np.testing.assert_allclose(
            sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc=bc),
            jax_sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc=bc), rtol=1e-10)
    np.testing.assert_allclose(
        sim.series_parallel_circuit(freq),
        1 + jax_sim.z_zarc(freq, 1, 1e-3, 0.8)
        + jax_sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc="transmissive"),
        rtol=1e-10)
