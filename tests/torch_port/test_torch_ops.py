"""The port's A/L matrices and quadrature against the JAX package (float64
on the CPU, where the quadrature wrapper runs its plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.ops.matrices import construct_A as jax_construct_A
from bayes_drt_tpu.ops.matrices import construct_L as jax_construct_L
from bayes_drt_tpu.ops.pallas_quad import construct_A_drt_pallas
from bayes_drt_tpu.parallel.batch import _build_shared as jax_build_shared
from bayes_drt_tpu_torch.ops import quad
from bayes_drt_tpu_torch.ops.matrices import (construct_A, construct_L,
                                              default_epsilon, get_tau_basis)
from bayes_drt_tpu_torch.parallel.batch import _build_shared

torch.set_num_threads(1)


def _grid(n=41):
    freq = np.logspace(6, -2, n)
    tau = get_tau_basis(freq)
    return freq, tau, default_epsilon(tau)


@pytest.mark.parametrize("part", ["real", "imag"])
def test_construct_A_matches_jax(part):
    freq, tau, eps = _grid()
    ref = np.asarray(jax_construct_A(freq, part, tau=tau, epsilon=eps,
                                     dtype=jnp.float64))
    got = construct_A(freq, part, tau=tau, epsilon=eps, dtype=torch.float64,
                      device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_construct_L_matches_jax(order):
    freq, tau, eps = _grid()
    f_coll = 1.0 / (2 * np.pi * tau)
    ref = np.asarray(jax_construct_L(f_coll, tau=tau, epsilon=eps,
                                     order=order, dtype=jnp.float64))
    got = construct_L(f_coll, tau=tau, epsilon=eps, order=order,
                      dtype=torch.float64, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("part,dtype,rtol", [
    ("real", torch.float64, 1e-10), ("imag", torch.float64, 1e-10),
    ("real", torch.float32, 2e-4), ("imag", torch.float32, 2e-4)])
def test_quad_plain_matches_pallas_interpret(part, dtype, rtol):
    freq, tau, eps = _grid()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = np.asarray(construct_A_drt_pallas(freq, part, tau=tau, epsilon=eps,
                                            dtype=jdt, interpret=True),
                     np.float64)
    got = quad.construct_A_drt_quad(freq, part, tau=tau, epsilon=eps,
                                    dtype=dtype, device="cpu")
    assert got.dtype == dtype
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=rtol,
                               atol=1e-12 if dtype == torch.float64 else 1e-5)


def test_quad_wrapper_routes_cpu_to_plain():
    freq, tau, eps = _grid(11)
    s = torch.log(2 * np.pi * torch.as_tensor(freq)[:, None]
                  * torch.as_tensor(tau)[None, :])
    y = torch.linspace(-20, 20, 100, dtype=torch.float64)
    phiw = torch.exp(-(eps * y) ** 2) * (40.0 / 99)
    before = quad.drt_quad.launches
    out = quad.drt_quad(s, y, phiw, "imag")
    assert quad.drt_quad.launches == before
    torch.testing.assert_close(out, quad.drt_quad_plain(s, y, phiw, "imag"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="Invalid part"):
        quad.drt_quad(s, y, phiw, "both")


@pytest.mark.parametrize("ncp,nonneg", [(True, False), (False, True)])
def test_build_shared_matches_jax(ncp, nonneg):
    freq = np.logspace(5, -1, 31)
    _, tau_j, eps_j, cfg_j, data_j, _ = jax_build_shared(
        freq, mode="sample", ncp=ncp, nonneg=nonneg, dtype=jnp.float64)
    _, tau, eps, cfg, data, _ = _build_shared(freq, ncp=ncp, nonneg=nonneg,
                                           dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tau, tau_j, rtol=1e-14)
    assert eps == pytest.approx(eps_j, rel=1e-14)
    assert (cfg.ncp, cfg.nonneg, cfg.dists[0].K) == (
        cfg_j.ncp, cfg_j.nonneg, cfg_j.dists[0].K)
    for name in ("target", "freq", "sigma_min", "ups_alpha", "ups_beta",
                 "induc_scale", "lik_mask"):
        np.testing.assert_allclose(getattr(data, name).numpy(),
                                   np.asarray(getattr(data_j, name)),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(data.A[0].numpy(), np.asarray(data_j.A[0]),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(data.L[0].numpy(), np.asarray(data_j.L[0]),
                               rtol=1e-10, atol=1e-10)


def test_construct_A_rejects_unported_kernels():
    freq, tau, eps = _grid(11)
    for kernel in ("DRT", "DDT"):
        with pytest.raises(ValueError, match="Invalid basis"):
            construct_A(freq, "real", tau=tau, kernel=kernel, basis="box",
                        device="cpu")
    with pytest.raises(ValueError, match="Invalid kernel"):
        construct_A(freq, "real", tau=tau, kernel="RQ", device="cpu")


def test_top_level_exports_match_jax():
    """The port's top level carries every name of the JAX package's
    ``__all__`` (the matrix builders, the basis lookup, the version), the
    builders the port's own ops functions, which agree with the JAX
    package's through the top level."""
    import bayes_drt_tpu
    import bayes_drt_tpu_torch
    from bayes_drt_tpu_torch.ops import basis, matrices
    assert set(bayes_drt_tpu.__all__) <= set(bayes_drt_tpu_torch.__all__)
    for name in bayes_drt_tpu_torch.__all__:
        assert hasattr(bayes_drt_tpu_torch, name), name
    assert bayes_drt_tpu_torch.__version__ == bayes_drt_tpu.__version__
    for name in ("construct_A", "construct_L", "construct_M",
                 "get_tau_basis"):
        assert getattr(bayes_drt_tpu_torch, name) is getattr(matrices, name)
    assert bayes_drt_tpu_torch.get_basis_func is basis.get_basis_func
    freq, tau, eps = _grid(21)
    np.testing.assert_allclose(
        bayes_drt_tpu_torch.get_tau_basis(freq),
        np.asarray(bayes_drt_tpu.get_tau_basis(freq)), rtol=1e-14)
    np.testing.assert_allclose(
        bayes_drt_tpu_torch.construct_A(freq, "imag", tau=tau, epsilon=eps,
                                        dtype=torch.float64,
                                        device="cpu").numpy(),
        np.asarray(bayes_drt_tpu.construct_A(freq, "imag", tau=tau,
                                             epsilon=eps,
                                             dtype=jnp.float64)),
        rtol=1e-10, atol=1e-13)
