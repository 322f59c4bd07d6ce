"""A (impedance), L (differentiation) and M (integral penalty) matrices
(torch port of bayes_drt_tpu/ops/matrices.py).

Default quadrature matches the reference: trapezoid on y in [-20, 20] with
1000 points. ``construct_A`` evaluates the DRT rule through ops/quad.py,
whose wrapper runs the hand-written quadrature kernel on a CUDA device and
the plain einsum form on the CPU, and the DDT rule in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._numerics import resolve_device, resolve_dtype
from .basis import (gaussian_penalty_inner_product, gaussian_rbf,
                    gaussian_rbf_dy)
from .kernels import ddt_kernel
from .quad import drt_quad


def get_tau_basis(frequencies, extend_decades: float = 1.0, ppd: int = 10):
    """Default basis time constants: 10 points per decade spanning the
    measured range extended by one decade on each side."""
    frequencies = np.asarray(frequencies, dtype=float)
    tmin = np.log10(1.0 / (2.0 * np.pi * np.max(frequencies))) - extend_decades
    tmax = np.log10(1.0 / (2.0 * np.pi * np.min(frequencies))) + extend_decades
    num_decades = tmax - tmin
    return np.logspace(tmin, tmax, int(ppd * num_decades + 1))


def default_epsilon(tau) -> float:
    """Inverse RBF length scale = 1 / mean ln-tau spacing."""
    tau = np.asarray(tau, dtype=float)
    return float(1.0 / np.mean(np.diff(np.log(tau))))


def _quad_grid(n_points: int, y_max: float, dtype, device=None):
    """Trapezoid nodes and weights on the uniform grid [-y_max, y_max]."""
    y = torch.linspace(-y_max, y_max, n_points, dtype=dtype, device=device)
    h = 2.0 * y_max / (n_points - 1)
    w = torch.full((n_points,), h, dtype=dtype, device=device)
    w[0] = h / 2
    w[-1] = h / 2
    return y, w


def _omega_tau(frequencies, tau, dtype, device):
    freq = torch.as_tensor(np.ascontiguousarray(frequencies, float), dtype=dtype,
                           device=device)
    omega = 2.0 * math.pi * freq
    if tau is None:
        tau_t = 1.0 / omega
    else:
        tau_t = torch.as_tensor(np.ascontiguousarray(tau, float), dtype=dtype,
                                device=device)
    return omega, tau_t


def construct_A(frequencies, part, tau=None, basis: str = "gaussian",
                epsilon=1.0, kernel: str = "DRT", dist_type: str = "series",
                symmetry: str = "planar", bc=None, ct: bool = False,
                k_ct=None, n_quad: int = 1000, y_max: float = 20.0,
                dtype=None, device=None):
    """A matrix: A[n, m] = int phi(y) K(y, w_n, tau_m) dy, by the trapezoid
    rule on [-y_max, y_max] with the Gaussian basis. A' @ x and A'' @ x
    give the real/imag impedance (series) or admittance (parallel)
    contributions of the distribution.

    The series DRT runs through ops/quad.py:drt_quad (the hand-written
    kernel on a CUDA device, its plain einsum form on the CPU). A DDT
    (``symmetry``, ``bc`` -- transmissive by default -- and the charge
    transfer ``ct`` with ``k_ct``) is plain torch on the device: the (N, K,
    Q) complex integrand contracted with the trapezoid weights, as the JAX
    package builds it outside any Pallas kernel."""
    if basis != "gaussian":
        raise NotImplementedError(f"only the gaussian basis is ported "
                                  f"(got {basis!r})")
    if part not in ("real", "imag"):
        raise ValueError(f"Invalid part {part!r}")
    if ct and k_ct is None:
        raise ValueError("k_ct must be supplied if ct==True")
    dev = resolve_device(device)
    dt = resolve_dtype(torch.float64 if dtype is None else dtype)
    omega, tau_t = _omega_tau(frequencies, tau, dt, dev)
    y, w = _quad_grid(n_quad, y_max, dt, dev)
    phi = gaussian_rbf(y, float(epsilon))
    if kernel == "DRT":
        if dist_type != "series":
            raise ValueError("dist_type for DRT kernel must be series")
        s = torch.log(omega[:, None] * tau_t[None, :])
        return drt_quad(s, y, phi * w, part)
    if kernel != "DDT":
        raise ValueError(f"Invalid kernel {kernel!r}. Options are DRT and "
                         "DDT")
    f = ddt_kernel(y[None, None, :], omega[:, None, None],
                   tau_t[None, :, None], part, dist_type, symmetry,
                   "transmissive" if bc is None else bc, bool(ct),
                   0.0 if k_ct is None else k_ct)
    return torch.einsum("nkq,q->nk", phi * f, w)


def construct_L(frequencies, tau=None, basis: str = "gaussian", epsilon=1.0,
                order=1, dtype=None, device=None):
    """Differentiation matrix: (L @ x)[n] is the ``order``-th derivative of
    the distribution at collocation point 1/w_n (Gaussian basis)."""
    if basis != "gaussian":
        raise NotImplementedError(f"only the gaussian basis is ported "
                                  f"(got {basis!r})")
    dev = resolve_device(device)
    dt = resolve_dtype(torch.float64 if dtype is None else dtype)
    omega, tau_t = _omega_tau(frequencies, tau, dt, dev)
    y = -torch.log(omega[:, None] * tau_t[None, :])
    if isinstance(order, (list, tuple, np.ndarray)):
        order = tuple(float(o) for o in order)
    return gaussian_rbf_dy(y, float(epsilon), order)


def construct_M(frequencies, basis: str = "gaussian", order=1, epsilon=1.0,
                dtype=None, device=None):
    """Integral penalty matrix: x^T M x = int (d^k gamma/d ln tau^k)^2 d ln
    tau over basis centers tau_m = 1/w_m. ``order`` is 0, 1, 2 or a
    length-3 weight vector mixing the three."""
    if basis != "gaussian":
        raise ValueError(f"Invalid basis {basis!r} for M matrix")
    dev = resolve_device(device)
    dt = resolve_dtype(torch.float64 if dtype is None else dtype)
    omega, tau_t = _omega_tau(frequencies, None, dt, dev)
    eps = float(epsilon)
    a = eps * (-torch.log(omega[:, None] * tau_t[None, :]))
    if isinstance(order, (list, tuple, np.ndarray)):
        f0, f1, f2 = (float(o) for o in order)
        return (f0 * gaussian_penalty_inner_product(a, eps, 0)
                + f1 * gaussian_penalty_inner_product(a, eps, 1)
                + f2 * gaussian_penalty_inner_product(a, eps, 2))
    return gaussian_penalty_inner_product(a, eps, int(order))
