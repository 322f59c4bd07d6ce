"""A (impedance) and L (differentiation) matrices (torch port of
bayes_drt_tpu/ops/matrices.py).

Default quadrature matches the reference: trapezoid on y in [-20, 20] with
1000 points. ``construct_A`` evaluates the rule through ops/quad.py, whose
wrapper runs the hand-written quadrature kernel on a CUDA device and the
plain einsum form on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._numerics import resolve_device, resolve_dtype
from .basis import gaussian_rbf, gaussian_rbf_dy
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
                n_quad: int = 1000, y_max: float = 20.0, dtype=None,
                device=None):
    """A matrix: A[n, m] = int phi(y) K(y, w_n, tau_m) dy for a series DRT
    with the Gaussian basis (the only combination ported so far), by the
    trapezoid rule through ops/quad.py:drt_quad (the hand-written kernel
    on a CUDA device, its plain einsum form on the CPU)."""
    if kernel != "DRT" or dist_type != "series" or basis != "gaussian":
        raise NotImplementedError(
            "only the series DRT kernel with the gaussian basis is ported "
            f"(got kernel={kernel!r}, dist_type={dist_type!r}, "
            f"basis={basis!r})")
    if part not in ("real", "imag"):
        raise ValueError(f"Invalid part {part!r}")
    dev = resolve_device(device)
    dt = resolve_dtype(torch.float64 if dtype is None else dtype)
    omega, tau_t = _omega_tau(frequencies, tau, dt, dev)
    y, w = _quad_grid(n_quad, y_max, dt, dev)
    phiw = gaussian_rbf(y, float(epsilon)) * w
    s = torch.log(omega[:, None] * tau_t[None, :])
    return drt_quad(s, y, phiw, part)


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
