"""Radial basis functions in y = ln(tau/tau_m) space (Gaussian, Cole-Cole
and Zic), the Gaussian's derivatives and its penalty inner products
(torch port of bayes_drt_tpu/ops/basis.py)."""

from __future__ import annotations

import math

import torch


def gaussian_rbf(y, epsilon):
    """phi(y) = exp(-(eps*y)^2)."""
    return torch.exp(-((epsilon * y) ** 2))


def cole_cole_rbf(y, epsilon):
    """Cole-Cole basis: sin(u) / (2 pi (cosh(eps y) - cos(u))), u = (1 -
    eps) pi."""
    u = (1.0 - epsilon) * math.pi
    return (1.0 / (2.0 * math.pi)) * math.sin(u) / (torch.cosh(epsilon * y)
                                                    - math.cos(u))


def zic_rbf(y, epsilon=None):
    """Zic basis: 2 e^y / (1 + e^{2y}) = sech(y); ``epsilon`` is unused."""
    del epsilon
    return 1.0 / torch.cosh(y)


_BASES = {"gaussian": gaussian_rbf, "Cole-Cole": cole_cole_rbf,
          "Zic": zic_rbf}


def get_basis_func(basis: str = "gaussian"):
    try:
        return _BASES[basis]
    except KeyError:
        raise ValueError(f"Invalid basis {basis!r}. Options are "
                         f"{sorted(_BASES)}") from None


def gaussian_rbf_dy(y, epsilon, order):
    """n-th derivative of the Gaussian RBF w.r.t. y.

    ``order`` is an int in {0,1,2,3}, a length-3 weight vector mixing the
    0th/1st/2nd derivatives, or a fractional scalar in (0,1) or (1,2) that
    linearly interpolates neighbouring integer orders."""
    e2 = epsilon ** 2
    g = torch.exp(-(e2 * y * y))

    def d(n):
        if n == 0:
            return g
        if n == 1:
            return -2.0 * e2 * y * g
        if n == 2:
            return (-2.0 * e2 + 4.0 * e2 * e2 * y * y) * g
        if n == 3:
            return (12.0 * e2 * e2 * y - 8.0 * e2 ** 3 * y ** 3) * g
        raise ValueError("order must be between 0 and 3")

    if isinstance(order, (list, tuple)):
        f0, f1, f2 = order
        return f0 * d(0) + f1 * d(1) + f2 * d(2)
    if isinstance(order, int) or float(order).is_integer():
        return d(int(order))
    order = float(order)
    if 0.0 < order < 1.0:
        return (1.0 - order) * d(0) + order * d(1)
    if 1.0 < order < 2.0:
        return (2.0 - order) * d(1) + (order - 1.0) * d(2)
    raise ValueError("order must be between 0 and 3")


def gaussian_penalty_inner_product(a, epsilon, order: int):
    """Closed-form integral int phi_n^(k) phi_m^(k) dy for Gaussian RBFs.

    ``a = epsilon * ln(1/(w_n * tau_m))`` is the scaled log-distance between
    basis centers. Returns the entries of the M (integral penalty) matrix
    such that x^T M x = int (d^k gamma / d ln tau^k)^2 d ln tau."""
    root = math.sqrt(math.pi / 2.0)
    g = torch.exp(-(a * a) / 2.0)
    if order == 0:
        return root / epsilon * g
    if order == 1:
        return -root * epsilon * (-1.0 + a * a) * g
    if order == 2:
        return root * epsilon ** 3 * (3.0 - 6.0 * a * a + a ** 4) * g
    raise ValueError(f"Invalid order {order} (must be 0, 1, or 2)")
