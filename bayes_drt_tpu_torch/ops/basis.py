"""Gaussian radial basis function in y = ln(tau/tau_m) space and its
derivatives (torch port of bayes_drt_tpu/ops/basis.py:14,45)."""

from __future__ import annotations

import torch


def gaussian_rbf(y, epsilon):
    """phi(y) = exp(-(eps*y)^2)."""
    return torch.exp(-((epsilon * y) ** 2))


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
