"""DRT impedance kernels K(y, s), s = ln(omega*tau) (torch port of
bayes_drt_tpu/ops/kernels.py:16-39). The DDT kernels are not ported yet."""

from __future__ import annotations

import torch


def _stable_sech(u):
    """sech(u) = 2 e^{-|u|} / (1 + e^{-2|u|}), overflow-free for any real u."""
    e = torch.exp(-torch.abs(u))
    return 2.0 * e / (1.0 + e * e)


def drt_real_kernel(y, s):
    """Re kernel for a series DRT: 1 / (1 + e^{2(y+s)}), a logistic that
    never overflows."""
    u = y + s
    return 1.0 / (1.0 + torch.exp(2.0 * torch.clamp(u, -40.0, 40.0)))


def drt_imag_kernel(y, s):
    """Im kernel for a series DRT: -sech(y+s)/2."""
    return -0.5 * _stable_sech(y + s)
