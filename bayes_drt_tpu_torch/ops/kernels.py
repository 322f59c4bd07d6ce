"""Impedance kernels for DRT and DDT distributions (torch port of
bayes_drt_tpu/ops/kernels.py).

DRT kernels take s = ln(omega*tau); DDT kernels evaluate the diffusion
impedance Z_D(x) of complex x in complex torch (complex128 for float64,
complex64 for float32), with the small-|x| series forms of the JAX
package behind the same guards, so no NaN comes from a discarded branch.
"""

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


# ---------------------------------------------------------------------------
# Diffusion impedances Z_D(x), x = sqrt(tau e^y (k_ct + j w)) (or
# sqrt(j w tau e^y)). Small-|x| forms are series in z = x^2.
# ---------------------------------------------------------------------------

_SMALL_Z = 0.03


def _tanh_clip(x):
    """tanh(x) with the real part clipped to +-30 (tanh is 1 there to
    machine precision; the clip keeps the complex evaluation finite)."""
    return torch.tanh(torch.complex(torch.clamp(x.real, -30.0, 30.0),
                                    x.imag))


# tanh(x)/x = sum c_k z^k, z = x^2
_TANH_COEF = (1.0, -1.0 / 3.0, 2.0 / 15.0, -17.0 / 315.0, 62.0 / 2835.0,
              -1382.0 / 155925.0, 21844.0 / 6081075.0)


def _T_series(z):
    """tanh(x)/x as a series in z = x^2 (|z| small)."""
    acc = torch.full_like(z, _TANH_COEF[-1])
    for c in _TANH_COEF[-2::-1]:
        acc = acc * z + c
    return acc


def _S_series(z):
    """(x - tanh(x))/x = 1 - tanh(x)/x as a series in z = x^2."""
    acc = torch.full_like(z, -_TANH_COEF[-1])
    for c in _TANH_COEF[-2:0:-1]:
        acc = acc * z - c
    return acc * z


def _guards(x):
    """(z, small, x_safe, z_safe): x_safe is 1 on the series branch and
    z_safe is _SMALL_Z where z == 0, so neither branch divides by 0."""
    z = x * x
    small = torch.abs(z) < _SMALL_Z
    x_safe = torch.where(small, torch.ones_like(x), x)
    z_safe = torch.where(torch.abs(z) == 0, torch.full_like(z, _SMALL_Z), z)
    return z, small, x_safe, z_safe


def zd_transmissive_planar(x):
    """Z_D = tanh(x)/x."""
    z, small, x_safe, _ = _guards(x)
    return torch.where(small, _T_series(z), _tanh_clip(x_safe) / x_safe)


def zd_blocking_planar(x):
    """Z_D = coth(x)/x = 1/(x tanh x)."""
    _, small, x_safe, z_safe = _guards(x)
    direct = 1.0 / (x_safe * _tanh_clip(x_safe))
    series = 1.0 / (z_safe * _T_series(z_safe))
    return torch.where(small, series, direct)


def zd_blocking_spherical(x):
    """Z_D = tanh(x)/(x - tanh(x))."""
    _, small, x_safe, z_safe = _guards(x)
    t = _tanh_clip(x_safe)
    direct = t / (x_safe - t)
    series = _T_series(z_safe) / _S_series(z_safe)
    return torch.where(small, series, direct)


_ZD_FUNCS = {
    ("blocking", "planar"): zd_blocking_planar,
    ("blocking", "spherical"): zd_blocking_spherical,
    ("transmissive", "planar"): zd_transmissive_planar,
}


def get_zd_func(bc: str, symmetry: str):
    try:
        return _ZD_FUNCS[(bc, symmetry)]
    except KeyError:
        raise ValueError(
            f"Invalid (bc={bc!r}, symmetry={symmetry!r}). Options: "
            "blocking/planar, blocking/spherical, transmissive/planar")


def ddt_kernel(y, omega, tau, part: str, dist_type: str, symmetry: str,
               bc: str, ct: bool = False, k_ct=None):
    """DDT kernel value (without the basis function factor), broadcast over
    real tensors y, omega, tau: x = sqrt(tau e^y (k_ct + j w)) when ``ct``
    else sqrt(j w tau e^y); series distributions integrate Z_D, parallel
    distributions Y_D = 1/Z_D."""
    zd_func = get_zd_func(bc, symmetry)
    te_y = tau * torch.exp(y)
    if ct:
        if k_ct is None:
            raise ValueError("k_ct must be supplied if ct==True")
        arg = te_y * torch.complex(torch.full_like(omega, float(k_ct)),
                                   omega)
    else:
        arg = torch.complex(torch.zeros_like(te_y), omega * te_y)
    zd = zd_func(torch.sqrt(arg))
    if dist_type == "parallel":
        val = 1.0 / zd
    elif dist_type == "series":
        val = zd
    else:
        raise ValueError(f"Invalid dist_type {dist_type!r}. Options are "
                         "series and parallel")
    if part == "real":
        return val.real
    if part == "imag":
        return val.imag
    raise ValueError(f"Invalid part {part!r}. Options are 'real' and 'imag'")
