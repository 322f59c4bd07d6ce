"""Equivalent-circuit model (ECM) fitting (port of bayes_drt_tpu/ecm.py).

Circuits are sums of the elements of ``sim`` (R, L, C, RC, ZARC,
Gerischer, HN) fit directly to impedance data with the bounded
Levenberg-Marquardt solver of infer/lsq.py, in torch on the device and in
the dtype the caller names (CUDA and float32 unless named). Each
element's impedance is written in real arithmetic, its complex powers in
polar form on the principal branch.

A circuit is a list of (element, init_params) pairs, summed in series:

    circuit = [("R", {"R": 1.0}),
               ("ZARC", {"R": 1.0, "tau": 1e-3, "phi": 0.8}),
               ("L", {"L": 1e-7})]
    result = fit_ecm(freq, Z, circuit)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._numerics import resolve_device, resolve_dtype
from .infer.lsq import bounded_lm
from .peaks import _placement, _t, hn_impedance_parts

# element -> (param names, lower bounds, upper bounds, log-scale flags)
ELEMENTS = {
    "R": (("R",), (0.0,), (np.inf,), (True,)),
    "L": (("L",), (0.0,), (np.inf,), (True,)),
    "C": (("C",), (0.0,), (np.inf,), (True,)),
    "RC": (("R", "tau"), (0.0, 0.0), (np.inf, np.inf), (True, True)),
    "ZARC": (("R", "tau", "phi"), (0.0, 0.0, 0.0), (np.inf, np.inf, 1.0),
             (True, True, False)),
    "Gerischer": (("R", "tau"), (0.0, 0.0), (np.inf, np.inf), (True, True)),
    "HN": (("R", "tau", "alpha", "beta"), (0.0, 0.0, 0.0, 0.0),
           (np.inf, np.inf, 1.0, 1.0), (True, True, False, False)),
}


def _element_z(name, params, omega):
    """(Re, Im) of one element's impedance at angular frequencies
    ``omega`` (a tensor); ``params`` in the element's order."""
    zero = torch.zeros_like(omega)
    if name == "R":
        return params[0] + zero, zero
    if name == "L":
        return zero, omega * params[0]
    if name == "C":
        return zero, -1.0 / (omega * params[0])
    if name == "RC":
        wt = omega * params[1]
        den = 1.0 + wt * wt
        return params[0] / den, -params[0] * wt / den
    if name == "ZARC":
        re, im = hn_impedance_parts(omega, params[1], 1.0, params[2])
        return params[0] * re, params[0] * im
    if name == "Gerischer":
        # 1 / sqrt(1 + j omega tau) on the principal branch
        wt = omega * params[1]
        mod = (1.0 + wt * wt) ** -0.25
        ang = 0.5 * torch.atan2(wt, torch.ones_like(wt))
        return (params[0] * mod * torch.cos(ang),
                -params[0] * mod * torch.sin(ang))
    if name == "HN":
        re, im = hn_impedance_parts(omega, params[1], params[2], params[3])
        return params[0] * re, params[0] * im
    raise ValueError(f"Unknown element {name!r}. Options: {sorted(ELEMENTS)}")


def _circuit_parts(circuit, omega, x=None):
    re = torch.zeros_like(omega)
    im = torch.zeros_like(omega)
    idx = 0
    for name, init in circuit:
        if name not in ELEMENTS:
            raise ValueError(f"Unknown element {name!r}. Options: "
                             f"{sorted(ELEMENTS)}")
        names, _, _, logs = ELEMENTS[name]
        if x is None:
            params = [omega.new_tensor(float(init[k])) for k in names]
        else:
            params = []
            for is_log in logs:
                v = x[idx]
                params.append(torch.exp(v) if is_log else v)
                idx += 1
        zr, zi = _element_z(name, params, omega)
        re, im = re + zr, im + zi
    return re, im


def ecm_impedance(circuit, freq, x=None, *, device=None, dtype=None):
    """Impedance of a series-connected circuit, a complex tensor. ``x``
    optionally overrides the flattened parameter vector (log-scale for
    positive-scale params)."""
    dev, dt = _placement((freq, x), device, dtype)
    omega = 2 * math.pi * _t(freq, dev, dt)
    re, im = _circuit_parts(circuit, omega,
                            None if x is None else _t(x, dev, dt))
    return torch.complex(re, im)


def fit_ecm(freq, Z, circuit, weights="modulus", max_iter=300, *,
            device=None, dtype=None):
    """Fit a series equivalent circuit to impedance data.

    Returns dict with per-element fitted parameters, the impedance residual,
    and chi-square (numpy and floats). Positive-scale parameters are
    optimized in log space.
    """
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    freq = np.asarray(freq, float)
    Z = np.asarray(Z)
    x0, lb, ub = [], [], []
    for name, init in circuit:
        names, lbs, ubs, logs = ELEMENTS[name]
        for k, lo, hi, is_log in zip(names, lbs, ubs, logs):
            v = float(init[k])
            if is_log:
                x0.append(np.log(max(v, 1e-12)))
                lb.append(-30.0)
                ub.append(30.0)
            else:
                x0.append(v)
                lb.append(lo)
                ub.append(hi)
    x0, lb, ub = map(np.asarray, (x0, lb, ub))

    if weights == "modulus":
        w = 1.0 / np.abs(Z)
    elif weights in (None, "unity"):
        w = np.ones(len(Z))
    else:
        raise ValueError(f"Invalid weights {weights!r}")
    w_t = _t(np.concatenate([w, w]), dev, dt)
    z_flat = _t(np.concatenate([Z.real, Z.imag]), dev, dt)
    omega = _t(2 * np.pi * freq, dev, dt)

    def residuals(x):
        zr, zi = _circuit_parts(circuit, omega, x)
        return (torch.cat([zr, zi]) - z_flat) * w_t

    res = bounded_lm(residuals, _t(x0, dev, dt)[None], lb, ub,
                     max_iter=max_iter)
    x = res.x[0].double().cpu().numpy()

    fitted = []
    idx = 0
    for name, init in circuit:
        names, _, _, logs = ELEMENTS[name]
        params = {}
        for k, is_log in zip(names, logs):
            params[k] = float(np.exp(x[idx]) if is_log else x[idx])
            idx += 1
        fitted.append((name, params))

    z_fit = ecm_impedance(circuit, freq, x, device=dev,
                          dtype=torch.float64).cpu().numpy()
    chi_sq = float(np.sum((np.abs(z_fit - Z) * w) ** 2) / len(freq))
    return {"circuit": fitted, "x": x, "Z_fit": z_fit, "chi_sq": chi_sq,
            "cost": float(res.cost[0])}


def estimate_hfr(freq, Z):
    """High-frequency resistance estimate: interpolate Z' at the Z''=0
    crossing, or extrapolate from the highest frequencies (legacy
    eis_utils HFR estimation). Host numpy."""
    freq = np.asarray(freq, float)
    Z = np.asarray(Z)
    order = np.argsort(freq)[::-1]
    zi = Z.imag[order]
    zr = Z.real[order]
    sign_change = np.where(np.diff(np.sign(zi)) != 0)[0]
    if len(sign_change):
        i = sign_change[0]
        t = -zi[i] / (zi[i + 1] - zi[i])
        return float(zr[i] + t * (zr[i + 1] - zr[i]))
    return float(zr[0])
