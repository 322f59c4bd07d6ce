"""Havriliak-Negami peak fitting of recovered distributions (port of
bayes_drt_tpu/peaks.py, the reference's peak-fit engine).

Peak detection (``scipy.signal.find_peaks`` and its control logic) stays
on the host; the HN analytics, the residuals and the bounded
Levenberg-Marquardt solver (infer/lsq.py) run in torch on the device and
in the dtype the caller names (``device``, ``dtype``: CUDA and float32
unless named), or on a tensor argument's. Complex powers are written in
polar form on the principal branch, the branch ``jnp``'s complex power
takes, so everything traced is real.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._numerics import resolve_device, resolve_dtype
from .infer.lsq import bounded_lm


def _placement(args, device, dtype):
    """(device, dtype) of the first tensor among ``args``, else the named
    (default: CUDA, float32)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device, a.dtype
    return resolve_device(device), resolve_dtype(dtype)


def _t(a, dev, dt):
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dt)
    return torch.as_tensor(np.array(a, dtype=float), device=dev).to(dt)


# --- HN analytics (reference: peak_fit.py:7-33) ----------------------------

def HN_distribution(tau, t0, alpha, beta, *, device=None, dtype=None):
    """Analytical DRT of a Havriliak-Negami relaxation, a tensor. alpha=1:
    ZARC; beta=1: Cole-Davidson; alpha=0.5, beta=1: Gerischer."""
    dev, dt = _placement((tau, t0, alpha, beta), device, dtype)
    tau, t0, alpha, beta = (_t(a, dev, dt) for a in (tau, t0, alpha, beta))
    r = (tau / t0) ** beta
    theta = torch.atan2(torch.sin(math.pi * beta),
                        r + torch.cos(math.pi * beta))
    return ((1.0 / math.pi) * (tau / t0) ** (beta * alpha)
            * torch.sin(alpha * theta)
            / (1.0 + 2.0 * torch.cos(math.pi * beta) * r + r ** 2)
            ** (alpha / 2.0))


def hn_impedance_parts(omega, t0, alpha, beta):
    """(Re, Im) of 1 / (1 + (j omega t0)^beta)^alpha for omega t0 > 0:
    (j omega t0)^beta = (omega t0)^beta e^{j beta pi/2}, and the outer
    power on the principal branch, |1 + w|^-alpha e^{-j alpha arg(1+w)}."""
    m = (omega * t0) ** beta
    re = 1.0 + m * torch.cos(0.5 * math.pi * beta)
    im = m * torch.sin(0.5 * math.pi * beta)
    mod = (re * re + im * im) ** (-0.5 * alpha)
    ang = alpha * torch.atan2(im, re)
    return mod * torch.cos(ang), -mod * torch.sin(ang)


def HN_impedance(freq, t0, alpha, beta, *, device=None, dtype=None):
    """Complex HN impedance 1 / (1 + (j 2 pi f t0)^beta)^alpha, a
    tensor."""
    dev, dt = _placement((freq, t0, alpha, beta), device, dtype)
    freq, t0, alpha, beta = (_t(a, dev, dt) for a in (freq, t0, alpha, beta))
    re, im = hn_impedance_parts(2 * math.pi * freq, t0, alpha, beta)
    return torch.complex(re, im)


def _fit_distribution(x, tau):
    n_peaks = x.shape[0] // 4
    if n_peaks == 0:
        return torch.zeros_like(tau)
    p = x.reshape(n_peaks, 4)
    gammas = torch.stack([p[i, 0] * HN_distribution(tau, torch.exp(p[i, 1]),
                                                    p[i, 2], p[i, 3])
                          for i in range(n_peaks)])
    return gammas.sum(dim=0)


def evaluate_fit_distribution(x, tau, *, device=None, dtype=None):
    """Sum of HN peaks on ``tau``; x packs (R, ln t0, alpha, beta) per
    peak. A tensor."""
    dev, dt = _placement((x, tau), device, dtype)
    x, tau = _t(x, dev, dt), _t(tau, dev, dt)
    if x.shape[0] % 4 != 0:
        raise ValueError("Number of parameters must be a multiple of 4")
    return _fit_distribution(x, tau)


def _fit_impedance_parts(x, omega, R_inf, inductance):
    re = torch.zeros_like(omega)
    im = torch.zeros_like(omega)
    p = x.reshape(-1, 4)
    for i in range(p.shape[0]):
        zr, zi = hn_impedance_parts(omega, torch.exp(p[i, 1]), p[i, 2],
                                    p[i, 3])
        re = re + p[i, 0] * zr
        im = im + p[i, 0] * zi
    return re + R_inf, im + inductance * omega


def evaluate_fit_impedance(x, freq, R_inf=0.0, inductance=0.0, *,
                           device=None, dtype=None):
    """Impedance of the HN peaks plus R_inf and the inductance. A complex
    tensor."""
    dev, dt = _placement((x, freq), device, dtype)
    x, freq = _t(x, dev, dt), _t(freq, dev, dt)
    if x.shape[0] % 4 != 0:
        raise ValueError("Number of parameters must be a multiple of 4")
    re, im = _fit_impedance_parts(x, 2 * math.pi * freq, float(R_inf),
                                  float(inductance))
    return torch.complex(re, im)


# --- residuals & solve (reference: peak_fit.py:68-73) ----------------------

def peak_fit_residuals(x, tau, gamma, Rp, weights, l1_penalty, l2_penalty,
                       *, device=None, dtype=None):
    """Stacked HN-fit residual vector: weighted distribution misfit, L1/L2
    penalties on peak magnitudes, and the Rp-match residual
    (reference: peak_fit.py:68-73). ``_solve_peaks`` drives the LM solver
    through this same function."""
    dev, dt = _placement((x, tau, gamma, weights), device, dtype)
    x, Rp = _t(x, dev, dt), float(Rp)
    resid = (_fit_distribution(x, _t(tau, dev, dt))
             - _t(gamma, dev, dt)) * _t(weights, dev, dt)
    R_vals = x[::4]
    l1 = torch.sqrt(torch.abs(R_vals / Rp)) * l1_penalty
    l2 = (R_vals / Rp) * l2_penalty
    rp_resid = 2.0 * (torch.sum(R_vals) - Rp) / Rp
    return torch.cat([resid, l1, l2, rp_resid[None]])


def _lm(residuals, x0, lb, ub, dev, dt, max_iter=300):
    """One bounded LM solve from ``x0`` (numpy), its result on the host."""
    res = bounded_lm(residuals, _t(x0, dev, dt)[None], lb, ub,
                     max_iter=max_iter)
    return res.x[0].double().cpu().numpy(), float(res.cost[0])


def _solve_peaks(tau, gamma, Rp, x0, lb, ub, weights, l1_penalty, l2_penalty,
                 dev, dt):
    tau_t, gamma_t, w_t = (_t(a, dev, dt) for a in (tau, gamma, weights))

    def residuals(x):
        return peak_fit_residuals(x, tau_t, gamma_t, Rp, w_t, l1_penalty,
                                  l2_penalty)

    return _lm(residuals, x0, lb, ub, dev, dt)[0]


def filter_peaks(x, rthresh, Rp):
    """Drop peaks with |R|/Rp below threshold (reference:
    peak_fit.py:386-398)."""
    x = np.asarray(x)
    keep = np.abs(x[::4] / Rp) >= rthresh
    return x.reshape(-1, 4)[keep].ravel()


def _default_weights(gamma, min_weight_deno=None):
    if min_weight_deno is None:
        min_weight_deno = max(np.percentile(gamma, 80), np.max(gamma) / 50)
    return 1.0 / (gamma + min_weight_deno)


def fit_pos_peaks(tau, gamma, Rp, weights=None, check_shoulders=False,
                  prom_rthresh=0.001, R_rthresh=0.005, check_chi_sq=False,
                  chi_sq_thresh=0.4, chi_sq_delta=0.2, min_weight_deno=None,
                  l1_penalty=0, l2_penalty=0.01, *, device=None, dtype=None):
    """Detect and fit positive HN peaks (reference: peak_fit.py:131-317).
    Returns the fitted (R, ln t0, alpha, beta) per peak, numpy."""
    # imported here: scipy.signal takes seconds to import, which every
    # process importing the package (each CLI command) would pay
    from scipy.signal import find_peaks
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    tau = np.asarray(tau, float)
    gamma = np.asarray(gamma, float)
    if len(tau) != len(gamma):
        raise ValueError("tau and gamma must have same length")

    peaks, properties = find_peaks(gamma, width=1,
                                   prominence=prom_rthresh * Rp)
    if len(peaks) == 0:
        return np.array([])

    def init_params(peak_list, width_list, base=None):
        base = np.array([]) if base is None else np.asarray(base)
        x0 = np.zeros(len(base) + 4 * len(peak_list))
        x0[:len(base)] = base
        n0 = len(base) // 4
        for i, (peak, width) in enumerate(zip(peak_list, width_list)):
            start = max(int(peak - width), 0)
            end = min(int(peak + width), len(tau))
            R = np.trapezoid(gamma[start:end], np.log(tau[start:end]))
            if R <= 0:
                R = gamma[peak]
            x0[4 * (n0 + i):4 * (n0 + i) + 4] = [R, np.log(tau[peak]), 0.99,
                                                 0.8]
        return x0

    def bounds_for(x0, lntau_window=0.25):
        n = len(x0) // 4
        lb = np.zeros_like(x0)
        ub = np.zeros_like(x0)
        for i in range(n):
            log_t0 = x0[4 * i + 1]
            lb[4 * i:4 * i + 4] = [0, log_t0 - lntau_window, 0, 0]
            ub[4 * i:4 * i + 4] = [np.inf, log_t0 + lntau_window, 1, 1]
        return lb, ub

    if weights is None:
        weights = _default_weights(gamma, min_weight_deno)
    elif len(weights) != len(gamma):
        raise ValueError("Length of weights must match length of gamma")

    def solve(x0, lb, ub):
        return _solve_peaks(tau, gamma, Rp, x0, lb, ub, weights, l1_penalty,
                            l2_penalty, dev, dt)

    def fit_dist(params):
        return _fit_distribution(_t(params, dev, dt),
                                 _t(tau, dev, dt)).double().cpu().numpy()

    x0 = init_params(peaks, properties["widths"])
    lb, ub = bounds_for(x0)
    x = solve(x0, lb, ub)
    x_filter = filter_peaks(x, R_rthresh, Rp)

    if check_shoulders and len(x_filter) > 0:
        # shoulders show up as peaks of the first derivative
        # (reference: peak_fit.py:198-266)
        gamma_fit = fit_dist(x)
        dg = np.diff(gamma)
        pos_peaks, _ = find_peaks(dg)
        neg_peaks, _ = find_peaks(-dg)
        if len(pos_peaks) and len(neg_peaks):
            if neg_peaks[0] < pos_peaks[0]:
                pos_peaks = np.insert(pos_peaks, 0, 0)
            if pos_peaks[-1] > neg_peaks[-1]:
                neg_peaks = np.append(neg_peaks, len(tau) - 1)
            new_peaks, new_widths = [], []
            if len(pos_peaks) == len(neg_peaks):
                for pos, neg in zip(pos_peaks, neg_peaks):
                    in_interval = np.where((pos <= peaks) & (peaks <= neg))[0]
                    if len(in_interval) == 0 and neg > pos:
                        new_idx = pos + int(np.argmax(
                            (gamma - gamma_fit)[pos:neg]))
                        new_peaks.append(new_idx)
                        new_widths.append(max(neg - pos, 1))
            if new_peaks:
                x0 = init_params(new_peaks, new_widths, base=x_filter)
                lb, ub = bounds_for(x0)
                x = solve(x0, lb, ub)
                x_filter = filter_peaks(x, R_rthresh, Rp)

    if check_chi_sq and len(x_filter) > 0:
        # chi_sq-triggered extra peak (reference: peak_fit.py:268-316)
        def chi_sq_of(params):
            resid = fit_dist(params) - gamma
            return float(np.sum((resid * weights) ** 2))

        chi_sq = chi_sq_of(x_filter)
        if chi_sq > chi_sq_thresh:
            gamma_fit = fit_dist(x_filter)
            peak = int(np.argmax(gamma - gamma_fit))
            R = np.trapezoid(gamma - gamma_fit, np.log(tau))
            if R <= 0:
                R = gamma[peak]
            x0 = np.concatenate([x_filter, [R, np.log(tau[peak]), 0.99, 0.8]])
            lb, ub = bounds_for(x0)
            # new peak's tau may move anywhere within the grid
            lb[-3] = np.log(tau.min())
            ub[-3] = np.log(tau.max())
            x_new = filter_peaks(solve(x0, lb, ub), R_rthresh, Rp)
            if chi_sq_of(x_new) <= chi_sq - chi_sq_delta:
                x_filter = x_new

    return x_filter


def fit_peaks(tau, gamma, Rp, weights=None, nonneg=True, check_shoulders=False,
              prom_rthresh=0.001, R_rthresh=0.005, check_chi_sq=False,
              chi_sq_thresh=0.4, chi_sq_delta=0.2, l1_penalty=0,
              l2_penalty=0.01, *, device=None, dtype=None):
    """Fit HN peaks; negative distributions fit pos/neg lobes separately then
    jointly (reference: peak_fit.py:76-128). Numpy."""
    tau = np.asarray(tau, float)
    gamma = np.asarray(gamma, float)
    place = dict(device=device, dtype=dtype)
    if nonneg:
        return fit_pos_peaks(tau, gamma, Rp, weights, check_shoulders,
                             prom_rthresh, R_rthresh, check_chi_sq,
                             chi_sq_thresh, chi_sq_delta, None, l1_penalty,
                             l2_penalty, **place)

    gamma_pos = np.maximum(gamma, 0.0)
    gamma_neg = np.minimum(gamma, 0.0)
    deno = np.percentile(np.abs(gamma), 80)
    x_pos = fit_pos_peaks(tau, gamma_pos, Rp, weights, check_shoulders,
                          prom_rthresh, R_rthresh, check_chi_sq, chi_sq_thresh,
                          chi_sq_delta, deno, l1_penalty, l2_penalty, **place)
    x_neg = fit_pos_peaks(tau, -gamma_neg, Rp, weights, check_shoulders,
                          prom_rthresh, R_rthresh, check_chi_sq, chi_sq_thresh,
                          chi_sq_delta, deno, l1_penalty, l2_penalty, **place)
    if len(x_neg):
        x_neg = np.asarray(x_neg)
        x_neg[0::4] *= -1
    x0 = np.concatenate([x_pos, x_neg])
    if len(x0) == 0:
        return x0

    w = 1.0 / (gamma + deno)
    n = len(x0) // 4
    lb = np.zeros_like(x0)
    ub = np.zeros_like(x0)
    for i in range(n):
        log_t0 = x0[4 * i + 1]
        lb[4 * i:4 * i + 4] = [-np.inf, log_t0 - 0.1, 0, 0]
        ub[4 * i:4 * i + 4] = [np.inf, log_t0 + 0.1, 1, 1]
    x = _solve_peaks(tau, gamma, Rp, x0, lb, ub, w, l1_penalty, l2_penalty,
                     resolve_device(device), resolve_dtype(dtype))
    return filter_peaks(x, R_rthresh, Rp)


def constrained_peak_fit(tau, gamma, tau0_guess, Rp, nonneg,
                         lntau_uncertainty=3, sigma_lntau=5, weights=None,
                         l2_penalty=0.01, *, device=None, dtype=None):
    """Peaks at user-specified time constants with ln-tau priors
    (reference: peak_fit.py:401-458). Returns {'x', 'cost'}, numpy."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    tau = np.asarray(tau, float)
    gamma = np.asarray(gamma, float)
    tau0_guess = np.asarray(tau0_guess, float)
    num_peaks = len(tau0_guess)
    if len(tau) != len(gamma):
        raise ValueError("tau and gamma must have same length")
    if weights is None:
        weights = 1.0 / (gamma + np.percentile(np.abs(gamma), 80))
    elif len(weights) != len(gamma):
        raise ValueError("Length of weights must match length of gamma")

    x0 = np.zeros(num_peaks * 4)
    for i, t0 in enumerate(tau0_guess):
        start = int(np.argmin(np.abs(tau - t0 * np.exp(-2.0))))
        end = int(np.argmin(np.abs(tau - t0 * np.exp(2.0))))
        R = np.trapezoid(gamma[start:end + 1], np.log(tau[start:end + 1]))
        x0[4 * i:4 * i + 4] = [R, np.log(t0), 0.99, 0.8]

    lb = np.zeros_like(x0)
    ub = np.zeros_like(x0)
    for i in range(num_peaks):
        R0 = x0[4 * i]
        log_t0 = x0[4 * i + 1]
        if nonneg or R0 > 0:
            r_lb, r_ub = 0.0, np.inf
        else:
            r_lb, r_ub = -np.inf, 0.0
        lb[4 * i:4 * i + 4] = [r_lb, log_t0 - lntau_uncertainty, 0, 0]
        ub[4 * i:4 * i + 4] = [r_ub, log_t0 + lntau_uncertainty, 1, 1]

    tau_t, gamma_t, w_t = (_t(a, dev, dt) for a in (tau, gamma, weights))
    log_tau0 = _t(np.log(tau0_guess), dev, dt)
    Rp = float(Rp)

    def residuals(x):
        fit = _fit_distribution(x, tau_t)
        tau_resid = (x[1::4] - log_tau0) / sigma_lntau
        l2 = (x[::4] / Rp) * l2_penalty
        rp_resid = 2.0 * (torch.sum(x[::4]) - Rp) / Rp
        return torch.cat([(fit - gamma_t) * w_t, tau_resid, l2,
                          rp_resid[None]])

    x, cost = _lm(residuals, x0, lb, ub, dev, dt)
    return {"x": x, "cost": cost}


def fit_data(x0, freq, Z, R_inf=0.0, inductance=0.0, weights=None,
             lambda_x=10.0, *, device=None, dtype=None):
    """Re-optimize HN params against impedance data with Gaussian penalties
    tying them to the distribution fit (reference: peak_fit.py:320-383).
    Returns {'x', 'cost'}, numpy."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    freq = np.asarray(freq, float)
    Z = np.asarray(Z)
    x0 = np.asarray(x0, float)

    if weights is None or (isinstance(weights, str) and weights == "unity"):
        weights = np.ones(len(freq)) * (1 + 1j)
    elif isinstance(weights, str):
        if weights == "modulus":
            weights = (1 + 1j) / np.abs(Z)
        elif weights == "Orazem":
            weights = (1 + 1j) / (np.abs(Z.real) + np.abs(Z.imag))
        elif weights == "proportional":
            weights = 1 / np.abs(Z.real) + 1j / np.abs(Z.imag)
        elif weights == "prop_adj":
            zmod2 = np.real(Z * Z.conjugate())
            q25 = np.percentile(zmod2, 25)
            weights = 1 / (np.abs(Z.real) + q25) + 1j / (np.abs(Z.imag) + q25)
        else:
            raise ValueError(f"Invalid weights argument {weights!r}")
    elif isinstance(weights, (float, int)):
        weights = np.ones(len(freq)) * (1 + 1j) * weights

    flat_w = _t(np.concatenate([np.real(weights), np.imag(weights)]), dev, dt)
    omega = _t(2 * np.pi * freq, dev, dt)
    z_flat = _t(np.concatenate([Z.real, Z.imag]), dev, dt)
    x0_t = _t(x0, dev, dt)
    n_params = len(x0)
    R_inf, inductance = float(R_inf), float(inductance)

    def residuals(x):
        zr, zi = _fit_impedance_parts(x, omega, R_inf, inductance)
        z_resid = torch.cat([zr, zi]) - z_flat
        z_resid = z_resid * flat_w / (2 * len(freq))
        dx = x - x0_t
        r_resid = dx[::4] / (0.05 * x0_t[::4])
        logt_resid = dx[1::4] / 0.2
        alpha_resid = dx[2::4] / 0.15
        beta_resid = dx[3::4] / 0.15
        x_resid = torch.cat([r_resid, logt_resid, alpha_resid,
                             beta_resid]) / n_params
        return torch.cat([z_resid, lambda_x * x_resid])

    lb = np.zeros_like(x0)
    ub = np.zeros_like(x0)
    for i in range(len(x0) // 4):
        log_t0 = x0[4 * i + 1]
        lb[4 * i:4 * i + 4] = [0, log_t0 - 1, 0, 0]
        ub[4 * i:4 * i + 4] = [np.inf, log_t0 + 1, 1, 1]
    x, cost = _lm(residuals, x0, lb, ub, dev, dt)
    return {"x": x, "cost": cost}
