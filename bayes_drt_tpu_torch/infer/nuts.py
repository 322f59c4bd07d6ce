"""Adaptation helpers shared by the HMC samplers (port of the helpers of
bayes_drt_tpu/infer/nuts.py:99-111,575-690): the batched initial step-size
search, the Stan-style mass-adaptation window schedule, dual averaging and
the regularized variance. The NUTS sampler itself is not ported yet.

Everything is batched over rows: a row is one chain, and per-row state is
a tensor with a leading row axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class NUTSConfig(NamedTuple):
    """The adaptation fields the helpers read (SHMCConfig carries the
    same names)."""
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0              # adapt_t0 (reference control)
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    adapt_mass: bool = True


def _leapfrog(value_and_grad, q, p, grad, eps, m_inv):
    """One leapfrog step of rows (R, D) with per-row eps (R,) and a
    diagonal inverse metric (R, D)."""
    e = eps[:, None]
    p_half = p + 0.5 * e * grad
    q_new = q + e * (m_inv * p_half)
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * e * grad_new
    return q_new, p_new, grad_new, logp_new


def _kinetic(p, m_inv):
    """0.5 p^T M^{-1} p per row for a diagonal metric."""
    return 0.5 * torch.sum(p * (m_inv * p), dim=-1)


def _sample_momentum(z, m_inv):
    """p ~ N(0, M) for a diagonal metric, from standard normals z."""
    return z / torch.sqrt(m_inv)


def find_reasonable_step_size(value_and_grad, q, logp, grad, z, m_inv,
                              init_eps=1.0, max_tries=60):
    """Double/halve eps per row until the one-step acceptance crosses ~0.5
    (Hoffman & Gelman 2014, as in Stan's init_stepsize).

    Rows: q, grad, z, m_inv (R, D); logp (R,). ``z`` are the standard
    normals of the momentum. The JAX version is a vmapped while_loop; here
    every row steps until none is active, and a row that has stopped keeps
    its value, which is what the vmapped loop computes."""
    p0 = _sample_momentum(z, m_inv)
    H0 = -logp + _kinetic(p0, m_inv)
    log_half = math.log(0.5)

    def ratio(eps):
        _, p1, _, lp1 = _leapfrog(value_and_grad, q, p0, grad, eps, m_inv)
        r = H0 - (-lp1 + _kinetic(p1, m_inv))
        return torch.where(torch.isnan(r), torch.full_like(r, -math.inf), r)

    eps = torch.full_like(logp, init_eps)
    r = ratio(eps)
    direction = torch.where(r > log_half, 1.0, -1.0).to(eps.dtype)
    factor = torch.pow(torch.full_like(eps, 2.0), direction)
    tries = torch.zeros_like(eps)

    def active():
        keep = torch.where(direction > 0, r > log_half, r < log_half)
        return keep & (tries < max_tries) & (eps < 1e7) & (eps > 1e-10)

    act = active()
    while bool(act.any()):
        eps = torch.where(act, eps * factor, eps)
        r = torch.where(act, ratio(eps), r)
        tries = tries + act.to(tries.dtype)
        act = active()
    return eps


def _window_flags(warmup: int, cfg):
    """Stan-style adaptation schedule flags (host-side, static)."""
    init_b, term_b, base = cfg.init_buffer, cfg.term_buffer, cfg.base_window
    if warmup < 20:
        return np.zeros(warmup, bool), np.zeros(warmup, bool)
    if init_b + term_b + base > warmup:
        init_b = int(0.15 * warmup)
        term_b = int(0.10 * warmup)
        base = warmup - init_b - term_b
    in_slow = np.zeros(warmup, bool)
    win_end = np.zeros(warmup, bool)
    slow_start, slow_stop = init_b, warmup - term_b
    in_slow[slow_start:slow_stop] = True
    t = slow_start
    w = base
    while t < slow_stop:
        end = t + w
        if end + 2 * w > slow_stop:
            end = slow_stop
        win_end[end - 1] = True
        t = end
        w *= 2
    return in_slow, win_end


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def _da_init(eps):
    """Dual-averaging state per row; log_eps_bar seeds at log(eps)."""
    le = torch.log(eps)
    return _DAState(log_eps=le, log_eps_bar=le, h_bar=torch.zeros_like(eps),
                    mu=math.log(10.0) + le, t=torch.zeros_like(eps))


def _da_update(da: _DAState, accept_prob, cfg):
    t = da.t + 1.0
    eta = 1.0 / (t + cfg.t0)
    h_bar = (1.0 - eta) * da.h_bar + eta * (cfg.delta - accept_prob)
    log_eps = da.mu - torch.sqrt(t) / cfg.gamma * h_bar
    w = torch.pow(t, -cfg.kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return _DAState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
                    mu=da.mu, t=t)


def _regularized_variance(cov, n):
    """Stan-style shrunk variance estimate for the new metric at a window
    end: cov * n/(n+5) + 1e-3 * 5/(n+5)."""
    return cov * (n / (n + 5.0)) + 1e-3 * (5.0 / (n + 5.0))
