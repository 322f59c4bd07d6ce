"""Bounded nonlinear least squares: Levenberg-Marquardt with smooth bound
transforms (port of bayes_drt_tpu/infer/lsq.py).

Bounds are enforced by reparameterization:
  (lb, ub) finite  -> x = lb + (ub-lb)*sigmoid(u)
  (lb, inf)        -> x = lb + softplus(u)
  (-inf, ub)       -> x = ub - softplus(u)
  (-inf, inf)      -> x = u
and plain LM runs in u-space with forward-mode Jacobians
(``torch.func.jacfwd`` under ``vmap``).

The batch is an explicit row axis: ``x0`` is (R, P), every row runs its
own LM and freezes once its own stop rule fails, as a vmapped
``lax.while_loop`` selects per row. The host checks once an iteration
whether any row still runs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def _softplus(u):
    return torch.logaddexp(u, torch.zeros_like(u))


def _inv_softplus(x):
    x = torch.clamp_min(x, 1e-10)
    return torch.where(x > 30.0, x, torch.log(torch.expm1(x)))


def make_bound_transform(lb, ub):
    """Returns (to_x, to_u): smooth maps between bounded x and free u, for
    bound tensors ``lb`` and ``ub`` (+-inf where a side is open)."""
    two_sided = torch.isfinite(lb) & torch.isfinite(ub)
    lower_only = torch.isfinite(lb) & ~torch.isfinite(ub)
    upper_only = ~torch.isfinite(lb) & torch.isfinite(ub)
    lb_s = torch.where(torch.isfinite(lb), lb, torch.zeros_like(lb))
    ub_s = torch.where(torch.isfinite(ub), ub, torch.ones_like(ub))
    width = torch.where(two_sided, ub_s - lb_s, torch.ones_like(lb))

    def to_x(u):
        x2 = lb_s + width * torch.sigmoid(u)
        xl = lb_s + _softplus(u)
        xu = ub_s - _softplus(u)
        return torch.where(two_sided, x2,
                           torch.where(lower_only, xl,
                                       torch.where(upper_only, xu, u)))

    def to_u(x):
        frac = torch.clamp((x - lb_s) / width, 1e-7, 1.0 - 1e-7)
        u2 = torch.log(frac) - torch.log1p(-frac)
        ul = _inv_softplus(x - lb_s)
        uu = _inv_softplus(ub_s - x)
        return torch.where(two_sided, u2,
                           torch.where(lower_only, ul,
                                       torch.where(upper_only, uu, x)))

    return to_x, to_u


class LsqResult(NamedTuple):
    x: torch.Tensor          # (R, P)
    cost: torch.Tensor       # (R,) 0.5 ||r||^2 at x
    n_iter: torch.Tensor     # (R,) int32
    grad_norm: torch.Tensor  # (R,) |J^T r|_inf at the last iteration's start


def bounded_lm(residual_fn: Callable, x0, lb, ub, max_iter: int = 200,
               xtol: float = 1e-10, gtol: float = 1e-10,
               lam0: float = 1e-3) -> LsqResult:
    """Minimize 0.5*||residual_fn(x)||^2 subject to lb <= x <= ub for each
    row of ``x0`` (R, P).

    ``residual_fn`` maps one row (P,) to its residual vector (M,) and must
    be ``torch.func``-transformable (it runs under ``vmap`` and
    ``jacfwd``). ``lb``/``ub`` are (P,) or (R, P), in any array form; they
    follow ``x0``'s dtype and device. An iteration forms g = J^T r and
    H = J^T J, tries the damped steps (H + lam diag(d)) du = -g at lam and
    10 lam (d the diagonal of H, 1 where it is below 1e-12), keeps the
    first that lowers the cost (lam x 0.3, or x 3 for the second) or
    neither (lam x 30), and clips lam to [1e-12, 1e12]. A row stops at
    ``max_iter``, once the gradient infinity norm at the start of its last
    iteration is <= ``gtol``, or once lam reaches 1e11. ``xtol`` is
    accepted and unused, as in the JAX package."""
    del xtol
    x0 = torch.as_tensor(x0)
    dt, dev = x0.dtype, x0.device

    def bound(b):
        return torch.as_tensor(b, dtype=dt, device=dev).expand_as(x0)

    lb, ub = bound(lb), bound(ub)
    to_x, to_u = make_bound_transform(lb, ub)
    # nudge the start strictly inside the bounds
    u = to_u(torch.clamp(x0, lb + 1e-8, ub - 1e-8))

    def res_row(u_row, lb_row, ub_row):
        to_x_row, _ = make_bound_transform(lb_row, ub_row)
        return residual_fn(to_x_row(u_row))

    res_rows = torch.func.vmap(res_row)
    jac_rows = torch.func.vmap(torch.func.jacfwd(res_row))

    def cost_of(u_rows):
        r = res_rows(u_rows, lb, ub)
        return 0.5 * torch.sum(r * r, dim=-1)

    R, P = u.shape
    eye = torch.eye(P, dtype=dt, device=dev)
    lam = torch.full((R,), float(lam0), dtype=dt, device=dev)
    cost = cost_of(u)
    gnorm = torch.full((R,), float("inf"), dtype=dt, device=dev)
    it = torch.zeros(R, dtype=torch.int32, device=dev)

    def running():
        return (it < max_iter) & (gnorm > gtol) & (lam < 1e11)

    act = running()
    while bool(act.any()):
        r = res_rows(u, lb, ub)
        # (R, M, P); forward-mode AD through float32 0-d tensors and
        # Python floats can return float64 tangents
        J = jac_rows(u, lb, ub).to(r.dtype)
        g = torch.einsum("rmp,rm->rp", J, r)
        H = torch.einsum("rmp,rmq->rpq", J, J)
        d = torch.diagonal(H, dim1=1, dim2=2)
        d = torch.where(d > 1e-12, d, torch.ones_like(d))

        def try_step(lam_try):
            A = H + (lam_try[:, None] * d)[:, :, None] * eye
            du, info = torch.linalg.solve_ex(A, -g)
            # a singular system gives a step nowhere, as jnp's solve does
            du = torch.where((info == 0)[:, None], du,
                             torch.full_like(du, float("nan")))
            return u + du

        # one accept/reject with adaptive damping (two candidate lambdas)
        u_a = try_step(lam)
        c_a = cost_of(u_a)
        u_b = try_step(lam * 10.0)
        c_b = cost_of(u_b)
        improved_a = c_a < cost
        improved_b = c_b < cost
        u_new = torch.where(improved_a[:, None], u_a,
                            torch.where(improved_b[:, None], u_b, u))
        c_new = torch.where(improved_a, c_a,
                            torch.where(improved_b, c_b, cost))
        lam_new = torch.where(improved_a, lam * 0.3,
                              torch.where(improved_b, lam * 3.0, lam * 30.0))
        lam_new = torch.clamp(lam_new, 1e-12, 1e12)
        u = torch.where(act[:, None], u_new, u)
        cost = torch.where(act, c_new, cost)
        lam = torch.where(act, lam_new, lam)
        gnorm = torch.where(act, g.abs().amax(dim=1), gnorm)
        it = it + act.to(torch.int32)
        act = running()
    return LsqResult(x=to_x(u), cost=cost, n_iter=it, grad_norm=gnorm)
