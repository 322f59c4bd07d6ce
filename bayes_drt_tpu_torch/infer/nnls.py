"""Batched box-constrained quadratic programming (port of
bayes_drt_tpu/infer/nnls.py:36-192).

    minimize    0.5 x^T P x + q^T x   (P symmetric positive definite)
    subject to  lb <= x <= ub

Block principal pivoting: each iteration is one masked K x K Cholesky
solve, and the active set typically settles in a handful of iterations.
Every function takes a leading spectra axis, P (B, K, K) and q (B, K). The
JAX package's while_loop becomes a loop that runs while any row is
unfinished; finished rows are frozen by masks, so each row's result equals
its own single solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPResult(NamedTuple):
    x: torch.Tensor              # (B, K)
    n_iter: torch.Tensor         # (B,)
    kkt_violation: torch.Tensor  # (B,)
    converged: torch.Tensor      # (B,) bool
    at_lb: torch.Tensor          # (B, K) final active sets: feed back as
    at_ub: torch.Tensor          # warm_sets for nearby re-solves


def _spd_solve(M, rhs):
    """Cholesky solve of symmetric positive-definite systems (B, K, K) x =
    (B, K). A row whose factorization fails comes back NaN, as the JAX
    package's Cholesky returns it, instead of raising."""
    chol, info = torch.linalg.cholesky_ex(M)
    chol = torch.where((info != 0)[:, None, None],
                       torch.full_like(chol, float("nan")), chol)
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    x = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
    return x[..., 0]


def _masked_solve(P, q, at_lb, at_ub, lb, ub):
    """Solve the equality-constrained subproblem: clamped coords pinned at
    their bound, free coords solve P_FF x_F = -(q_F + P_FC x_C). The
    assembled matrix is symmetric (free block P_FF, clamped block I,
    off-blocks 0) and positive definite."""
    clamped = at_lb | at_ub
    bound_val = torch.where(at_ub, ub, torch.where(at_lb, lb,
                                                   torch.zeros_like(lb)))
    k = P.shape[-1]
    eye = torch.eye(k, dtype=P.dtype, device=P.device)
    M = torch.where(clamped[:, :, None], eye, P)
    M = torch.where((~clamped[:, :, None]) & clamped[:, None, :],
                    torch.zeros_like(M), M)
    rhs = torch.where(clamped, bound_val,
                      -q - (P @ bound_val[..., None])[..., 0])
    return _spd_solve(M, rhs)


def _equilibrate(P, q, lb, ub):
    """Jacobi equilibration (x = d*y with unit diagonal), symmetrized, with
    the float32 unit-diagonal jitter of 100 eps. Returns (d, P, q, lb, ub)
    in the scaled coordinates."""
    dtype = P.dtype
    finfo = torch.finfo(dtype)
    diag = torch.diagonal(P, dim1=-2, dim2=-1)
    d = torch.where(diag > finfo.tiny, 1.0 / torch.sqrt(diag),
                    torch.ones_like(diag))
    Ps = d[:, :, None] * P * d[:, None, :]
    Ps = 0.5 * (Ps + Ps.transpose(-1, -2))
    if dtype == torch.float32:
        k = P.shape[-1]
        Ps = Ps + (100.0 * finfo.eps) * torch.eye(k, dtype=dtype,
                                                  device=P.device)
    return d, Ps, d * q, lb / d, ub / d


def _bounds(lb, ub, P):
    b, k = P.shape[0], P.shape[-1]
    kw = dict(dtype=P.dtype, device=P.device)
    return (torch.as_tensor(lb, **kw).expand(b, k),
            torch.as_tensor(ub, **kw).expand(b, k))


def qp_cold_sets(P, q, lb, ub):
    """The active sets implied by the clipped unconstrained solution, with
    solve_qp_box's own equilibration (the sets are invariant to the
    diagonal scaling). Outer loops that seed their own warm starts use
    this for their first iteration."""
    lb, ub = _bounds(lb, ub, P)
    d, Ps, qs, lbs, ubs = _equilibrate(P, q, lb, ub)
    x0 = torch.nan_to_num(_spd_solve(Ps, -qs))
    return x0 < lbs, x0 > ubs


def solve_qp_box(P, q, lb, ub, max_iter: int = 100, tol: float = 1e-10,
                 warm_sets=None) -> QPResult:
    """Block principal pivoting for B box-constrained QPs at once.

    P (B, K, K), q (B, K); lb, ub (K,) or (B, K). Murty's single-exchange
    safeguard flips only the highest-index violation when the violation
    count fails to decrease, which guarantees finite termination.
    ``warm_sets``: optional (at_lb, at_ub) (B, K) boolean arrays seeding
    the active set."""
    dtype = P.dtype
    q = q.to(dtype)
    b, k = q.shape
    lb, ub = _bounds(lb, ub, P)
    P_orig, q_orig = P, q
    d, P, q, lb, ub = _equilibrate(P, q, lb, ub)
    machine = torch.finfo(dtype).eps
    scale = torch.clamp(q.abs().max(dim=-1).values, min=1.0)
    # the tolerance is floored at the dtype's resolution: 1e-10 is out of
    # reach in float32 and the loop would run out its whole budget
    tol_p = max(float(tol), 50.0 * machine)
    tol_d = tol_p * scale[:, None]

    if warm_sets is not None:
        at_lb, at_ub = (s.clone() for s in warm_sets)
        x = torch.zeros_like(q)
    else:
        x0 = _spd_solve(P, -q)
        at_lb, at_ub = x0 < lb, x0 > ub
        x = torch.minimum(torch.maximum(x0, lb), ub)
    it = torch.zeros(b, dtype=torch.int64, device=q.device)
    prev_nviol = torch.full((b,), k + 1, dtype=torch.int64, device=q.device)
    done = torch.zeros(b, dtype=torch.bool, device=q.device)
    idx = torch.arange(k, device=q.device)

    act = (it < max_iter) & ~done
    while bool(act.any()):
        x_new = _masked_solve(P, q, at_lb, at_ub, lb, ub)
        g = (P @ x_new[..., None])[..., 0] + q
        free = (~at_lb) & (~at_ub)
        viol_f_lb = free & (x_new < lb - tol_p)
        viol_f_ub = free & (x_new > ub + tol_p)
        viol_lb = at_lb & (g < -tol_d)
        viol_ub = at_ub & (g > tol_d)
        any_viol = viol_f_lb | viol_f_ub | viol_lb | viol_ub
        nviol = any_viol.sum(dim=-1)
        full_lb = (at_lb & ~viol_lb) | viol_f_lb
        full_ub = (at_ub & ~viol_ub) | viol_f_ub
        top = torch.where(any_viol, idx, torch.full_like(idx, -1)).max(
            dim=-1).values
        one_hot = idx[None, :] == top[:, None]
        single_lb = torch.where(one_hot, full_lb, at_lb)
        single_ub = torch.where(one_hot, full_ub, at_ub)
        use_full = (nviol < prev_nviol)[:, None]
        a1 = act[:, None]
        at_lb = torch.where(a1, torch.where(use_full, full_lb, single_lb),
                            at_lb)
        at_ub = torch.where(a1, torch.where(use_full, full_ub, single_ub),
                            at_ub)
        x = torch.where(a1, x_new, x)
        prev_nviol = torch.where(act & use_full[:, 0], nviol, prev_nviol)
        done = torch.where(act, nviol == 0, done)
        it = it + act.to(it.dtype)
        act = (it < max_iter) & ~done

    free = (x > lb + tol_p) & (x < ub - tol_p)
    x = torch.minimum(torch.maximum(x, lb), ub) * d
    g = (P_orig @ x[..., None])[..., 0] + q_orig
    kkt = torch.where(free, g.abs(), torch.zeros_like(g)).max(dim=-1).values
    return QPResult(x=x, n_iter=it, kkt_violation=kkt, converged=done,
                    at_lb=at_lb, at_ub=at_ub)
