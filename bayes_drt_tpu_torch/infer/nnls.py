"""Batched box-constrained quadratic programming (port of
bayes_drt_tpu/infer/nnls.py:36-192).

    minimize    0.5 x^T P x + q^T x   (P symmetric positive definite)
    subject to  lb <= x <= ub

Block principal pivoting: each iteration is one masked K x K Cholesky
solve, and the active set typically settles in a handful of iterations.
Every function takes a leading spectra axis, P (B, K, K) and q (B, K). The
JAX package's while_loop becomes a loop that runs while any row is
unfinished; finished rows are frozen by masks, so each row's result is
its own single solve's (up to the rounding of the batched solves, which
can differ with the batch size).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._numerics import graph_capture
from ..progcache import cached_program


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


# box-QP iterations run between two host checks of which rows are still
# pivoting; the rows that are run gather into a compact batch at each
# check, so a few slow rows do not carry the whole batch
_QP_CHECK_EVERY = 8
# on a CUDA device, rows still pivoting after this many iterations (a
# tail that, in the ill-conditioned ridge QPs of a small lambda, cycles to
# the iteration cap) finish as replays of one CUDA graph of
# _QP_GRAPH_STEPS iterations, their batch padded to a power of two: a
# step of a few rows is bound by its ~40 launches, not its arithmetic
_QP_GRAPH_AFTER = 64
_QP_GRAPH_STEPS = 32


class _PivotState(NamedTuple):
    at_lb: torch.Tensor
    at_ub: torch.Tensor
    x: torch.Tensor
    it: torch.Tensor
    prev_nviol: torch.Tensor
    done: torch.Tensor


def _pivot_step(P, q, lb, ub, tol_p, tol_d, max_iter, s: _PivotState):
    """One block-principal-pivoting iteration of the rows still running
    (finished rows are frozen by masks)."""
    k = q.shape[-1]
    idx = torch.arange(k, device=q.device)
    act = (s.it < max_iter) & ~s.done
    x_new = _masked_solve(P, q, s.at_lb, s.at_ub, lb, ub)
    g = (P @ x_new[..., None])[..., 0] + q
    free = (~s.at_lb) & (~s.at_ub)
    viol_f_lb = free & (x_new < lb - tol_p)
    viol_f_ub = free & (x_new > ub + tol_p)
    viol_lb = s.at_lb & (g < -tol_d)
    viol_ub = s.at_ub & (g > tol_d)
    any_viol = viol_f_lb | viol_f_ub | viol_lb | viol_ub
    nviol = any_viol.sum(dim=-1)
    full_lb = (s.at_lb & ~viol_lb) | viol_f_lb
    full_ub = (s.at_ub & ~viol_ub) | viol_f_ub
    top = torch.where(any_viol, idx, torch.full_like(idx, -1)).max(
        dim=-1).values
    one_hot = idx[None, :] == top[:, None]
    single_lb = torch.where(one_hot, full_lb, s.at_lb)
    single_ub = torch.where(one_hot, full_ub, s.at_ub)
    use_full = (nviol < s.prev_nviol)[:, None]
    a1 = act[:, None]
    return _PivotState(
        at_lb=torch.where(a1, torch.where(use_full, full_lb, single_lb),
                          s.at_lb),
        at_ub=torch.where(a1, torch.where(use_full, full_ub, single_ub),
                          s.at_ub),
        x=torch.where(a1, x_new, s.x),
        it=s.it + act.to(s.it.dtype),
        prev_nviol=torch.where(act & use_full[:, 0], nviol, s.prev_nviol),
        done=torch.where(act, nviol == 0, s.done))


def _tail_buffers(P, q, lb, ub, tol_d, sub: _PivotState, rows: int):
    """The tail's inputs and state padded to ``rows`` rows with copies of
    the first row: ((P, q, lb, ub, tol_d), state), fresh tensors."""
    n = sub.x.shape[0]

    def padded(t):
        if rows == n:
            return t.clone()
        return torch.cat([t, t[:1].expand((rows - n,) + t.shape[1:])])

    return (tuple(padded(t).contiguous() for t in (P, q, lb, ub, tol_d)),
            _PivotState(*(padded(t) for t in sub)))


def _tail_run(bufs, st, tol_p, max_iter):
    """``run()`` advances the padded state ``st`` in place by
    _QP_GRAPH_STEPS iterations over the padded inputs ``bufs``."""
    P_, q_, lb_, ub_, td_ = bufs

    def run():
        s = st
        for _ in range(_QP_GRAPH_STEPS):
            s = _pivot_step(P_, q_, lb_, ub_, tol_p, td_, max_iter, s)
        for dst, src in zip(st, s):
            dst.copy_(src)

    return run


def _tail_rows(n: int) -> int:
    return max(8, 1 << (n - 1).bit_length())


def _padded_tail(P, q, lb, ub, tol_p, tol_d, max_iter, sub: _PivotState):
    """The rows of ``sub`` padded to a power of two with copies of the first
    row (n, the padded state, and ``run``, which advances that state in
    place by _QP_GRAPH_STEPS iterations)."""
    n = sub.x.shape[0]
    bufs, st = _tail_buffers(P, q, lb, ub, tol_d, sub, _tail_rows(n))
    return n, st, _tail_run(bufs, st, tol_p, max_iter)


class _TailGraph:
    """The tail's cache entry: padded buffers, their state and one CUDA
    graph of ``_tail_run``, captured once; a call copies its rows in,
    replays until they end and returns their state."""

    def __init__(self, P, q, lb, ub, tol_p, tol_d, max_iter, sub, rows):
        self.max_iter = max_iter
        self.bufs, self.st = _tail_buffers(P, q, lb, ub, tol_d, sub, rows)
        run = _tail_run(self.bufs, self.st, tol_p, max_iter)
        start = _PivotState(*(t.clone() for t in self.st))
        dev = P.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):      # first use of every op off-graph
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        for dst, src in zip(self.st, start):
            dst.copy_(src)
        self.pool_id = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        with graph_capture(self.graph, dev, pool=self.pool_id):
            run()

    def pools(self):
        return [self.pool_id]

    def release(self):
        self.graph = None

    def __call__(self, P, q, lb, ub, tol_d, sub):
        n = sub.x.shape[0]
        bufs, st = _tail_buffers(P, q, lb, ub, tol_d, sub,
                                 self.st.x.shape[0])
        for dst, src in zip(self.bufs + tuple(self.st), bufs + tuple(st)):
            dst.copy_(src)
        st = self.st
        while bool(((st.it[:n] < self.max_iter) & ~st.done[:n]).any()):
            self.graph.replay()
        return _PivotState(*(t[:n].clone() for t in st))


def _graphed_tail(P, q, lb, ub, tol_p, tol_d, max_iter, sub: _PivotState):
    """Pivot the rows of ``sub`` (on a CUDA device) to their end,
    _QP_GRAPH_STEPS iterations a replay of one captured CUDA graph of
    ``_padded_tail``'s ``run``, whose padding rows are dropped. The graph
    and its padded buffers are a cache entry (progcache) keyed on the
    padded row count, K, dtype, device, the tolerance and the cap."""
    rows = _tail_rows(sub.x.shape[0])
    key = ("qp_tail", rows, tuple(P.shape[1:]), str(P.dtype), str(P.device),
           tuple(lb.shape[1:]), float(tol_p), int(max_iter))
    runner = cached_program(key, lambda: _TailGraph(
        P, q, lb, ub, tol_p, tol_d, max_iter, sub, rows))
    return runner(P, q, lb, ub, tol_d, sub)


def solve_qp_box(P, q, lb, ub, max_iter: int = 100, tol: float = 1e-10,
                 warm_sets=None) -> QPResult:
    """Block principal pivoting for B box-constrained QPs at once.

    P (B, K, K), q (B, K); lb, ub (K,) or (B, K). Murty's single-exchange
    safeguard flips only the highest-index violation when the violation
    count fails to decrease, which guarantees finite termination.
    ``warm_sets``: optional (at_lb, at_ub) (B, K) boolean arrays seeding
    the active set. Each row's iterations depend on that row alone, so
    the rows still pivoting are gathered into a compact batch every
    ``_QP_CHECK_EVERY`` iterations, and on a CUDA device those still
    pivoting after ``_QP_GRAPH_AFTER`` finish as CUDA graph replays."""
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
    st = _PivotState(
        at_lb=at_lb, at_ub=at_ub, x=x,
        it=torch.zeros(b, dtype=torch.int64, device=q.device),
        prev_nviol=torch.full((b,), k + 1, dtype=torch.int64,
                              device=q.device),
        done=torch.zeros(b, dtype=torch.bool, device=q.device))

    act = (st.it < max_iter) & ~st.done
    steps = 0
    while bool(act.any()):
        rows = torch.nonzero(act).flatten()
        sub = _PivotState(*(f[rows] for f in st))
        args = (P[rows], q[rows], lb[rows], ub[rows], tol_p, tol_d[rows],
                max_iter)
        if P.device.type == "cuda" and steps >= _QP_GRAPH_AFTER:
            sub = _graphed_tail(*args, sub)
        else:
            for _ in range(_QP_CHECK_EVERY):
                sub = _pivot_step(*args, sub)
            steps += _QP_CHECK_EVERY
        fields = []
        for f_all, f_sub in zip(st, sub):
            f_all = f_all.clone()
            f_all[rows] = f_sub
            fields.append(f_all)
        st = _PivotState(*fields)
        act = (st.it < max_iter) & ~st.done

    x = st.x
    free = (x > lb + tol_p) & (x < ub - tol_p)
    x = torch.minimum(torch.maximum(x, lb), ub) * d
    g = (P_orig @ x[..., None])[..., 0] + q_orig
    kkt = torch.where(free, g.abs(), torch.zeros_like(g)).max(dim=-1).values
    return QPResult(x=x, n_iter=st.it, kkt_violation=kkt,
                    converged=st.done, at_lb=st.at_lb, at_ub=st.at_ub)


def solve_qp_box_batch(P, q, lb, ub, max_iter: int = 100,
                       tol: float = 1e-10) -> QPResult:
    """The JAX package's ``solve_qp_box_batch``
    (``jax.vmap(solve_qp_box, in_axes=(0, 0, None, None))``): QPs over
    rows P (B, K, K), q (B, K) under one pair of bounds lb, ub (K,) shared
    by every row. The port's ``solve_qp_box`` is batched already; this is
    it with the bounds held shared."""
    if np.ndim(lb) != 1 or np.ndim(ub) != 1:
        raise ValueError("solve_qp_box_batch takes bounds lb, ub of shape "
                         "(K,) shared by every row; use solve_qp_box for "
                         "per-row bounds")
    return solve_qp_box(P, q, lb, ub, max_iter=max_iter, tol=tol)


def solve_nnls(P, q, max_iter: int = 100, tol: float = 1e-10) -> QPResult:
    """Non-negative QPs: ``solve_qp_box`` with lb = 0, ub = inf, for P
    (B, K, K), q (B, K)."""
    k = P.shape[-1]
    lb = torch.zeros(k, dtype=P.dtype, device=P.device)
    return solve_qp_box(P, q, lb, torch.full_like(lb, float("inf")),
                        max_iter=max_iter, tol=tol)
