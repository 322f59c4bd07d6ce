"""Multinomial NUTS with a diagonal or dense metric, and the adaptation
helpers shared by the HMC samplers (port of bayes_drt_tpu/infer/nuts.py).

Everything is batched over rows: a row is one chain, with its own step
size, metric and tree, and per-row state is a tensor with a leading row
axis. A metric (the inverse mass matrix) takes one of three forms: a
diagonal per row (R, D); one dense matrix shared by every row (1, D, D),
whose velocities are one matrix product over the rows; or a dense matrix
per row (R, D, D), what ``dense_mass`` adapts. A dense metric carries its
Cholesky factor, through which the momentum is drawn.

The tree builder is the JAX package's flat body (``_flat_body``,
nuts.py:321-426): one leapfrog a step, the subtree start and merge run
masked. Rows that are still building their tree advance in lockstep (a
row leaves the tree for good when its subtree turns or diverges), so every
live row sits at the same leaf of the same subtree, and that position is
known on the host: checkpoint writes, U-turn checks and merges run only
at the leaves that need them. Finished rows are frozen by masks.

The random numbers of a draw are drawn before its tree (``NUTSNoise``):
momentum normals, one direction bit and one swap uniform per depth and
one uniform per leaf. The JAX package's key schedule yields the same
structure, so its draws can be replayed, and the tree itself calls no
generator.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .._numerics import graph_capture
from ..profiling import StageTimer


class NUTSConfig(NamedTuple):
    """The JAX package's NUTS configuration, field for field.

    ``tree_scan`` runs the static 2^max_depth - 1 leaves of every tree;
    ``flat_tree`` and the default (the JAX package's nested doubling
    loops) stop once no row is alive. All three give the same draws.
    ``unroll`` and ``scan_unroll`` tune the JAX package's compiled loops
    and have no effect in eager torch. ``dense_mass`` adapts a dense
    metric per row (Stan's dense_e); ``adapt_mass=False`` keeps the
    initial or passed-in metric and adapts the step size only.
    ``fused_draws`` (the JAX package's whole chain as one loop of
    leapfrog steps) runs the flat form, which gives the same draws;
    dense mass adaptation is refused with it, as in the JAX package."""
    max_depth: int = 10
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0              # adapt_t0 (reference control)
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    dense_mass: bool = False
    adapt_mass: bool = True
    unroll: int = 1
    flat_tree: bool = False
    fused_draws: bool = False
    tree_scan: bool = False
    scan_unroll: int = 1

    def validate(self) -> None:
        if self.fused_draws and self.adapt_mass and self.dense_mass:
            raise ValueError(
                "fused_draws does not support dense mass adaptation (the "
                "masked window update would pay a cholesky per leapfrog); "
                "pass a fixed dense metric with adapt_mass=False, or use "
                "flat_tree")


def metric_form(m_inv) -> str:
    """'diag' (R, D), 'dense' (1, D, D, shared) or 'dense_rows'
    (R, D, D)."""
    if m_inv.ndim == 2:
        return "diag"
    return "dense" if m_inv.shape[0] == 1 else "dense_rows"


def _vel(p, m_inv):
    """Velocity M^{-1} p of rows p (R, D) for a metric of any form."""
    if m_inv.ndim == 2:
        return m_inv * p
    if m_inv.shape[0] == 1:
        return p @ m_inv[0].T
    return torch.matmul(m_inv, p[..., None])[..., 0]


def _leapfrog(value_and_grad, q, p, grad, eps, m_inv):
    """One leapfrog step of rows (R, D) with per-row eps (R,)."""
    e = eps[:, None]
    p_half = p + 0.5 * e * grad
    q_new = q + e * _vel(p_half, m_inv)
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * e * grad_new
    return q_new, p_new, grad_new, logp_new


def _kinetic(p, m_inv):
    """0.5 p^T M^{-1} p per row."""
    return 0.5 * torch.sum(p * _vel(p, m_inv), dim=-1)


def _sample_momentum(z, m_inv, mass_chol=None):
    """p ~ N(0, M) from standard normals z (R, D). Diagonal: z /
    sqrt(m_inv). Dense, with M^{-1} = L L^T (``mass_chol`` = L): p =
    L^{-T} z, whose covariance is M."""
    if m_inv.ndim == 2:
        return z / torch.sqrt(m_inv)
    if m_inv.shape[0] == 1:
        return torch.linalg.solve_triangular(mass_chol[0].T, z.T,
                                             upper=True).T
    return torch.linalg.solve_triangular(mass_chol.mT, z[..., None],
                                         upper=True)[..., 0]


def find_reasonable_step_size(value_and_grad, q, logp, grad, z, m_inv,
                              init_eps=1.0, max_tries=60, mass_chol=None):
    """Double/halve eps per row until the one-step acceptance crosses ~0.5
    (Hoffman & Gelman 2014, as in Stan's init_stepsize).

    Rows: q, grad, z (R, D); logp (R,); ``m_inv`` a metric of any form
    (``mass_chol`` its factor when dense); ``init_eps`` a float or per-row
    (R,). ``z`` are the standard normals of the momentum. The JAX version
    is a vmapped while_loop; here every row steps until none is active,
    and a row that has stopped keeps its value, which is what the vmapped
    loop computes."""
    p0 = _sample_momentum(z, m_inv, mass_chol)
    H0 = -logp + _kinetic(p0, m_inv)
    log_half = math.log(0.5)

    def ratio(eps):
        _, p1, _, lp1 = _leapfrog(value_and_grad, q, p0, grad, eps, m_inv)
        r = H0 - (-lp1 + _kinetic(p1, m_inv))
        return torch.where(torch.isnan(r), torch.full_like(r, -math.inf), r)

    eps = torch.as_tensor(init_eps, dtype=logp.dtype,
                          device=logp.device).expand_as(logp).clone()
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


def _regularized_covariance(cov, n):
    """The dense counterpart for rows of covariances (R, D, D): the
    off-diagonals shrunk toward the diagonal by n / (n + D + 5) (a window
    of fewer draws than dimensions is rank-deficient), then
    _regularized_variance's shrinkage with an identity-scaled floor."""
    dim = cov.shape[-1]
    alpha = n / (n + dim + 5.0)
    diag_part = torch.diag_embed(torch.diagonal(cov, dim1=-2, dim2=-1))
    shrunk = alpha * cov + (1.0 - alpha) * diag_part
    eye = torch.eye(dim, dtype=cov.dtype, device=cov.device)
    return shrunk * (n / (n + 5.0)) + 1e-3 * (5.0 / (n + 5.0)) * eye


def _welford_init(rows, dim, dtype, device, dense: bool = False):
    """Welford accumulator (mean (R, D), M2 (R, D) or (R, D, D) dense, n)."""
    mean = torch.zeros((rows, dim), dtype=dtype, device=device)
    m2 = torch.zeros((rows, dim, dim) if dense else (rows, dim),
                     dtype=dtype, device=device)
    return mean, m2, 0.0


def _welford_add(wf, x):
    mean, m2, n = wf
    n1 = n + 1.0
    d = x - mean
    mean = mean + d / n1
    d2 = x - mean
    if m2.ndim == 3:
        return mean, m2 + d[:, :, None] * d2[:, None, :], n1
    return mean, m2 + d * d2, n1


def _window_metric(wf, m_inv, mass_chol):
    """The metric at a window's end from its Welford accumulator: the
    regularized (co)variance where it holds more than one draw and, for a
    dense metric, a Cholesky factor exists; else the metric unchanged."""
    _, m2, n = wf
    if n <= 1:
        return m_inv, mass_chol
    cov = m2 / max(n - 1.0, 1.0)
    if m2.ndim == 2:
        return _regularized_variance(cov, n), mass_chol
    reg = _regularized_covariance(cov, n)
    chol, info = torch.linalg.cholesky_ex(reg)
    ok = (info == 0) & torch.isfinite(chol).all(dim=(-2, -1))
    ok = ok[:, None, None]
    return (torch.where(ok, reg, m_inv), torch.where(ok, chol, mass_chol))


# ===================== the NUTS tree =====================

class _EdgeState(NamedTuple):
    q: torch.Tensor      # (R, D)
    p: torch.Tensor      # (R, D)
    grad: torch.Tensor   # (R, D)
    logp: torch.Tensor   # (R,)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    n_leapfrog: torch.Tensor
    energy: torch.Tensor
    tree_depth: torch.Tensor


class NUTSNoise(NamedTuple):
    """The random numbers of one draw for R rows."""
    z: torch.Tensor         # (R, D) momentum normals
    go_right: torch.Tensor  # (max_depth, R) bool: direction of subtree d
    swap_u: torch.Tensor    # (max_depth, R) uniforms: subtree d's merge
    leaf_u: torch.Tensor    # (2^max_depth - 1, R) uniforms: leaf t's
                            # multinomial selection


def nuts_noise(generator, rows: int, dim: int, max_depth: int, dtype,
               device) -> NUTSNoise:
    """One draw's ``NUTSNoise`` from ``generator``."""
    def u(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    z = torch.randn((rows, dim), generator=generator, dtype=dtype,
                    device=device)
    return NUTSNoise(z=z, go_right=u(max_depth, rows) < 0.5,
                     swap_u=u(max_depth, rows),
                     leaf_u=u((1 << max_depth) - 1, rows))


def _is_turning(v_left, v_right, rho):
    """Generalized U-turn criterion per row: the velocity at either end
    anti-aligned with the momentum sum across the (sub)tree."""
    return ((torch.sum(v_left * rho, dim=-1) <= 0.0)
            | (torch.sum(v_right * rho, dim=-1) <= 0.0))


def _sel(pred, a, b):
    """Row-wise select of two equally shaped states (pred (R,))."""
    def one(x, y):
        m = pred.reshape(pred.shape + (1,) * (x.ndim - 1))
        return torch.where(m, x, y)
    return type(a)(*(one(x, y) for x, y in zip(a, b)))


class _FlatState(NamedTuple):
    """Per-row state of the flat tree builder (the JAX package's
    _FlatState; the keys become ``NUTSNoise`` and the leaf counter i is
    known on the host)."""
    depth: torch.Tensor
    z_minus: _EdgeState
    z_plus: _EdgeState
    prop_q: torch.Tensor
    prop_logp: torch.Tensor
    prop_grad: torch.Tensor
    prop_kin: torch.Tensor
    logw: torch.Tensor
    rho: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_acc: torch.Tensor
    n_leaves: torch.Tensor
    z: _EdgeState
    sprop_q: torch.Tensor
    sprop_logp: torch.Tensor
    sprop_grad: torch.Tensor
    sprop_kin: torch.Tensor
    slogw: torch.Tensor
    srho: torch.Tensor
    v_ck: torch.Tensor      # (max_depth, R, D): checkpoint velocities for
    rho_ck: torch.Tensor    # subtree sizes 2^1..2^max_depth
    sfirst_p: torch.Tensor  # momentum of the subtree's first leaf
    sturn: torch.Tensor
    sdiv: torch.Tensor
    ssum: torch.Tensor
    go_right: torch.Tensor


def _flat_init(q, logp, grad, p0, kin0, n_ck: int) -> _FlatState:
    """Fresh tree state at the start of a draw (momentum p0 already drawn;
    kin0 = kinetic(p0)). ``n_ck`` = max_depth checkpoint rows."""
    R, dim = q.shape
    z0 = _EdgeState(q=q, p=p0, grad=grad, logp=logp)
    zeros_r = torch.zeros_like(logp)
    false_r = torch.zeros(R, dtype=torch.bool, device=q.device)
    ints = torch.zeros(R, dtype=torch.int32, device=q.device)
    return _FlatState(
        depth=ints, z_minus=z0, z_plus=z0, prop_q=q, prop_logp=logp,
        prop_grad=grad, prop_kin=kin0, logw=zeros_r, rho=p0,
        turning=false_r, diverging=false_r, sum_acc=zeros_r,
        n_leaves=ints, z=z0, sprop_q=q, sprop_logp=logp, sprop_grad=grad,
        sprop_kin=zeros_r, slogw=torch.full_like(logp, -math.inf),
        srho=torch.zeros_like(q),
        v_ck=torch.zeros((n_ck, R, dim), dtype=q.dtype, device=q.device),
        rho_ck=torch.zeros((n_ck, R, dim), dtype=q.dtype, device=q.device),
        sfirst_p=p0, sturn=false_r, sdiv=false_r, ssum=zeros_r,
        go_right=false_r)


def _leaf_position(t: int):
    """(depth, index within the subtree) of the tree's t-th leaf: subtree
    d holds leaves 2^d - 1 .. 2^(d+1) - 2."""
    depth = (t + 1).bit_length() - 1
    return depth, t - ((1 << depth) - 1)


def _flat_alive(st: _FlatState, max_depth: int):
    return (st.depth < max_depth) & (~st.turning) & (~st.diverging)


def _flat_body(value_and_grad, st: _FlatState, t: int, noise: NUTSNoise,
               eps, m_inv, H0, max_depth: int,
               max_energy_error) -> _FlatState:
    """The tree's t-th leapfrog for every row: subtree start, one leaf,
    and the merge into the tree when the subtree ends. Rows that are not
    alive change no field that reaches the draw."""
    depth_t, i = _leaf_position(t)
    n_sub = 1 << depth_t
    al = _flat_alive(st, max_depth)
    z, go_right = st.z, st.go_right
    slogw, srho, sturn, sdiv, ssum = (st.slogw, st.srho, st.sturn, st.sdiv,
                                      st.ssum)
    if i == 0:                       # subtree start: direction, reset
        go_right = noise.go_right[depth_t]
        z = _sel(go_right, st.z_plus, st.z_minus)
        slogw = torch.full_like(slogw, -math.inf)
        srho = torch.zeros_like(srho)
        sturn = torch.zeros_like(sturn)
        sdiv = torch.zeros_like(sdiv)
        ssum = torch.zeros_like(ssum)
    e = torch.where(go_right, eps, -eps)[:, None]

    # ---- one leaf ----
    p_half = z.p + 0.5 * e * z.grad
    q_new = z.q + e * _vel(p_half, m_inv)
    lp_new, g_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * e * g_new
    v_new = _vel(p_new, m_inv)
    kin = 0.5 * torch.sum(p_new * v_new, dim=-1)
    H = -lp_new + kin
    nan_h = torch.isnan(H)
    w = torch.where(nan_h, torch.full_like(H, -math.inf), H0 - H)
    div_leaf = ((H - H0) > max_energy_error) | nan_h

    slogw_new = torch.logaddexp(slogw, w)
    take = torch.log(noise.leaf_u[t]) < (w - slogw_new)
    tk = take[:, None]
    sprop_q = torch.where(tk, q_new, st.sprop_q)
    sprop_logp = torch.where(take, lp_new, st.sprop_logp)
    sprop_grad = torch.where(tk, g_new, st.sprop_grad)
    sprop_kin = torch.where(take, kin, st.sprop_kin)
    sfirst_p = p_new if i == 0 else st.sfirst_p

    # checkpoints of the subtrees this leaf starts, U-turn checks of those
    # it completes (sizes 2^1..2^max_depth; size-1 subtrees never turn)
    v_ck, rho_ck = st.v_ck, st.rho_ck
    for k in range(max_depth):
        if (2 << k) <= n_sub and i % (2 << k) == 0:
            v_ck[k] = v_new
            rho_ck[k] = srho
    srho = srho + p_new
    for k in range(max_depth):
        if (2 << k) <= n_sub and (i + 1) % (2 << k) == 0:
            rho_sub = srho - rho_ck[k]
            sturn = sturn | (torch.sum(v_ck[k] * rho_sub, dim=-1) <= 0.0) | (
                torch.sum(rho_sub * v_new, dim=-1) <= 0.0)
    sdiv = sdiv | div_leaf
    ssum = ssum + torch.clamp(torch.exp(w), max=1.0)
    z = _EdgeState(q=q_new, p=p_new, grad=g_new, logp=lp_new)
    n_done = i + 1

    prop_q, prop_logp, prop_grad, prop_kin = (st.prop_q, st.prop_logp,
                                              st.prop_grad, st.prop_kin)
    logw, rho, z_plus, z_minus = st.logw, st.rho, st.z_plus, st.z_minus
    if n_done < n_sub:
        # mid-subtree: a row whose subtree turned or diverged ends its
        # tree here (its subtree is never merged, so only the counters,
        # flags and depth move)
        upd = al & (sturn | sdiv)
        sum_acc = torch.where(upd, st.sum_acc + ssum, st.sum_acc)
        n_leaves = torch.where(upd, st.n_leaves + n_done, st.n_leaves)
        turning = torch.where(upd, sturn, st.turning)
        diverging = torch.where(upd, st.diverging | sdiv, st.diverging)
        depth = torch.where(upd, st.depth + 1, st.depth)
    else:
        # subtree complete for every live row: biased progressive
        # sampling between the tree and the subtree, then the merge
        ok = (~sturn) & (~sdiv)
        upd_ok = al & ok
        sum_acc = torch.where(al, st.sum_acc + ssum, st.sum_acc)
        n_leaves = torch.where(al, st.n_leaves + n_done, st.n_leaves)
        swap = torch.log(noise.swap_u[depth_t]) < (slogw_new - logw)
        acc = upd_ok & swap
        a1 = acc[:, None]
        prop_q = torch.where(a1, sprop_q, prop_q)
        prop_logp = torch.where(acc, sprop_logp, prop_logp)
        prop_grad = torch.where(a1, sprop_grad, prop_grad)
        prop_kin = torch.where(acc, sprop_kin, prop_kin)
        logw = torch.where(upd_ok, torch.logaddexp(logw, slogw_new), logw)
        old_plus, old_minus = z_plus, z_minus
        z_plus = _sel(upd_ok & go_right, z, z_plus)
        z_minus = _sel(upd_ok & ~go_right, z, z_minus)
        rho_new = rho + srho
        merged_turn = _is_turning(_vel(z_minus.p, m_inv),
                                  _vel(z_plus.p, m_inv), rho_new)
        gr = go_right[:, None]
        inner_old_p = torch.where(gr, old_plus.p, old_minus.p)
        rho_lx = rho + sfirst_p
        turn_lx = _is_turning(
            _vel(torch.where(gr, old_minus.p, sfirst_p), m_inv),
            _vel(torch.where(gr, sfirst_p, old_plus.p), m_inv), rho_lx)
        rho_rx = srho + inner_old_p
        turn_rx = _is_turning(
            _vel(torch.where(gr, inner_old_p, z.p), m_inv),
            _vel(torch.where(gr, z.p, inner_old_p), m_inv), rho_rx)
        merged_turn = merged_turn | turn_lx | turn_rx
        rho = torch.where(upd_ok[:, None], rho_new, rho)
        turning = torch.where(al, sturn | (ok & merged_turn), st.turning)
        diverging = torch.where(al, st.diverging | sdiv, st.diverging)
        depth = torch.where(al, st.depth + 1, st.depth)

    return _FlatState(
        depth=depth, z_minus=z_minus, z_plus=z_plus, prop_q=prop_q,
        prop_logp=prop_logp, prop_grad=prop_grad, prop_kin=prop_kin,
        logw=logw, rho=rho, turning=turning, diverging=diverging,
        sum_acc=sum_acc, n_leaves=n_leaves, z=z, sprop_q=sprop_q,
        sprop_logp=sprop_logp, sprop_grad=sprop_grad, sprop_kin=sprop_kin,
        slogw=slogw_new, srho=srho, v_ck=v_ck, rho_ck=rho_ck,
        sfirst_p=sfirst_p, sturn=sturn, sdiv=sdiv, ssum=ssum,
        go_right=go_right)


def _subtree(value_and_grad, st: _FlatState, d: int, noise: NUTSNoise,
             eps, m_inv, H0, max_depth: int,
             max_energy_error) -> _FlatState:
    """Subtree d of the tree (its leaves 2^d - 1 .. 2^(d+1) - 2) for every
    row."""
    for t in range((1 << d) - 1, (1 << (d + 1)) - 1):
        st = _flat_body(value_and_grad, st, t, noise, eps, m_inv, H0,
                        max_depth, max_energy_error)
    return st


def nuts_transition_flat(value_and_grad, q, logp, grad, noise: NUTSNoise,
                         eps, m_inv, max_depth: int = 10,
                         max_energy_error: float = 1000.0,
                         tree_scan: bool = False, mass_chol=None):
    """One NUTS draw for every row.

    q, grad (R, D); logp, eps (R,); ``m_inv`` a metric of any form
    (``mass_chol`` its Cholesky factor when dense); ``noise`` the draw's
    random numbers. ``tree_scan`` runs the static 2^max_depth - 1 leaves;
    otherwise the tree stops at the first subtree boundary where no row is
    alive, checked on the host (the extra leaves of the static form are
    masked and change nothing, so both give the same draws). Returns (q,
    logp, grad, NUTSInfo) of the selected points."""
    p0 = _sample_momentum(noise.z, m_inv, mass_chol)
    st, H0 = _tree_start(q, logp, grad, p0, m_inv, max_depth)
    for d in range(max_depth):
        if not tree_scan and d > 0 and not bool(
                _flat_alive(st, max_depth).any()):
            break
        st = _subtree(value_and_grad, st, d, noise, eps, m_inv, H0,
                      max_depth, max_energy_error)
    return _tree_result(st)


def nuts_transition(value_and_grad, q, logp, grad, noise: NUTSNoise, eps,
                    m_inv, max_depth: int = 10,
                    max_energy_error: float = 1000.0, mass_chol=None,
                    unroll: int = 1):
    """One NUTS draw in the JAX package's ``nuts_transition`` argument
    order, the key replaced by the draw's ``NUTSNoise``: the flat
    transition (``nuts_transition_flat``, early stop), which gives the
    JAX package's recursive form's draws. Rows q, grad (R, D); logp, eps
    (R,). ``unroll`` tunes the JAX package's loop and has no effect.
    Returns (q, logp, grad, NUTSInfo)."""
    return nuts_transition_flat(value_and_grad, q, logp, grad, noise, eps,
                                m_inv, max_depth=max_depth,
                                max_energy_error=max_energy_error,
                                tree_scan=False, mass_chol=mass_chol)


def _tree_start(q, logp, grad, p0, m_inv, max_depth):
    """The fresh tree state of a draw with momentum p0, and H0 per row."""
    kin0 = _kinetic(p0, m_inv)
    return _flat_init(q, logp, grad, p0, kin0, max_depth), -logp + kin0


def _tree_result(st: _FlatState):
    """(q, logp, grad, NUTSInfo) of a finished tree's selected points."""
    accept_prob = st.sum_acc / torch.clamp(st.n_leaves, min=1).to(
        st.sum_acc.dtype)
    info = NUTSInfo(accept_prob=accept_prob, diverging=st.diverging,
                    n_leapfrog=st.n_leaves,
                    energy=-st.prop_logp + st.prop_kin,
                    tree_depth=st.depth)
    return st.prop_q, st.prop_logp, st.prop_grad, info


class GraphedTree:
    """``nuts_transition_flat`` for fixed shapes as CUDA graphs, one per
    subtree (``_subtree``), captured in order into one memory pool and
    replayed per draw: a tree's thousands of small launches leave the host
    in at most ``max_depth`` calls. With ``early_stop`` the replay stops
    where the eager early-stop form does, at the first subtree boundary
    where no row is alive; without it every depth runs (the static
    ``tree_scan`` form). Both give the draws of the eager forms.

    The constructor's arguments fix the shapes, dtype, the metric's form
    and the ``value_and_grad`` closure, whose own tensors must stay alive
    and in place (a progcache runner's buffers). A call draws the momentum
    (a triangular solve for a dense metric), copies the draw's inputs into
    the graphs' buffers, replays, and returns copies of the outputs."""

    def __init__(self, value_and_grad, q, logp, grad, noise, eps, m_inv,
                 max_depth: int, max_energy_error: float,
                 early_stop: bool = False, mass_chol=None):
        if q.device.type != "cuda":
            raise ValueError("GraphedTree runs on a CUDA device")
        self._max_depth = max_depth
        self._early_stop = early_stop
        p0 = _sample_momentum(noise.z, m_inv, mass_chol)
        self._inp = [t.clone() for t in (q, logp, grad, p0, *noise[1:], eps,
                                         m_inv)]
        q_, lp_, g_, p_, gr_, sw_, lu_, e_, m_ = self._inp
        nz = NUTSNoise(p_, gr_, sw_, lu_)

        def start():
            return _tree_start(q_, lp_, g_, p_, m_, max_depth)

        def subtree(d, st, H0):
            return _subtree(value_and_grad, st, d, nz, e_, m_, H0,
                            max_depth, max_energy_error)

        side = torch.cuda.Stream(device=q.device)
        side.wait_stream(torch.cuda.current_stream(q.device))
        with torch.cuda.stream(side):      # first use of every op off-graph
            st, H0 = start()
            for d in range(max_depth):
                st = subtree(d, st, H0)
        torch.cuda.current_stream(q.device).wait_stream(side)
        self.pool_id = torch.cuda.graph_pool_handle()
        self._graphs, self._states = [], []
        for d in range(max_depth):
            g = torch.cuda.CUDAGraph()
            with graph_capture(g, q.device, pool=self.pool_id):
                if d == 0:
                    st, self._H0 = start()
                st = subtree(d, st, self._H0)
            self._graphs.append(g)
            self._states.append(st)

    def __call__(self, q, logp, grad, noise, eps, m_inv, mass_chol=None):
        p0 = _sample_momentum(noise.z, m_inv, mass_chol)
        for dst, src in zip(self._inp, (q, logp, grad, p0, *noise[1:], eps,
                                        m_inv)):
            dst.copy_(src)
        for g, st in zip(self._graphs, self._states):
            g.replay()
            if self._early_stop and not bool(
                    _flat_alive(st, self._max_depth).any()):
                break
        q_o, lp_o, g_o, info = _tree_result(st)
        return (q_o.clone(), lp_o.clone(), g_o.clone(),
                NUTSInfo(*(t.clone() for t in info)))


def generator_nuts_noise(generator, rows, dim, max_depth, dtype, device,
                         draws: int):
    """The default noise stream of ``sample_nuts``: the step-size search's
    momentum normals (R, D) once, then one ``NUTSNoise`` per draw."""
    def stream():
        yield torch.randn((rows, dim), generator=generator, dtype=dtype,
                          device=device)
        for _ in range(draws):
            yield nuts_noise(generator, rows, dim, max_depth, dtype, device)
    return stream


def _initial_metric(metric, cfg, rows, dim, dtype, dev):
    """(m_inv, mass_chol) a run starts from. ``metric``: None (unit
    diagonal, or the unit dense per row with ``dense_mass``); a (D,)
    vector or an (R, D) array of diagonals; a dense (D, D) or (R, D, D)
    matrix, or an (m_inv, chol) pair of either (a square metric with
    R == D must be passed as a pair). A dense metric adapted per row
    (``dense_mass`` with ``adapt_mass``) starts per row."""
    def t(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    if metric is None:
        if cfg.dense_mass:
            eye = torch.eye(dim, dtype=dtype, device=dev).expand(rows, dim,
                                                                 dim)
            return eye.contiguous(), eye.contiguous()
        return torch.ones((rows, dim), dtype=dtype, device=dev), None
    if isinstance(metric, (tuple, list)):
        m_inv, chol = t(metric[0]), t(metric[1])
    else:
        m_inv = t(metric)
        chol = None
        if m_inv.ndim == 1:
            m_inv = m_inv.expand(rows, dim)
        if m_inv.ndim == 2 and tuple(m_inv.shape) == (rows, dim):
            if cfg.dense_mass and cfg.adapt_mass:
                m_inv = torch.diag_embed(m_inv)
            else:
                return m_inv.contiguous(), None
    if m_inv.ndim == 2:
        m_inv = m_inv[None]
    if chol is None:
        chol = torch.linalg.cholesky(m_inv)
    elif chol.ndim == 2:
        chol = chol[None]
    if cfg.adapt_mass:
        if not cfg.dense_mass:
            raise ValueError("a dense metric adapts only with "
                             "NUTSConfig(dense_mass=True); pass "
                             "adapt_mass=False to hold it fixed")
        m_inv = m_inv.expand(rows, dim, dim)
        chol = chol.expand(rows, dim, dim)
    return m_inv.contiguous(), chol.contiguous()


def sample_nuts(value_and_grad, q0, warmup: int = 200, samples: int = 200,
                cfg: NUTSConfig = NUTSConfig(), generator=None, noise=None,
                metric=None, init_step_size=1.0, time_draws: bool = False,
                graphs=None):
    """NUTS for R chains at once, each with its own step size and metric:
    warmup with dual-averaging step-size and windowed mass adaptation
    (keeping only its divergence flags), then sampling.

    q0 (R, D); ``value_and_grad(q)`` returns (logp (R,), grad (R, D)).
    ``noise`` is a zero-argument callable returning an iterator that yields
    the step-size search's momentum normals (R, D) once and then one
    ``NUTSNoise`` per draw; by default it draws from ``generator``.
    ``metric`` is the initial (with ``cfg.adapt_mass=False``, the fixed)
    inverse metric (``_initial_metric`` lists its forms: a diagonal, a
    dense matrix shared by every row, or one per row); ``init_step_size``
    (a float or per-row (R,)) seeds the step-size search. The dual
    averaging's eps_bar starts at the searched step size, so a resume with
    ``warmup=0`` samples there. ``time_draws`` records each draw's
    host-clock seconds, closed by a device synchronize, under
    ``info['draw_s']``, and the graph captures' under ``info['capture_s']``.
    On a CUDA device each draw's tree is replayed as CUDA graphs
    (``GraphedTree``, captured at the first draw: 6 to 8 times faster than
    eager launches on an H100); ``graphs`` (a progcache runner's dict)
    keeps the tree across calls, keyed on what shapes it, and takes it
    from there when present, so ``value_and_grad`` must then be the
    runner's function. On the CPU the tree runs eagerly. Returns (draws
    (S, R, D), info with per-draw (S, R) fields, per-row step_size,
    inv_mass in the metric's form and warmup_diverging (W, R))."""
    cfg.validate()
    rows, dim = q0.shape
    dtype, dev = q0.dtype, q0.device
    total = warmup + samples
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a noise stream")
        noise = generator_nuts_noise(generator, rows, dim, cfg.max_depth,
                                     dtype, dev, total)
    stream = noise()

    q = q0
    logp, grad = value_and_grad(q0)
    m_inv, chol = _initial_metric(metric, cfg, rows, dim, dtype, dev)
    eps_init = torch.as_tensor(init_step_size, device=dev).to(dtype)
    eps0 = find_reasonable_step_size(value_and_grad, q0, logp, grad,
                                     next(stream), m_inv, init_eps=eps_init,
                                     mass_chol=chol)
    if cfg.fused_draws:
        warnings.warn(
            "NUTSConfig(fused_draws=True) runs the flat form, which gives "
            "the JAX package's fused draws; it is kept only for "
            "API/algorithm completeness. Use tree_scan=True instead.",
            stacklevel=2)
    if cfg.adapt_mass:
        in_slow, win_end = _window_flags(warmup, cfg)
    else:
        in_slow = win_end = np.zeros(warmup, bool)
    dense = m_inv.ndim == 3
    da = _da_init(eps0)
    wf = _welford_init(rows, dim, dtype, dev, dense and cfg.adapt_mass)

    draws = torch.empty((samples, rows, dim), dtype=dtype, device=dev)
    keep = {k: torch.empty((samples, rows), dtype=dt, device=dev)
            for k, dt in (("logp", dtype), ("accept_prob", dtype),
                          ("diverging", torch.bool),
                          ("n_leapfrog", torch.int32), ("energy", dtype))}
    warm_div = torch.empty((warmup, rows), dtype=torch.bool, device=dev)
    clock = StageTimer(dev, on=time_draws)
    tree = None
    tree_key = ("tree", rows, dim, str(dtype), str(dev), cfg.max_depth,
                float(cfg.max_energy_error), not cfg.tree_scan,
                metric_form(m_inv))
    if graphs is not None:
        tree = graphs.get(tree_key)
    for t in range(total):
        with clock.stage("draw"):
            warm = t < warmup
            eps = torch.exp(da.log_eps if warm else da.log_eps_bar)
            nz = next(stream)
            if dev.type == "cuda":
                if tree is None:
                    with clock.stage("capture"):
                        tree = GraphedTree(value_and_grad, q, logp, grad, nz,
                                           eps, m_inv, cfg.max_depth,
                                           cfg.max_energy_error,
                                           early_stop=not cfg.tree_scan,
                                           mass_chol=chol)
                    if graphs is not None:
                        graphs[tree_key] = tree
                q, logp, grad, info = tree(q, logp, grad, nz, eps, m_inv, chol)
            else:
                q, logp, grad, info = nuts_transition_flat(
                    value_and_grad, q, logp, grad, nz, eps, m_inv,
                    max_depth=cfg.max_depth,
                    max_energy_error=cfg.max_energy_error,
                    tree_scan=cfg.tree_scan, mass_chol=chol)
            if warm:
                warm_div[t] = info.diverging
                da = _da_update(da, info.accept_prob, cfg)
                if cfg.adapt_mass:
                    if in_slow[t]:
                        wf = _welford_add(wf, q)
                    if win_end[t]:
                        m_inv, chol = _window_metric(wf, m_inv, chol)
                        wf = _welford_init(rows, dim, dtype, dev, dense)
                        da = _da_init(torch.exp(da.log_eps))
            else:
                s = t - warmup
                draws[s] = q
                keep["logp"][s] = logp
                keep["accept_prob"][s] = info.accept_prob
                keep["diverging"][s] = info.diverging
                keep["n_leapfrog"][s] = info.n_leapfrog
                keep["energy"][s] = info.energy
    out = dict(keep, step_size=torch.exp(da.log_eps_bar), inv_mass=m_inv,
               warmup_diverging=warm_div)
    if time_draws:
        out["draw_s"] = clock.laps.get("draw", [])
        out["capture_s"] = clock.laps.get("capture", [])
    return draws, out
