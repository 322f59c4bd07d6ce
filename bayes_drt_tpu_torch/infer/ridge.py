"""Batched ordinary, hyper-lambda and hyper-weights ridge (port of
bayes_drt_tpu/infer/ridge.py).

Ordinary ridge is one box-QP solve; the Ciucci-Chen hierarchical
("hyper-lambda") ridge iterates per-coordinate lambda updates (analytic,
f-beta or the Levenberg-Marquardt solution, optionally with dZ
reweighting and MAP updates of the gamma hyperprior's shape a and rate
b) around a warm-started box QP (infer/nnls.py); the Effat-Ciucci
outlier-robust ("hyper-weights") ridge iterates MAP point weights
instead. Every function takes a leading spectra axis on the
per-spectrum fields of ``RidgeData``; the JAX package's while_loop
becomes a loop over the unfinished rows, so each row's result equals its
own single fit. The fixed inner loops (the LM solution's 40 steps, the
hyper-a golden-section search's 60) run on the device without a host
synchronization. The R_inf / inductance columns of a series fit are added
by the caller (parallel/batch.py, inverter.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .nnls import qp_cold_sets, solve_qp_box


class RidgeData(NamedTuple):
    """Numeric inputs to B ridge solves. The first four fields carry a
    leading spectra axis; the rest are shared by the batch."""
    WA_re: torch.Tensor    # (B, N, K) weighted real design
    WA_im: torch.Tensor    # (B, N, K) weighted imag design
    WT_re: torch.Tensor    # (B, N) weighted real target
    WT_im: torch.Tensor    # (B, N) weighted imag target
    L2_base: torch.Tensor  # (3, K, K): discrete L^T L or integral M
    L_ops: torch.Tensor    # (3, KL, K): raw L matrices (discrete updates)
    L1_vec: torch.Tensor   # (K,)
    reg_frac: torch.Tensor  # (3,) weights of the 0th/1st/2nd penalties
    lb: torch.Tensor       # (K,) lower bounds
    ub: torch.Tensor       # (K,) upper bounds


_PER_SPECTRUM = ("WA_re", "WA_im", "WT_re", "WT_im")


def ridge_rows(data: RidgeData, idx) -> RidgeData:
    """The ridge data of the spectra ``idx``."""
    return data._replace(**{f: getattr(data, f)[idx] for f in _PER_SPECTRUM})


def _mv(M, v):
    """Batched matrix-vector product (B, m, n) or (m, n) x (B, n) ->
    (B, m)."""
    return (M @ v[..., None])[..., 0]


def assemble_qp(part: str, data: RidgeData, L2_mat):
    """P (B, K, K), q (B, K) of the quadratic objective. A coordinate absent
    from both the design and the penalty (a zero diagonal) is pinned to 0,
    since a factorization solve of the singular system would poison every
    coordinate with NaNs."""
    ar_t = data.WA_re.transpose(-1, -2)
    ai_t = data.WA_im.transpose(-1, -2)
    if part == "both":
        P = ar_t @ data.WA_re + ai_t @ data.WA_im + L2_mat
        q = -_mv(ar_t, data.WT_re) - _mv(ai_t, data.WT_im) + data.L1_vec
    elif part == "real":
        P = ar_t @ data.WA_re + L2_mat
        q = -_mv(ar_t, data.WT_re) + data.L1_vec
    elif part == "imag":
        P = ai_t @ data.WA_im + L2_mat
        q = -_mv(ai_t, data.WT_im) + data.L1_vec
    else:
        raise ValueError(f"Invalid part {part!r}")
    dead = torch.diagonal(P, dim1=-2, dim2=-1) == 0.0
    P = P + torch.diag_embed(dead.to(P.dtype))
    q = torch.where(dead, torch.zeros_like(q), q)
    return P, q


def build_l2_matrix(data: RidgeData, lam_vectors, dZ_re):
    """L2_mat = sum_n frac_n * D lam_n^(1/2) L2b_n lam_n^(1/2) D with
    D = diag(1/dZ_re); lam_vectors (B, 3, K), dZ_re (B, K)."""
    scale = torch.sqrt(lam_vectors) / dZ_re[:, None, :]       # (B, 3, K)
    terms = scale[..., :, None] * data.L2_base * scale[..., None, :]
    return torch.einsum("n,bnij->bij", data.reg_frac, terms)


def hyper_lambda_discrete(L, coef, hl_beta, lambda_0):
    """lam = 1 / ((Lx)^2/(beta-1) + 1/lambda_0), per row of coef (B, K)."""
    Lx2 = (coef @ L.T) ** 2
    return 1.0 / (Lx2 / (hl_beta - 1.0) + 1.0 / lambda_0)


def hyper_lambda_fbeta(L, coef, hl_fbeta, lambda_0):
    """lam = lambda_0 / ((Lx)^2/(max (Lx)^2 * f_beta) + 1), per row of coef
    (B, K); lambda_0 a scalar or (B, 1)."""
    Lx2 = (coef @ L.T) ** 2
    return lambda_0 / (Lx2 / (Lx2.amax(dim=-1, keepdim=True) * hl_fbeta)
                       + 1.0)


def hyper_lambda_lm(L, coef, prev_lam, hl_beta, lambda_0, n_iter: int = 40):
    """Levenberg-Marquardt-style lambda solution: per-coordinate
    minimization of (a*lam - c*ln(lam))^2 with a = (Lx)^2 + (beta-1)/
    lambda_0 and c = beta - 1, started from the previous lambda, as a
    damped Newton iteration in u = ln(lam) of ``n_iter`` fixed steps.
    coef (B, K), prev_lam and hl_beta (B, KL), lambda_0 a scalar or
    (B, 1)."""
    Lx2 = (coef @ L.T) ** 2
    a = Lx2 + (hl_beta - 1.0) / lambda_0
    c = hl_beta - 1.0
    u = torch.log(torch.clamp(prev_lam, min=1e-15))
    for _ in range(n_iter):
        g = a * torch.exp(u) - c * u        # residual f(e^u)
        dg = a * torch.exp(u) - c           # df/du
        hess = dg * dg + g * a * torch.exp(u)
        step = g * dg / (hess.abs() + 1e-12)
        u = u - torch.clamp(step, -2.0, 2.0)
    return torch.exp(u)


def hyper_b_update(lam_vec, a, sb, n_basis):
    """MAP update of the gamma-prior rate b with b ~ N(0, sb): lam_vec
    (B, K), a (B,), sb a scalar -> (B,)."""
    lam_sum = lam_vec.sum(dim=-1)
    b = 0.25 * (torch.sqrt(16.0 * a * n_basis * sb ** 2
                           + 4.0 * sb ** 4 * lam_sum ** 2)
                - 2.0 * lam_sum * sb ** 2)
    return torch.clamp(b, min=1e-8)


def hyper_a_update(lam_vec, b, alpha_a, beta_a, n_iter: int = 60):
    """MAP update of the gamma-prior shape a by a golden-section search of
    ``n_iter`` fixed steps on (1, 5): lam_vec (B, K), b (B,), alpha_a and
    beta_a scalars -> (B,)."""
    log_bl = torch.log(b[:, None] * lam_vec).sum(dim=-1)

    def obj(a):
        return (-2.0 * a * log_bl + 2.0 * torch.lgamma(a)
                + 2.0 * beta_a * (a - 1.0)
                - 2.0 * (alpha_a - 1.0) * torch.log(a - 1.0))

    gr = (math.sqrt(5.0) - 1.0) / 2.0
    lo = torch.full_like(b, 1.0 + 1e-9)
    hi = torch.full_like(b, 5.0)
    for _ in range(n_iter):
        c = hi - gr * (hi - lo)
        d = lo + gr * (hi - lo)
        go_left = obj(c) < obj(d)
        lo, hi = torch.where(go_left, lo, c), torch.where(go_left, d, hi)
    return (lo + hi) / 2.0


def hyper_weights_update(coef, A_re, A_im, T_re, T_im, hw_beta, wbar_re,
                         wbar_im):
    """MAP weight update w = (wbar - 1/zeta)/(r^2/zeta + 1), zeta =
    beta/wbar: coef (B, K), A (N, K) or (B, N, K), T and wbar (B, N)."""
    zeta_re = hw_beta / wbar_re
    zeta_im = hw_beta / wbar_im
    r_re = T_re - _mv(A_re, coef)
    r_im = T_im - _mv(A_im, coef)
    w_re = (wbar_re - 1.0 / zeta_re) / (r_re ** 2 / zeta_re + 1.0)
    w_im = (wbar_im - 1.0 / zeta_im) / (r_im ** 2 / zeta_im + 1.0)
    return w_re, w_im


def hyper_lambda_integral(M, coef, lam_vec, hl_beta, lambda_0):
    """Quadratic-root lambda update for the integral penalty; coef and
    lam_vec (B, K), hl_beta/lambda_0 per coordinate."""
    dM = torch.diagonal(M)
    sl_coef = torch.sqrt(lam_vec) * coef
    s = sl_coef @ M.T - dM * sl_coef
    C = coef * s
    a = hl_beta / 2.0
    b = 0.5 * (2.0 * a - 2.0) / lambda_0
    d = coef ** 2 * dM + 2.0 * b
    disc = torch.sqrt(4.0 * d * (2.0 * a - 2.0) + C ** 2)
    return ((C ** 2 - torch.sign(C) * C * disc + 2.0 * d * (2.0 * a - 2.0))
            / (2.0 * d ** 2))


class HyperLambdaConfig(NamedTuple):
    """Static configuration for the hyper-lambda iteration."""
    part: str = "both"
    penalty: str = "discrete"       # 'discrete' | 'integral'
    use_fbeta: bool = False
    use_lm: bool = False
    n_fixed: int = 0                # leading coords excluded from lambda
                                    # updates (series: 2)
    max_iter: int = 20
    use_dZ: bool = False
    use_hyper_a: bool = False
    use_hyper_b: bool = False
    qp_iter: int = 2000


class HyperLambdaState(NamedTuple):
    coef: torch.Tensor         # (B, K)
    lam_vectors: torch.Tensor  # (B, 3, K)
    hyper_as: torch.Tensor     # (B, 3, K)
    hyper_bs: torch.Tensor     # (B, 3, K)
    dZ_re: torch.Tensor        # (B, K)
    it: torch.Tensor           # (B,)
    delta: torch.Tensor        # (B,)
    at_lb: torch.Tensor        # (B, K) QP active sets carried across
    at_ub: torch.Tensor        # outer iterations (warm-started re-solves)


class RidgeResult(NamedTuple):
    coef: torch.Tensor
    lam_vectors: torch.Tensor
    cost: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor
    weights_re: torch.Tensor
    weights_im: torch.Tensor


def _lambda0_from_ab(cfg: HyperLambdaConfig, hyper_as, hyper_bs, ab_updated):
    """lambda_0 implied by the gamma hyperprior shape/rate: (2a-2)/(2b)
    (integral) or (2a-1)/(2b) (discrete) at initialization, (2a-2)/b once
    the hyper-a/b updates have run."""
    if cfg.penalty == "integral":
        init = (2.0 * hyper_as - 2.0) / (2.0 * hyper_bs)
    else:
        init = (2.0 * hyper_as - 1.0) / (2.0 * hyper_bs)
    updated = (2.0 * hyper_as - 2.0) / hyper_bs
    return updated if ab_updated else init


def _lambda_step(cfg: HyperLambdaConfig, data: RidgeData,
                 state: HyperLambdaState, it: int, hl_fbeta, lambda_0):
    """One lambda update for all three orders, (B, 3, K). ``it`` is the
    rows' shared iteration count; ``lambda_0`` (B, 1) the rows' baseline
    strength (the f-beta and LM solutions take it as it is, the analytic
    ones the value implied by the hyperprior)."""
    coef_eff = state.coef / state.dZ_re
    ab_updated = it > 0 and (cfg.use_hyper_a or cfg.use_hyper_b)
    hyper_lam0 = _lambda0_from_ab(cfg, state.hyper_as, state.hyper_bs,
                                  ab_updated)
    hyper_beta = 2.0 * state.hyper_as
    nf = cfg.n_fixed

    def per_order(n, lam_prev):
        if cfg.penalty == "integral":
            factor = (100.0, 10.0, 1.0)[n]
            lv = hyper_lambda_integral(data.L2_base[n], factor * coef_eff,
                                       lam_prev, hyper_beta[:, n],
                                       hyper_lam0[:, n])
            return torch.clamp(lv, min=1e-15)
        if cfg.use_fbeta:
            lv = hyper_lambda_fbeta(data.L_ops[n], coef_eff, hl_fbeta,
                                    lambda_0)
        elif cfg.use_lm:
            # the LM branch takes the raw coefficients, without the dZ
            # division of the analytic branches
            lv = hyper_lambda_lm(data.L_ops[n], state.coef,
                                 lam_prev[:, nf:], hyper_beta[:, n, nf:],
                                 lambda_0)
        else:
            lv = hyper_lambda_discrete(data.L_ops[n], coef_eff,
                                       hyper_beta[:, n, nf:],
                                       hyper_lam0[:, n, nf:])
        # fixed leading coords (R_inf, inductance) keep lambda = 1
        if nf > 0:
            lv = torch.cat([torch.ones_like(lv[:, :nf]), lv], dim=1)
        return lv

    return torch.stack([
        torch.where(data.reg_frac[n] > 0,
                    per_order(n, state.lam_vectors[:, n]),
                    state.lam_vectors[:, n])
        for n in range(3)], dim=1)


def _per_row(x, b, dtype, device):
    """A scalar or (B,) value as a (B,) tensor."""
    return torch.as_tensor(x, dtype=dtype, device=device).expand(b).clone()


def _hyper_ab(cfg, st, it, sb, alpha_a, beta_a, n_basis):
    """The hyperprior's (a, b) of the rows ``st`` for iteration ``it``: the
    MAP updates of b, then of a given the new b, from the second
    iteration on."""
    h_as, h_bs = st.hyper_as, st.hyper_bs
    if it == 0:
        return h_as, h_bs
    k = h_as.shape[-1]
    if cfg.use_hyper_b:
        h_bs = torch.stack([
            hyper_b_update(st.lam_vectors[:, n], h_as[:, n, 0], sb[n],
                           n_basis)[:, None].expand(-1, k)
            for n in range(3)], dim=1)
    if cfg.use_hyper_a:
        h_as = torch.stack([
            hyper_a_update(st.lam_vectors[:, n], h_bs[:, n, 0], alpha_a[n],
                           beta_a[n])[:, None].expand(-1, k)
            for n in range(3)], dim=1)
    return h_as, h_bs


def run_hyper_lambda(cfg: HyperLambdaConfig, data: RidgeData, x0, hl_beta,
                     lambda_0, hl_fbeta=0.1, sb=None, alpha_a=None,
                     beta_a=None, B=None, dZ_scale=1.0, dZ_power=0.5,
                     xtol: float = 1e-3, delta_mask=None) -> RidgeResult:
    """Hierarchical-ridge fixed point iteration for B spectra.

    x0 (K,) or (B, K); hl_beta: (3,) per-order beta hyperparameters (or a
    scalar); lambda_0: the baseline regularization strength, a scalar or
    one per spectrum (B,); hl_fbeta: the f-beta solution's fraction
    (``cfg.use_fbeta``); sb, alpha_a, beta_a: (3,) hyperprior scales of
    the b and a updates (``cfg.use_hyper_b`` / ``use_hyper_a``); B: the
    (K - n_fixed, K) dZ'/dlntau matrix of the dZ reweighting
    (``cfg.use_dZ``), which weights coordinate k by |B x / dZ_scale|_k **
    dZ_power. A row stops at ``cfg.max_iter`` iterations or once the mean
    relative coefficient change (times ``delta_mask``) falls below
    ``xtol``; each iteration re-solves the box QP warm-started from the
    previous active set (the first from the equilibrated cold sets)."""
    WA = data.WA_re
    b, k = WA.shape[0], WA.shape[-1]
    dt, dev = WA.dtype, WA.device

    def vec3(v, default):
        return torch.as_tensor(default if v is None else v, dtype=dt,
                               device=dev).expand(3)

    hl_beta = vec3(hl_beta, None)
    sb, alpha_a, beta_a = (vec3(sb, 1.0), vec3(alpha_a, 2.0),
                           vec3(beta_a, 2.0))
    lam0 = _per_row(lambda_0, b, dt, dev)
    a_list = hl_beta / 2.0
    if cfg.penalty == "integral":
        b_list = 0.5 * (2.0 * a_list - 2.0) / lam0[:, None]
    else:
        b_list = 0.5 * (2.0 * a_list - 1.0) / lam0[:, None]
    if delta_mask is None:
        delta_mask = torch.ones(k, dtype=dt, device=dev)
    if cfg.use_dZ:
        B = torch.as_tensor(B, device=dev).to(dt)
    n_basis = k - cfg.n_fixed
    st = HyperLambdaState(
        coef=torch.as_tensor(x0, device=dev).to(dt).expand(b, k).clone(),
        lam_vectors=lam0[:, None, None].expand(b, 3, k).clone(),
        hyper_as=a_list[None, :, None].expand(b, 3, k).clone(),
        hyper_bs=b_list[:, :, None].expand(b, 3, k).clone(),
        dZ_re=torch.ones((b, k), dtype=dt, device=dev),
        it=torch.zeros(b, dtype=torch.int64, device=dev),
        delta=torch.full((b,), float("inf"), dtype=dt, device=dev),
        at_lb=torch.zeros((b, k), dtype=torch.bool, device=dev),
        at_ub=torch.zeros((b, k), dtype=torch.bool, device=dev))

    def active(s):
        return (s.it < cfg.max_iter) & (s.delta >= xtol)

    act = active(st)
    while bool(act.any()):
        idx = torch.nonzero(act).flatten()
        sub = HyperLambdaState(*(f[idx] for f in st))
        dsub = ridge_rows(data, idx)
        # active rows advance in lockstep, so they share the iteration
        # count
        it = int(sub.it[0])
        prev = sub.coef
        if cfg.use_dZ and it > 0:
            tail = ((prev @ B.T) / dZ_scale).abs() ** dZ_power
            sub = sub._replace(dZ_re=torch.cat(
                [torch.ones_like(prev[:, :cfg.n_fixed]),
                 torch.clamp(tail, min=1e-8)], dim=1))
        h_as, h_bs = _hyper_ab(cfg, sub, it, sb, alpha_a, beta_a, n_basis)
        sub = sub._replace(hyper_as=h_as, hyper_bs=h_bs)
        lam_new = _lambda_step(cfg, dsub, sub, it, hl_fbeta,
                               lam0[idx, None])
        P, q = assemble_qp(cfg.part, dsub, build_l2_matrix(dsub, lam_new,
                                                           sub.dZ_re))
        # the first iteration seeds the QP with the cold sets
        if it == 0:
            warm = qp_cold_sets(P, q, data.lb, data.ub)
        else:
            warm = (sub.at_lb, sub.at_ub)
        res = solve_qp_box(P, q, data.lb, data.ub, max_iter=cfg.qp_iter,
                           warm_sets=warm)
        safe_prev = torch.where(prev.abs() > 0, prev, torch.ones_like(prev))
        delta = torch.mean(((res.x - prev) / safe_prev * delta_mask).abs(),
                           dim=-1)
        new = sub._replace(coef=res.x, lam_vectors=lam_new, it=sub.it + 1,
                           delta=delta, at_lb=res.at_lb, at_ub=res.at_ub)
        st = HyperLambdaState(*(_scatter(f_all, idx, f_new)
                                for f_all, f_new in zip(st, new)))
        act = active(st)

    P, q = assemble_qp(cfg.part, data,
                       build_l2_matrix(data, st.lam_vectors, st.dZ_re))
    cost = 0.5 * (st.coef * _mv(P, st.coef)).sum(-1) + (q * st.coef).sum(-1)
    zero = torch.zeros((), dtype=dt, device=dev)
    return RidgeResult(coef=st.coef, lam_vectors=st.lam_vectors, cost=cost,
                       n_iter=st.it, converged=st.delta < xtol,
                       weights_re=zero, weights_im=zero)


def _scatter(full, idx, rows):
    """A copy of ``full`` with its rows ``idx`` replaced by ``rows``."""
    full = full.clone()
    full[idx] = rows
    return full


def run_ordinary_ridge(part: str, data: RidgeData, lambda_0,
                       qp_iter: int = 2000) -> RidgeResult:
    """One QP solve per spectrum with lam = lambda_0 (a scalar or one per
    spectrum, (B,))."""
    WA = data.WA_re
    b, k = WA.shape[0], WA.shape[-1]
    dt, dev = WA.dtype, WA.device
    lam = _per_row(lambda_0, b, dt, dev)[:, None, None].expand(b, 3, k)
    P, q = assemble_qp(part, data, build_l2_matrix(
        data, lam, torch.ones((b, k), dtype=dt, device=dev)))
    coef = solve_qp_box(P, q, data.lb, data.ub, max_iter=qp_iter).x
    cost = 0.5 * (coef * _mv(P, coef)).sum(-1) + (q * coef).sum(-1)
    zero = torch.zeros((), dtype=dt, device=dev)
    return RidgeResult(coef=coef, lam_vectors=lam, cost=cost,
                       n_iter=torch.ones(b, dtype=torch.int64, device=dev),
                       converged=torch.ones(b, dtype=torch.bool, device=dev),
                       weights_re=zero, weights_im=zero)


def run_hyper_weights(part: str, data: RidgeData, A_re, A_im, T_re, T_im,
                      lambda_0, hw_beta, wbar_re, wbar_im,
                      max_iter: int = 20, xtol: float = 1e-3,
                      delta_mask=None, qp_iter: int = 2000) -> RidgeResult:
    """The Effat-Ciucci outlier-robust ("hyper-weights") iteration for B
    spectra: the point weights start at the prior means ``wbar`` (B, N)
    and, from the second iteration on, take their MAP update against the
    residuals before each warm-started QP re-solve at lam = lambda_0 (a
    scalar or one per spectrum).

    A_re/A_im (N, K) or (B, N, K) and T_re/T_im (B, N) are the
    *unweighted* design and target; ``data`` supplies the penalty, bounds
    and L1 vector (its weighted fields are replaced). A row stops as in
    ``run_hyper_lambda``. Returns the final weights in ``weights_re`` /
    ``weights_im`` (B, N)."""
    b, k = T_re.shape[0], A_re.shape[-1]
    dt, dev = T_re.dtype, T_re.device
    lam = _per_row(lambda_0, b, dt, dev)[:, None, None].expand(b, 3, k)
    L2_mat = build_l2_matrix(data, lam, torch.ones((b, k), dtype=dt,
                                                   device=dev))
    if delta_mask is None:
        delta_mask = torch.ones(k, dtype=dt, device=dev)

    def rows(A, idx):
        return A if A.ndim == 2 else A[idx]

    def assemble_with(idx, w_re, w_im):
        d = data._replace(WA_re=w_re[:, :, None] * rows(A_re, idx),
                          WA_im=w_im[:, :, None] * rows(A_im, idx),
                          WT_re=w_re * T_re[idx], WT_im=w_im * T_im[idx])
        return assemble_qp(part, d, L2_mat[idx])

    coef = torch.full((b, k), 1e-6, dtype=dt, device=dev)
    w_re, w_im = wbar_re.clone(), wbar_im.clone()
    it = torch.zeros(b, dtype=torch.int64, device=dev)
    delta = torch.full((b,), float("inf"), dtype=dt, device=dev)
    at_lb = torch.zeros((b, k), dtype=torch.bool, device=dev)
    at_ub = torch.zeros_like(at_lb)
    act = (it < max_iter) & (delta >= xtol)
    while bool(act.any()):
        idx = torch.nonzero(act).flatten()
        c_prev, wr, wi = coef[idx], w_re[idx], w_im[idx]
        first = int(it[idx[0]]) == 0     # active rows run in lockstep
        if not first:
            wr, wi = hyper_weights_update(c_prev, rows(A_re, idx),
                                          rows(A_im, idx), T_re[idx],
                                          T_im[idx], hw_beta, wbar_re[idx],
                                          wbar_im[idx])
        P, q = assemble_with(idx, wr, wi)
        warm = (qp_cold_sets(P, q, data.lb, data.ub) if first
                else (at_lb[idx], at_ub[idx]))
        res = solve_qp_box(P, q, data.lb, data.ub, max_iter=qp_iter,
                           warm_sets=warm)
        safe_prev = torch.where(c_prev.abs() > 0, c_prev,
                                torch.ones_like(c_prev))
        d_new = torch.mean(((res.x - c_prev) / safe_prev
                            * delta_mask).abs(), dim=-1)
        coef, w_re, w_im = (_scatter(coef, idx, res.x),
                            _scatter(w_re, idx, wr), _scatter(w_im, idx, wi))
        delta = _scatter(delta, idx, d_new)
        at_lb = _scatter(at_lb, idx, res.at_lb)
        at_ub = _scatter(at_ub, idx, res.at_ub)
        it = _scatter(it, idx, it[idx] + 1)
        act = (it < max_iter) & (delta >= xtol)

    all_rows = torch.arange(b, device=dev)
    P, q = assemble_with(all_rows, w_re, w_im)
    cost = 0.5 * (coef * _mv(P, coef)).sum(-1) + (q * coef).sum(-1)
    return RidgeResult(coef=coef, lam_vectors=lam, cost=cost, n_iter=it,
                       converged=delta < xtol, weights_re=w_re,
                       weights_im=w_im)
