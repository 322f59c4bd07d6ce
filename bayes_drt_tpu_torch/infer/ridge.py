"""Batched ordinary and hyper-lambda ridge (port of
bayes_drt_tpu/infer/ridge.py:33-107,180-398).

Ordinary ridge is one box-QP solve; the Ciucci-Chen hierarchical
("hyper-lambda") ridge iterates analytic per-coordinate lambda updates
around a warm-started box QP (infer/nnls.py). Every function takes a
leading spectra axis on the per-spectrum fields of ``RidgeData``; the
JAX package's while_loop becomes a loop over the unfinished rows, so each
row's result equals its own single fit. The R_inf / inductance columns of
a series fit are added by the caller (parallel/batch.py).

Not ported (ROADMAP Queue 1 item 8): the dZ reweighting, the hyper-a/b
updates, the f-beta and LM lambda solutions and the hyper-weights
ridge.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .nnls import qp_cold_sets, solve_qp_box

_ITEM_8 = "is not ported yet (ROADMAP Queue 1 item 8)"


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


def _rows(data: RidgeData, idx) -> RidgeData:
    """The ridge data of the spectra ``idx``."""
    return data._replace(**{f: getattr(data, f)[idx] for f in _PER_SPECTRUM})


def _mv(M, v):
    """Batched matrix-vector product (B, m, n) x (B, n) -> (B, m)."""
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

    def validate(self) -> None:
        for name in ("use_dZ", "use_hyper_a", "use_hyper_b", "use_fbeta",
                     "use_lm"):
            if getattr(self, name):
                raise NotImplementedError(f"HyperLambdaConfig({name}=True) "
                                          + _ITEM_8)


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
                 state: HyperLambdaState):
    """One analytic lambda update for all three orders, (B, 3, K)."""
    coef_eff = state.coef / state.dZ_re
    # the hyper-a/b updates are not ported, so lambda_0 keeps its
    # initial form
    hyper_lam0 = _lambda0_from_ab(cfg, state.hyper_as, state.hyper_bs,
                                  False)
    hyper_beta = 2.0 * state.hyper_as
    nf = cfg.n_fixed

    def per_order(n, lam_prev):
        if cfg.penalty == "integral":
            factor = (100.0, 10.0, 1.0)[n]
            lv = hyper_lambda_integral(data.L2_base[n], factor * coef_eff,
                                       lam_prev, hyper_beta[:, n],
                                       hyper_lam0[:, n])
            return torch.clamp(lv, min=1e-15)
        lv = hyper_lambda_discrete(data.L_ops[n], coef_eff,
                                   hyper_beta[:, n, nf:],
                                   hyper_lam0[:, n, nf:])
        if nf > 0:
            lv = torch.cat([torch.ones_like(lv[:, :nf]), lv], dim=1)
        return lv

    return torch.stack([
        torch.where(data.reg_frac[n] > 0,
                    per_order(n, state.lam_vectors[:, n]),
                    state.lam_vectors[:, n])
        for n in range(3)], dim=1)


def run_hyper_lambda(cfg: HyperLambdaConfig, data: RidgeData, x0, hl_beta,
                     lambda_0, xtol: float = 1e-3,
                     delta_mask=None) -> RidgeResult:
    """Hierarchical-ridge fixed point iteration for B spectra.

    x0 (K,) or (B, K); hl_beta: (3,) per-order beta hyperparameters (or a
    scalar); lambda_0: scalar baseline regularization strength. A row
    stops at ``cfg.max_iter`` iterations or once the mean relative
    coefficient change (times ``delta_mask``) falls below ``xtol``; each
    iteration re-solves the box QP warm-started from the previous active
    set (the first from the equilibrated cold sets)."""
    cfg.validate()
    WA = data.WA_re
    b, k = WA.shape[0], WA.shape[-1]
    dt, dev = WA.dtype, WA.device
    hl_beta = torch.as_tensor(hl_beta, dtype=dt, device=dev).expand(3)
    a_list = hl_beta / 2.0
    if cfg.penalty == "integral":
        b_list = 0.5 * (2.0 * a_list - 2.0) / lambda_0
    else:
        b_list = 0.5 * (2.0 * a_list - 1.0) / lambda_0
    if delta_mask is None:
        delta_mask = torch.ones(k, dtype=dt, device=dev)
    st = HyperLambdaState(
        coef=torch.as_tensor(x0, dtype=dt, device=dev).expand(b, k).clone(),
        lam_vectors=torch.full((b, 3, k), float(lambda_0), dtype=dt,
                               device=dev),
        hyper_as=a_list[None, :, None].expand(b, 3, k).clone(),
        hyper_bs=b_list[None, :, None].expand(b, 3, k).clone(),
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
        dsub = _rows(data, idx)
        lam_new = _lambda_step(cfg, dsub, sub)
        P, q = assemble_qp(cfg.part, dsub, build_l2_matrix(dsub, lam_new,
                                                           sub.dZ_re))
        # active rows advance in lockstep, so they share the iteration
        # count: the first iteration seeds the QP with the cold sets
        if int(sub.it[0]) == 0:
            warm = qp_cold_sets(P, q, data.lb, data.ub)
        else:
            warm = (sub.at_lb, sub.at_ub)
        res = solve_qp_box(P, q, data.lb, data.ub, max_iter=cfg.qp_iter,
                           warm_sets=warm)
        prev = sub.coef
        safe_prev = torch.where(prev.abs() > 0, prev, torch.ones_like(prev))
        delta = torch.mean(((res.x - prev) / safe_prev * delta_mask).abs(),
                           dim=-1)
        new = sub._replace(coef=res.x, lam_vectors=lam_new, it=sub.it + 1,
                           delta=delta, at_lb=res.at_lb, at_ub=res.at_ub)
        fields = []
        for f_all, f_new in zip(st, new):
            f_all = f_all.clone()
            f_all[idx] = f_new
            fields.append(f_all)
        st = HyperLambdaState(*fields)
        act = active(st)

    P, q = assemble_qp(cfg.part, data,
                       build_l2_matrix(data, st.lam_vectors, st.dZ_re))
    cost = 0.5 * (st.coef * _mv(P, st.coef)).sum(-1) + (q * st.coef).sum(-1)
    zero = torch.zeros((), dtype=dt, device=dev)
    return RidgeResult(coef=st.coef, lam_vectors=st.lam_vectors, cost=cost,
                       n_iter=st.it, converged=st.delta < xtol,
                       weights_re=zero, weights_im=zero)


def run_ordinary_ridge(part: str, data: RidgeData, lambda_0,
                       qp_iter: int = 2000) -> RidgeResult:
    """One QP solve per spectrum with lam = lambda_0."""
    WA = data.WA_re
    b, k = WA.shape[0], WA.shape[-1]
    dt, dev = WA.dtype, WA.device
    lam = torch.full((b, 3, k), float(lambda_0), dtype=dt, device=dev)
    P, q = assemble_qp(part, data, build_l2_matrix(
        data, lam, torch.ones((b, k), dtype=dt, device=dev)))
    coef = solve_qp_box(P, q, data.lb, data.ub, max_iter=qp_iter).x
    cost = 0.5 * (coef * _mv(P, coef)).sum(-1) + (q * coef).sum(-1)
    zero = torch.zeros((), dtype=dt, device=dev)
    return RidgeResult(coef=coef, lam_vectors=lam, cost=cost,
                       n_iter=torch.ones(b, dtype=torch.int64, device=dev),
                       converged=torch.ones(b, dtype=torch.bool, device=dev),
                       weights_re=zero, weights_im=zero)


def run_hyper_weights(*args, **kwargs):
    """The Effat-Ciucci outlier-robust ("hyper-weights") ridge of the JAX
    package (infer/ridge.py:401): not ported yet."""
    raise NotImplementedError("run_hyper_weights " + _ITEM_8)
