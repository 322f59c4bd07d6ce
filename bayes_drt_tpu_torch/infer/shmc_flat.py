"""Flat-chain static multinomial HMC with a hand-written CUDA trajectory
kernel (port of bayes_drt_tpu/infer/shmc_flat.py).

The batch of B spectra x C chains runs as one (B*C, D) chain axis. Each
draw's whole n-leapfrog trajectory is one launch of csrc/traj.cu, which
keeps each row's state in registers and shared memory. The kernel needs
the posterior's value and gradient written out by hand; that is
tractable for the single series-DRT model (the Stan
``Series``/``Series_pos`` model), centered or non-centered.
``flat_value_and_grad`` is that hand-written form in plain torch, held to
autograd of models/posterior.log_density by the tests;
``_traj_plain`` is the plain trajectory the kernel is held to.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..models.posterior import init_unconstrained, ravel

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class FlatSpec(NamedTuple):
    """Static description of the flattened single-series-DRT posterior:
    sizes and the offset of every parameter in the flat vector."""
    K: int                  # basis size
    n: int                  # number of frequencies (target is (2n,))
    D: int                  # total flat parameter dimension
    ncp: bool
    nonneg: bool
    off_rinf: int = 0
    off_alpha_im: int = 0
    off_alpha_prop: int = 0
    off_alpha_re: int = 0
    off_d: int = 0
    off_induc: int = 0
    off_sigma_res: int = 0
    off_ups: int = 0
    off_x: int = 0


def flat_eligible(cfg) -> bool:
    """Whether the hand-written value and gradient (and the trajectory
    kernel) cover the model: one series distribution, no outliers, fitY or
    SA (the Stan ``Series`` / ``Series_pos`` models)."""
    return (len(cfg.dists) == 1 and cfg.dists[0].dist_type == "series"
            and not (cfg.outliers or cfg.fitY or cfg.sa))


def flat_spec_for(cfg, data) -> FlatSpec:
    """FlatSpec of an eligible posterior, with the offsets discovered from
    the layout of ``init_unconstrained`` (marker per parameter)."""
    if not flat_eligible(cfg):
        raise ValueError(
            "the fused trajectory supports the single series-distribution "
            f"model family only (got {cfg.model_name()})")
    gen = torch.Generator(device=data.target.device).manual_seed(0)
    template = init_unconstrained(cfg, data, gen)
    offs = {}
    for name in template:
        marker = {k: (torch.ones_like(v) if k == name else torch.zeros_like(v))
                  for k, v in template.items()}
        idx = torch.nonzero(ravel(cfg, marker)).flatten().cpu().numpy()
        if len(idx) == 0 or not (np.diff(idx) == 1).all():
            raise AssertionError(f"non-contiguous flat slice for {name}")
        offs[name] = int(idx[0])
    D = int(ravel(cfg, template).shape[-1])
    return FlatSpec(K=cfg.dists[0].K, n=int(data.freq.shape[0]), D=D,
                    ncp=cfg.ncp, nonneg=cfg.nonneg,
                    off_rinf=offs["Rinf_raw"],
                    off_alpha_im=offs["alpha_im_raw"],
                    off_alpha_prop=offs["alpha_prop_raw"],
                    off_alpha_re=offs["alpha_re_raw"],
                    off_d=offs["d_strength_0"],
                    off_induc=offs["induc_raw"],
                    off_sigma_res=offs["sigma_res_raw"],
                    off_ups=offs["ups_raw_0"],
                    off_x=offs["x_0"])


class FlatShared(NamedTuple):
    """Numeric inputs shared by every spectrum of the batch, in the
    stacked layout the trajectory kernel reads (built once per fit by
    ``make_flat_shared``); ``A`` and ``L`` are views into ``W``."""
    A: torch.Tensor     # (2n, K) stacked design matrix
    vecs: torch.Tensor  # (3, 2n): rinf_vec, induc_vec, lik_mask
    scal: torch.Tensor  # (8,): sigma_min, ups_alpha, ups_beta, induc_scale,
                        #       x_scale, ups_lognorm, 0, 0 (ups_lognorm is
                        #       the inv-gamma normalizer a*log(b)-lgamma(a))
    W: torch.Tensor     # (OP, KP): rows [A; L0; L1; L2], zero padded
    WT: torch.Tensor    # (KP, OP): W transposed, contiguous

    @property
    def L(self) -> torch.Tensor:
        """(3, K, K) mode-scaled derivative matrices."""
        n2, K = self.A.shape
        return self.W[n2:n2 + 3 * K, :K].view(3, K, K)


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def stacked_shape(n: int, K: int):
    """(OP, KP) of the kernel's stacked matrix W: 2n + 3K rows and K
    columns, each padded to a multiple of 8 (the kernel's tiles read W in
    runs of four and split it in halves), and at least 2 KP rows (the
    kernel keeps the dups weights in two KP-row blocks of the product)."""
    kp = _round8(K)
    return max(_round8(2 * n + 3 * K), 2 * kp), kp


def make_flat_shared(A, L, vecs, scal) -> FlatShared:
    n2, K = A.shape
    op, kp = stacked_shape(n2 // 2, K)
    W = A.new_zeros((op, kp))
    W[:n2, :K] = A
    W[n2:n2 + 3 * K, :K] = L.reshape(3 * K, K)
    return FlatShared(A=W[:n2, :K], vecs=vecs.contiguous(),
                      scal=scal.contiguous(), W=W, WT=W.T.contiguous())


def flat_shared_for(cfg, data, dtype) -> FlatShared:
    dev = data.target.device
    freq = data.freq.to(dtype)
    one, zero = torch.ones_like(freq), torch.zeros_like(freq)
    vecs = torch.stack([torch.cat([one, zero]),
                        torch.cat([zero, (2.0 * math.pi) * freq]),
                        data.lik_mask.to(dtype)])
    ua = data.ups_alpha.to(dtype)
    ub = data.ups_beta.to(dtype)
    ups_lognorm = ua * torch.log(ub) - torch.lgamma(ua)
    z = torch.zeros((), dtype=dtype, device=dev)
    scal = torch.stack([data.sigma_min.to(dtype), ua, ub,
                        data.induc_scale.to(dtype),
                        data.x_scales[0].to(dtype), ups_lognorm, z, z])
    return make_flat_shared(data.A[0].to(dtype), data.L[0].to(dtype), vecs,
                            scal)


def flat_value_and_grad(spec: FlatSpec, A, L, vecs, scal, q, target,
                        jacobian: bool = True):
    """Batched value and gradient of the single-series-DRT log posterior.

    q: (R, D) unconstrained rows; target: (R, 2n) scaled impedance rows.
    Returns (lp (R,), grad (R, D)), equal to autograd of
    models/posterior.log_density(..., jacobian) on every row:
    ``jacobian=False`` drops the exp transforms' (and ncp's) log-Jacobian,
    which leaves Stan's ``optimizing`` objective (the MAP path)."""
    K, n = spec.K, spec.n
    # d(log-Jacobian)/d(raw) of every exp transform is 1
    jac1 = 1.0 if jacobian else 0.0
    sigma_min, ups_alpha, ups_beta = scal[0], scal[1], scal[2]
    induc_scale, x_scale = scal[3], scal[4]
    rv, iv, mask = vecs[0], vecs[1], vecs[2]

    r_ = q[:, spec.off_rinf]
    ai = q[:, spec.off_alpha_im]
    ap = q[:, spec.off_alpha_prop]
    ar = q[:, spec.off_alpha_re]
    iu = q[:, spec.off_induc]
    sr = q[:, spec.off_sigma_res]
    d = q[:, spec.off_d:spec.off_d + 3]
    u = q[:, spec.off_ups:spec.off_ups + K]
    v = q[:, spec.off_x:spec.off_x + K]

    er, ei, es = torch.exp(r_), torch.exp(iu), torch.exp(sr)
    eap, ear, eai = torch.exp(ap), torch.exp(ar), torch.exp(ai)
    rinf = er * 100.0
    induc = ei * induc_scale
    sres = es * 0.05
    a_p = eap * 0.05
    a_re = ear * 0.05
    a_im = eai * 0.05
    ups = torch.exp(u) * 0.15
    ds = torch.exp(d)

    xr_base = torch.exp(v) if spec.nonneg else v
    x_raw = xr_base * ups if spec.ncp else xr_base
    x = x_raw * x_scale

    # ---- likelihood ----
    pred = (x @ A.T + rinf[:, None] * rv[None, :]
            + induc[:, None] * iv[None, :])
    p_re = pred[:, :n]
    p_im = pred[:, n:]
    var = (sigma_min * sigma_min + (sres * sres)[:, None]
           + (a_p[:, None] * pred) ** 2
           + ((a_re[:, None] * p_re) ** 2).repeat(1, 2)
           + ((a_im[:, None] * p_im) ** 2).repeat(1, 2))
    resid = target - pred
    ivar = 1.0 / var
    loglik = torch.sum(mask[None, :] * (-0.5 * resid * resid * ivar
                                        - 0.5 * torch.log(var)
                                        - _LOG_SQRT_2PI), dim=1)

    # ---- q-penalty (only q^2 enters the density: no sqrt) ----
    Lx0 = x_raw @ L[0].T
    Lx1 = x_raw @ L[1].T
    Lx2 = x_raw @ L[2].T
    S = (ds[:, 0:1] * Lx0 * Lx0 + ds[:, 1:2] * Lx1 * Lx1
         + ds[:, 2:3] * Lx2 * Lx2)
    iu2 = 1.0 / (ups * ups)
    log15 = math.log(0.15)
    lp_q = torch.sum(-0.5 * S * iu2 - u - (log15 + _LOG_SQRT_2PI), dim=1)

    # ---- dups smoothness prior ----
    a_w = ups[:, :-2]
    b_w = ups[:, 2:]
    c_w = ups[:, 1:-1]
    dups = 0.5 * (c_w - 0.5 * (a_w + b_w)) / c_w
    lp_dups = torch.sum(-0.5 * dups * dups, dim=1) - (K - 2) * _LOG_SQRT_2PI

    # ---- scalar priors (half-normal on the exp-raw scales) ----
    pri = (-0.5 * (er * er + ei * ei + es * es + eap * eap + ear * ear
                   + eai * eai) - 6.0 * _LOG_SQRT_2PI)
    c5 = 5.0 * math.log(5.0) - math.lgamma(5.0)
    pri = pri + torch.sum(c5 - 6.0 * d - 5.0 * torch.exp(-d), dim=1)
    cu = scal[5]
    pri = pri + torch.sum(cu - (ups_alpha + 1.0) * u
                          - ups_beta * torch.exp(-u), dim=1)

    lp = loglik + lp_q + lp_dups + pri
    if jacobian:
        # ---- Jacobian of the exp transforms (+ ncp change of variables) ----
        jac = (r_ + ai + ap + ar + iu + sr + torch.sum(d, dim=1)
               + torch.sum(u, dim=1))
        if spec.nonneg:
            jac = jac + torch.sum(v, dim=1)
        if spec.ncp:
            jac = jac + torch.sum(u, dim=1) + K * log15
        lp = lp + jac

    # ================= gradient =================
    gl = mask[None, :] * resid * ivar
    w = mask[None, :] * 0.5 * (resid * resid * ivar - 1.0) * ivar
    wsum = w[:, :n] + w[:, n:]
    g_pred = gl + w * (2.0 * (a_p * a_p)[:, None] * pred)
    g_pred = g_pred + torch.cat(
        [2.0 * (a_re * a_re)[:, None] * p_re * wsum,
         2.0 * (a_im * a_im)[:, None] * p_im * wsum], dim=1)

    g_x = g_pred @ A                                   # (R, K)
    g_xraw = x_scale * g_x
    g_r = torch.sum(g_pred * rv[None, :], dim=1) * rinf + jac1 - er * er
    g_iu = torch.sum(g_pred * iv[None, :], dim=1) * induc + jac1 - ei * ei
    g_sr = torch.sum(w, dim=1) * 2.0 * sres * sres + jac1 - es * es
    g_ap = (torch.sum(w * pred * pred, dim=1) * 2.0 * a_p * a_p
            + jac1 - eap * eap)
    g_ar = (torch.sum(wsum * p_re * p_re, dim=1) * 2.0 * a_re * a_re
            + jac1 - ear * ear)
    g_ai = (torch.sum(wsum * p_im * p_im, dim=1) * 2.0 * a_im * a_im
            + jac1 - eai * eai)

    # q-penalty: dlp/dLx_k = -ds_k * Lx_k / ups^2
    gLx0 = -ds[:, 0:1] * Lx0 * iu2
    gLx1 = -ds[:, 1:2] * Lx1 * iu2
    gLx2 = -ds[:, 2:3] * Lx2 * iu2
    g_xraw = g_xraw + (gLx0 @ L[0] + gLx1 @ L[1] + gLx2 @ L[2])

    g_d = torch.stack([
        -0.5 * torch.sum(Lx0 * Lx0 * iu2, dim=1) * ds[:, 0],
        -0.5 * torch.sum(Lx1 * Lx1 * iu2, dim=1) * ds[:, 1],
        -0.5 * torch.sum(Lx2 * Lx2 * iu2, dim=1) * ds[:, 2],
    ], dim=1) + jac1 - 6.0 + 5.0 * torch.exp(-d)

    # ups: q-penalty, prior, jacobians, dups coupling, and the ncp
    # x_raw = base*ups dependence
    g_u = ((S * iu2 - 1.0) - (ups_alpha + 1.0)
           + ups_beta * torch.exp(-u) + jac1)
    if spec.ncp:
        g_u = g_u + jac1 + g_xraw * x_raw
    wd = -dups
    g_a = wd * (-0.25 / c_w)
    g_c = wd * 0.25 * (a_w + b_w) / (c_w * c_w)
    g_ups_dups = torch.zeros_like(u)
    g_ups_dups[:, :-2] += g_a
    g_ups_dups[:, 2:] += g_a
    g_ups_dups[:, 1:-1] += g_c
    g_u = g_u + g_ups_dups * ups

    if spec.nonneg:
        dxdv = x_raw
    else:
        dxdv = ups if spec.ncp else torch.ones_like(x_raw)
    g_v = g_xraw * dxdv
    if spec.nonneg:
        g_v = g_v + jac1

    grad = torch.empty_like(q)
    grad[:, spec.off_rinf] = g_r
    grad[:, spec.off_alpha_im] = g_ai
    grad[:, spec.off_alpha_prop] = g_ap
    grad[:, spec.off_alpha_re] = g_ar
    grad[:, spec.off_d:spec.off_d + 3] = g_d
    grad[:, spec.off_induc] = g_iu
    grad[:, spec.off_sigma_res] = g_sr
    grad[:, spec.off_ups:spec.off_ups + K] = g_u
    grad[:, spec.off_x:spec.off_x + K] = g_v
    return lp, grad


# ===================== trajectory =====================

def _leaf_step(spec, shared, m_inv, epsc, q_init, p_init, g_init, lp_init,
               H0, j, targets, max_e, i, u, st):
    """One leapfrog + streaming-multinomial-selection step over (R, D) rows:
    the backward leg with flipped momentum until i == j, then the forward
    leg; a leg freezes on NaN or when dH > max_e and is never selected.
    Per-row scalars are (R, 1) columns; dead/ever are bool columns."""
    (qq, pp, gg, lp, logw, pq, plp, pgq, pkin, sacc, dead, ever) = st
    if i == j:
        qq, pp, gg, lp = q_init, p_init, g_init, lp_init
        dead = torch.zeros_like(dead)
    p_half = pp + 0.5 * epsc * gg
    q_new = qq + epsc * p_half * m_inv
    lp1, g_new = flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                     shared.scal, q_new, targets)
    lp_new = lp1[:, None]
    p_new = p_half + 0.5 * epsc * g_new
    kin = 0.5 * torch.sum(p_new * p_new * m_inv, dim=1, keepdim=True)
    Hn = -lp_new + kin
    w = H0 - Hn
    badf = torch.isnan(Hn) | ((Hn - H0) > max_e)
    w = torch.where(badf | dead, torch.full_like(w, -math.inf), w)
    logw_new = torch.logaddexp(logw, w)
    take = torch.log(u) < (w - logw_new)
    pq = torch.where(take, q_new, pq)
    plp = torch.where(take, lp_new, plp)
    pgq = torch.where(take, g_new, pgq)
    pkin = torch.where(take, kin, pkin)
    sacc = sacc + torch.clamp(torch.exp(w), max=1.0)
    dead_new = dead | badf
    ever = ever | dead_new
    alive = ~dead_new
    return (torch.where(alive, q_new, qq), torch.where(alive, p_new, pp),
            torch.where(alive, g_new, gg), torch.where(alive, lp_new, lp),
            logw_new, pq, plp, pgq, pkin, sacc, dead_new, ever)


def _traj_init_state(q, p0, grad, lp_col, kin0):
    """The initial state enters the multinomial with weight 1 (logw = 0);
    the backward leg starts from -p0."""
    z = torch.zeros_like(lp_col)
    f = torch.zeros_like(lp_col, dtype=torch.bool)
    return (q, -p0, grad, lp_col, z, q, lp_col, grad, kin0, z, f, f)


def _traj_plain(spec, n_leap, max_e, shared, q, p0, grad, logp, eps,
                m_inv_rows, targets, j, u_sel):
    """The plain trajectory: a Python loop over leaves of _leaf_step.
    Returns (q, logp, grad, kin, sacc, diverging) of the selected point."""
    kin0 = 0.5 * torch.sum(p0 * p0 * m_inv_rows, dim=1, keepdim=True)
    lp_col = logp[:, None]
    H0 = -lp_col + kin0
    epsc = eps[:, None]
    st = _traj_init_state(q, p0, grad, lp_col, kin0)
    for i in range(n_leap):
        st = _leaf_step(spec, shared, m_inv_rows, epsc, q, p0, grad, lp_col,
                        H0, j, targets, max_e, i, u_sel[i][:, None], st)
    (_, _, _, _, _, pq, plp, pgq, pkin, sacc, _, ever) = st
    return pq, plp[:, 0], pgq, pkin[:, 0], sacc[:, 0], ever[:, 0]


def _spec_ints(spec: FlatSpec):
    vals = (spec.K, spec.n, spec.D, int(spec.ncp), int(spec.nonneg),
            spec.off_rinf, spec.off_alpha_im, spec.off_alpha_prop,
            spec.off_alpha_re, spec.off_d, spec.off_induc,
            spec.off_sigma_res, spec.off_ups, spec.off_x,
            *stacked_shape(spec.n, spec.K))
    return (ctypes.c_int * len(vals))(*vals)


# what csrc/traj.cu returns when none of its tiles holds the shape
_SHAPE_UNSUPPORTED = -1


def _launch_traj(spec, n_leap, max_e, shared, q, p0, grad, logp, eps,
                 m_inv_rows, targets, j, u_sel):
    dt, dev = q.dtype, q.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"traj_fused takes float32 or float64, got {dt}")
    R, D = q.shape
    n2 = 2 * spec.n
    op, kp = stacked_shape(spec.n, spec.K)
    shapes = {"q": (q, (R, D)), "p0": (p0, (R, D)), "grad": (grad, (R, D)),
              "logp": (logp, (R,)), "eps": (eps, (R,)),
              "m_inv_rows": (m_inv_rows, (R, D)),
              "targets": (targets, (R, n2)), "u_sel": (u_sel, (n_leap, R)),
              "vecs": (shared.vecs, (3, n2)), "scal": (shared.scal, (8,)),
              "W": (shared.W, (op, kp)), "WT": (shared.WT, (kp, op))}
    for name, (t, shape) in shapes.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D != spec.D or not 0 <= int(j) <= n_leap:
        raise ValueError("row width or split index out of range")
    q_out = torch.empty_like(q)
    g_out = torch.empty_like(q)
    rs_out = torch.empty((4, R), dtype=dt, device=dev)
    lib = _build.load("traj")
    fn = lib.traj_f32 if dt == torch.float32 else lib.traj_f64
    spec_arr = _spec_ints(spec)     # kept alive across the call
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), p0.data_ptr(), grad.data_ptr(),
                    logp.data_ptr(), eps.data_ptr(), m_inv_rows.data_ptr(),
                    targets.data_ptr(), u_sel.data_ptr(), shared.W.data_ptr(),
                    shared.WT.data_ptr(), shared.vecs.data_ptr(),
                    shared.scal.data_ptr(),
                    ctypes.addressof(spec_arr), R, n_leap, int(j),
                    float(max_e), q_out.data_ptr(), g_out.data_ptr(),
                    rs_out.data_ptr(), stream)
    if status == _SHAPE_UNSUPPORTED:
        raise ValueError(f"traj_fused: no tile of csrc/traj.cu holds K="
                         f"{spec.K}, n={spec.n} in {dt} on this card")
    _build.check(status, "traj_fused")
    traj_fused.launches += 1
    return (q_out, rs_out[0], g_out, rs_out[1], rs_out[2], rs_out[3] > 0.5)


def traj_fused(spec, n_leap, max_e, shared, q, p0, grad, logp, eps,
               m_inv_rows, targets, j, u_sel):
    """One draw's whole trajectory for every row: csrc/traj.cu for CUDA
    tensors (or raise), the plain version for CPU tensors. Returns
    (q, logp, grad, kin, sacc, diverging) of the selected point."""
    args = (spec, n_leap, max_e, shared, q, p0, grad, logp, eps, m_inv_rows,
            targets, j, u_sel)
    if q.device.type == "cpu":
        return _traj_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"traj_fused runs on cpu or cuda, not {q.device}")
    return _launch_traj(*args)


traj_fused.launches = 0


# ===================== sampler =====================

def generator_noise(generator, rows, dim, dtype, device, n_leaps):
    """The default noise stream: the eps0 momentum normals (R, D), then per
    draw (z (R, D), u_sel (n_leap, R)) from ``generator``."""
    def stream():
        yield torch.randn((rows, dim), generator=generator, dtype=dtype,
                          device=device)
        for nl in n_leaps:
            z = torch.randn((rows, dim), generator=generator, dtype=dtype,
                            device=device)
            u = torch.rand((nl, rows), generator=generator, dtype=dtype,
                           device=device)
            yield z, u
    return stream


def sample_shmc_flat(spec: FlatSpec, shared: FlatShared, targets, q0,
                     warmup: int, samples: int, cfg, chains: int,
                     generator=None, noise=None, time_traj: bool = False):
    """Synchronous static multinomial HMC over ONE flat chain axis.

    The batch (B spectra x ``chains``) runs as (B*chains, D) rows through
    one ``traj_fused`` call per draw. Adaptation matches the JAX package's
    sample_shmc: per-row dual averaging; Welford pooled within chain, then
    averaged per spectrum into that spectrum's diagonal metric; a
    per-spectrum pooled sampling step size.

    targets: (B*chains, 2n) per-row scaled impedance; q0: (B*chains, D).
    ``noise`` is a zero-argument callable returning an iterator that yields
    the eps0 momentum normals (R, D) once and then (z (R, D), u_sel
    (n_leap, R)) per draw; by default it draws from ``generator``.
    ``time_traj`` brackets every trajectory launch with CUDA events and
    returns the per-draw device times (ms) under ``info['traj_ms']``.
    Returns (draws (B, C, S, D), info dict with a leading B axis).
    """
    from .chees import _halton2, _pool_eps
    from .nuts import (_da_init, _da_update, _regularized_variance,
                       _window_flags, find_reasonable_step_size)

    cfg.validate()
    rt, dim = q0.shape
    nb = rt // chains
    dtype, dev = q0.dtype, q0.device
    n_leap_s = cfg.n_steps
    n_leap_w = cfg.warm_steps or cfg.n_steps
    max_e = cfg.max_energy_error
    total = warmup + samples
    nl_sched = np.concatenate([np.full(warmup, n_leap_w),
                               np.full(samples, n_leap_s)]).astype(int)
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a noise stream")
        noise = generator_noise(generator, rt, dim, dtype, dev, nl_sched)
    stream = noise()

    def vg(q2):
        return flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                   shared.scal, q2, targets)

    def rows(m_inv):
        return m_inv[:, None, :].expand(nb, chains, dim).reshape(rt, dim)

    logp, grad = vg(q0)
    q = q0
    m_inv = torch.ones((nb, dim), dtype=dtype, device=dev)
    eps0 = find_reasonable_step_size(vg, q0, logp, grad, next(stream),
                                     rows(m_inv))

    if cfg.adapt_mass:
        in_slow, win_end = _window_flags(warmup, cfg)
    else:
        in_slow = win_end = np.zeros(warmup, bool)
    h1 = _halton2(total)
    h2 = _halton2(2 * total)[total:]
    jit_mult = torch.as_tensor(cfg.jitter_lo + (1.0 - cfg.jitter_lo) * h1,
                               dtype=dtype, device=dev)
    j_split = np.floor(h2 * (nl_sched + 1)).clip(0, nl_sched).astype(int)

    da = _da_init(eps0)
    wf_mean = torch.zeros((rt, dim), dtype=dtype, device=dev)
    wf_m2 = torch.zeros((rt, dim), dtype=dtype, device=dev)
    wf_n = 0.0
    eps_fixed = None
    draws = torch.empty((samples, rt, dim), dtype=dtype, device=dev)
    logp_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    acc_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    div_s = torch.empty((samples, rt), dtype=torch.bool, device=dev)
    en_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    warm_div = torch.empty((warmup, rt), dtype=torch.bool, device=dev)
    events = []

    for t in range(total):
        n_leap = int(nl_sched[t])
        if t < warmup:
            eps = torch.exp(da.log_eps)
        else:
            if eps_fixed is None:
                pooled = _pool_eps(torch.exp(da.log_eps_bar).reshape(
                    nb, chains), cfg)
                eps_fixed = (pooled if pooled.ndim == 2 else
                             pooled[:, None].expand(nb, chains)).reshape(rt)
            eps = eps_fixed
        eps = eps * jit_mult[t]
        z, u_sel = next(stream)
        m_inv_rows = rows(m_inv).contiguous()
        p0 = z / torch.sqrt(m_inv_rows)
        if time_traj:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        q, logp, grad, kin, sacc, ever = traj_fused(
            spec, n_leap, max_e, shared, q, p0, grad, logp, eps.contiguous(),
            m_inv_rows, targets, int(j_split[t]), u_sel.contiguous())
        if time_traj:
            ev[1].record()
            events.append(ev)
        accept_prob = sacc / n_leap
        if t >= warmup:
            s = t - warmup
            draws[s] = q
            logp_s[s] = logp
            acc_s[s] = accept_prob
            div_s[s] = ever
            en_s[s] = -logp + kin
            continue
        warm_div[t] = ever
        da = _da_update(da, accept_prob, cfg)
        if cfg.adapt_mass:
            if in_slow[t]:
                n1 = wf_n + 1.0
                dlt = q - wf_mean
                wf_mean = wf_mean + dlt / n1
                wf_m2 = wf_m2 + dlt * (q - wf_mean)
                wf_n = n1
            if win_end[t]:
                if wf_n > 1:
                    var_within = (wf_m2 / max(wf_n - 1.0, 1.0)).reshape(
                        nb, chains, dim).mean(dim=1)
                    m_inv = _regularized_variance(var_within, chains * wf_n)
                wf_mean = torch.zeros_like(wf_mean)
                wf_m2 = torch.zeros_like(wf_m2)
                wf_n = 0.0
                da = _da_init(torch.exp(da.log_eps))

    def per_spec(x):
        # (T, rt, ...) -> (B, C, T, ...)
        return x.reshape((x.shape[0], nb, chains) + x.shape[2:]).movedim(0, 2)

    info = {
        "logp": per_spec(logp_s),
        "accept_prob": per_spec(acc_s),
        "diverging": per_spec(div_s),
        "n_leapfrog": torch.full((nb, chains, samples), n_leap_s,
                                 dtype=torch.int32, device=dev),
        "energy": per_spec(en_s),
        "step_size": torch.exp(da.log_eps_bar).reshape(nb, chains),
        "inv_mass": m_inv,
        "warmup_diverging": per_spec(warm_div),
    }
    if time_traj:
        torch.cuda.synchronize(dev)
        info["traj_ms"] = [a.elapsed_time(b) for a, b in events]
    return per_spec(draws), info
