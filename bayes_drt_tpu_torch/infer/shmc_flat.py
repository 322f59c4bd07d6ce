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
``_traj_plain``, the generic trajectory of infer/chees.py on it, is the
plain trajectory the kernel is held to.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .._numerics import matmul as _mm
from ..models.posterior import (init_unconstrained, posterior_value_and_grad,
                                ravel)
from ..progcache import bound, data_shapes
from .chees import run_shmc, shmc_trajectory

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
    pred = (_mm(x, A.T) + rinf[:, None] * rv[None, :]
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
    Lx0 = _mm(x_raw, L[0].T)
    Lx1 = _mm(x_raw, L[1].T)
    Lx2 = _mm(x_raw, L[2].T)
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

    g_x = _mm(g_pred, A)                                # (R, K)
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
    g_xraw = g_xraw + (_mm(gLx0, L[0]) + _mm(gLx1, L[1])
                       + _mm(gLx2, L[2]))

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


def cached_value_and_grad(tag, cfg, data, targets, jacobian: bool = True,
                          density=None, key=()):
    """The posterior's batched value and gradient as a progcache runner
    (``Bound``) over static copies of its inputs, this call's values
    copied in: the hand-written form over (FlatShared, targets) for the
    single series DRT with the default density, autograd of ``density``
    (default models/posterior.log_density) over (data, targets)
    otherwise. The entry's key is ``tag``, the model configuration, the
    inputs' shapes and dtypes, the device, ``jacobian``, ``density`` and
    ``key`` (the caller's solver settings); its ``fn`` is the value and
    gradient and its ``graphs`` the samplers' and solvers' slot."""
    flat = density is None and flat_eligible(cfg)
    if flat:
        spec = flat_spec_for(cfg, data)
        inputs = (flat_shared_for(cfg, data, targets.dtype), targets)

        def make(buf):
            sh, tg = buf
            return lambda q: flat_value_and_grad(
                spec, sh.A, sh.L, sh.vecs, sh.scal, q, tg, jacobian=jacobian)
    else:
        inputs = (data, targets)

        def make(buf):
            return posterior_value_and_grad(cfg, buf[0], buf[1],
                                            jacobian=jacobian,
                                            density=density)
    full = (tag, cfg, flat, data_shapes(inputs), str(targets.device),
            bool(jacobian), density) + tuple(key)
    return bound(full, inputs, make)


# ===================== trajectory =====================

def _traj_plain(spec, n_leap, max_e, shared, q, p0, grad, logp, eps,
                m_inv_rows, targets, j, u_sel):
    """The plain trajectory: the generic trajectory (infer/chees.py) on the
    hand-written value and gradient. Returns (q, logp, grad, kin, sacc,
    diverging) of the selected point."""
    def vg(q2):
        return flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                   shared.scal, q2, targets)
    return shmc_trajectory(vg, n_leap, max_e, q, p0, grad, logp, eps,
                           m_inv_rows, j, u_sel)


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

def sample_shmc_flat(spec: FlatSpec, shared: FlatShared, targets, q0,
                     warmup: int, samples: int, cfg, chains: int,
                     generator=None, noise=None, time_traj: bool = False,
                     metric=None, init_step_size=1.0):
    """Synchronous static multinomial HMC over ONE flat chain axis.

    The batch (B spectra x ``chains``) runs as (B*chains, D) rows through
    one ``traj_fused`` call per draw, in the adaptation loop of the generic
    sampler (infer/chees.py:run_shmc, the JAX package's sample_shmc per
    spectrum). ``cfg.recompute_grad`` has no effect: the kernel returns
    the selected state's gradient.

    targets: (B*chains, 2n) per-row scaled impedance; q0: (B*chains, D).
    ``noise``, ``generator``, ``metric`` ((D,) or per spectrum (B, D))
    and ``init_step_size`` (a float or per spectrum (B,)) are run_shmc's:
    a resumed fit passes the metric and step size it carries, with
    ``cfg.adapt_mass=False`` to hold the metric. ``time_traj`` brackets
    every trajectory launch with CUDA events and returns the per-draw
    device times (ms) under ``info['traj_ms']``. Returns (draws (B, C, S,
    D), info dict with a leading B axis).
    """
    max_e = cfg.max_energy_error

    def vg(q2):
        return flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                   shared.scal, q2, targets)

    def traj(n_leap, q, p0, grad, logp, eps, m_inv_rows, j, u_sel):
        return traj_fused(spec, n_leap, max_e, shared, q, p0, grad, logp,
                          eps, m_inv_rows, targets, j, u_sel)

    return run_shmc(vg, traj, q0, warmup, samples, cfg, chains,
                    generator=generator, noise=noise, time_traj=time_traj,
                    metric=metric, init_step_size=init_step_size)
