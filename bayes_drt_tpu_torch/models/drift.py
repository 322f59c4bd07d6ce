"""Time-evolving (drift) MAP models (port of
bayes_drt_tpu/models/drift.py).

Forward models (single distribution; t = per-point measurement time):
  x1/x2:  X(t) = x0 + (x1 - x0)(1 - e^{-t/tau_1}) [+ x2 (1 - e^{-t/tau_2})]
          Rinf(t) = Rinf_0 + dRinf (1 - e^{-t/tau_R})
  dx:     X(t) = x0 + dx (1 - e^{-t/tau_dx});   Rinf(t) as above
  dx-lin: X(t) = x0 + dx * t/max(t);  Rinf(t) = Rinf_0 + dRinf t/max(t)
  RQ:     Z(t) = A x0 + F(t) * ZARC(R_rq, tau_rq, phi_rq) + Rinf(t) + jwL,
          F(t) = 1 - e^{-k t}, k in [1e-4, 1]
  RQ-lin: F(t) = t / max(t)
  RQ-from-final / RQ-lin-from-final: final coefficients x1 with
          F(t) = -e^{-k t} or (t - t_f)/(t_f - t_i)

Priors: the hierarchical complexity prior (q ~ N(0, ups), dups ~ N(0,1),
inverse-gamma hyperpriors) on each coefficient vector and the
heteroscedastic error model of the static models. Bounded drift
parameters use sigmoid transforms.

Parameters are a dict of unconstrained tensors; every function broadcasts
over leading batch dimensions of the parameters and of ``data.Z`` (one
target row per parameter row), so ``drift_value_and_grad`` gives every
row's value and gradient from one backward pass. The flat layout is the
JAX package's ``ravel_pytree`` order (sorted names), so inits and optima
cross between the packages. Nothing here synchronizes with the host or
makes a tensor from a Python number, so value and gradient can be
captured in a CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .priors import inv_gamma_lpdf, normal_lpdf, std_normal_lpdf

DRIFT_MODELS = ("x1", "x2", "dx", "dx-lin", "RQ", "RQ-lin", "RQ-from-final",
                "RQ-lin-from-final")


class DriftConfig(NamedTuple):
    drift_model: str
    dist_type: str          # 'series' | 'parallel'
    nonneg: bool
    K: int


class DriftData(NamedTuple):
    A_re: torch.Tensor         # (N, K)
    A_im: torch.Tensor         # (N, K)
    L: torch.Tensor            # (3, K, K) mode-scaled
    Z: torch.Tensor            # (..., 2N) stacked scaled target
    freq: torch.Tensor         # (N,)
    times: torch.Tensor        # (N,)
    sigma_min: torch.Tensor
    ups_alpha: torch.Tensor
    ups_beta: torch.Tensor
    induc_scale: torch.Tensor
    tau_bounds: torch.Tensor   # (2,) bounds of the drift time constant
    tau2_bounds: torch.Tensor  # (2,) second process (x2) bounds
    rq_tau_bounds: torch.Tensor  # (2,) ZARC tau bounds
    k_bounds: torch.Tensor     # (2,) rate constant bounds (RQ)
    t_max: torch.Tensor
    t_min: torch.Tensor


def _softplus(u):
    return torch.logaddexp(u, torch.zeros_like(u))


def _sigmoid_bounded(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def _sigmoid_log_jac(u, lo, hi):
    """log |d/du (lo + (hi-lo) sigmoid(u))|."""
    width = hi - lo
    log_w = (torch.log(width) if isinstance(width, torch.Tensor)
             else math.log(width))
    return log_w - _softplus(-u) - _softplus(u)


def _coef_vector_names(cfg: DriftConfig):
    m = cfg.drift_model
    if m in ("x1", "x2"):
        return ["x0", "x1"] + (["x2"] if m == "x2" else [])
    if m in ("dx", "dx-lin"):
        return ["x0", "dx"]
    if m in ("RQ", "RQ-lin"):
        return ["x0"]
    return ["x1"]


def drift_param_shapes(cfg: DriftConfig) -> list:
    """(name, shape) of every unconstrained parameter in flat-layout order
    (sorted names, as ravel_pytree orders a dict)."""
    shapes = {}
    for nm in _coef_vector_names(cfg):
        shapes[nm] = (cfg.K,)
        shapes[f"ups_raw_{nm}"] = (cfg.K,)
        shapes[f"d_strength_{nm}"] = (3,)
    shapes.update({"Rinf0_raw": (), "dRinf_raw": (), "induc_raw": (),
                   "sigma_res_raw": (), "alpha_prop_raw": (),
                   "alpha_re_raw": (), "alpha_im_raw": ()})
    m = cfg.drift_model
    if m in ("x1", "x2"):
        shapes["u_tau_x1"] = ()
        shapes["u_tau_Rinf"] = ()
        if m == "x2":
            shapes["u_tau_x2"] = ()
    elif m == "dx":
        shapes["u_tau_dx"] = ()
        shapes["u_tau_Rinf"] = ()
    elif m.startswith("RQ"):
        shapes.update({"R_rq_raw": (), "u_tau_rq": (), "u_phi_rq": ()})
        if m in ("RQ", "RQ-from-final"):
            shapes["u_k"] = ()
    return sorted(shapes.items())


def drift_flat_dim(cfg: DriftConfig) -> int:
    """Width D of the flat parameter vector."""
    return sum(s[0] if s else 1 for _, s in drift_param_shapes(cfg))


def ravel_drift(cfg: DriftConfig, params: dict) -> torch.Tensor:
    """Parameter dict (leading batch dims allowed) -> flat (..., D)."""
    return torch.cat([params[nm].unsqueeze(-1) if len(shape) == 0
                      else params[nm]
                      for nm, shape in drift_param_shapes(cfg)], dim=-1)


def unravel_drift(cfg: DriftConfig, flat: torch.Tensor) -> dict:
    """Flat (..., D) -> parameter dict of views."""
    out, off = {}, 0
    for nm, shape in drift_param_shapes(cfg):
        size = shape[0] if shape else 1
        v = flat[..., off:off + size]
        out[nm] = v if shape else v[..., 0]
        off += size
    return out


def init_drift_params(cfg: DriftConfig, data: DriftData,
                      generator: torch.Generator, batch_shape=(),
                      init_values=None) -> dict:
    """Random init: every unconstrained value ~ U(-2, 2), drawn from
    ``generator`` per parameter in flat-layout order, the drift time
    constants' and rates' scaled by 0.3 (gentle inits that still let
    restarts explore different drift basins), then ``init_values``
    (unconstrained values, broadcastable against ``batch_shape`` plus the
    parameter's shape) in place of the draws they name."""
    dt, dev = data.freq.dtype, data.freq.device
    params = {}
    for nm, shape in drift_param_shapes(cfg):
        u = torch.rand(tuple(batch_shape) + shape, generator=generator,
                       dtype=dt, device=dev)
        params[nm] = 4.0 * u - 2.0
        if nm.startswith("u_tau") or nm in ("u_k", "u_phi_rq"):
            params[nm] = 0.3 * params[nm]
    for nm, v in (init_values or {}).items():
        if nm in params:
            params[nm] = torch.as_tensor(v, device=dev).to(dt).expand(
                params[nm].shape).clone()
    return params


def constrain_drift(cfg: DriftConfig, data: DriftData, p: dict) -> dict:
    c = {}
    pos_x = cfg.nonneg or cfg.dist_type == "parallel"
    for nm in _coef_vector_names(cfg):
        if nm in ("x0", "x1") and pos_x:
            c[nm] = torch.exp(p[nm])
        else:
            c[nm] = p[nm]           # drift increments dx/x2 are free-sign
        c[f"ups_{nm}"] = torch.exp(p[f"ups_raw_{nm}"]) * 0.15
        c[f"d_strength_{nm}"] = torch.exp(p[f"d_strength_{nm}"])
    c["Rinf_0"] = torch.exp(p["Rinf0_raw"]) * 100.0
    c["delta_Rinf"] = p["dRinf_raw"] * 100.0
    c["induc"] = torch.exp(p["induc_raw"]) * data.induc_scale
    c["sigma_res"] = torch.exp(p["sigma_res_raw"]) * 0.05
    c["alpha_prop"] = torch.exp(p["alpha_prop_raw"]) * 0.05
    c["alpha_re"] = torch.exp(p["alpha_re_raw"]) * 0.05
    c["alpha_im"] = torch.exp(p["alpha_im_raw"]) * 0.05
    m = cfg.drift_model
    if m in ("x1", "x2", "dx"):
        u_t1 = p["u_tau_x1"] if "u_tau_x1" in p else p["u_tau_dx"]
        c["tau_1"] = _sigmoid_bounded(u_t1, data.tau_bounds[0],
                                      data.tau_bounds[1])
        c["tau_Rinf"] = _sigmoid_bounded(p["u_tau_Rinf"], data.tau_bounds[0],
                                         data.tau_bounds[1])
        if m == "x2":
            c["tau_2"] = _sigmoid_bounded(p["u_tau_x2"], data.tau2_bounds[0],
                                          data.tau2_bounds[1])
    elif m.startswith("RQ"):
        c["R_rq"] = torch.exp(p["R_rq_raw"])
        c["tau_rq"] = torch.exp(_sigmoid_bounded(
            p["u_tau_rq"], torch.log(data.rq_tau_bounds[0]),
            torch.log(data.rq_tau_bounds[1])))
        c["phi_rq"] = torch.sigmoid(p["u_phi_rq"])
        if m in ("RQ", "RQ-from-final"):
            # k spans decades; bound it in log space so the optimizer has
            # useful gradients across the whole range
            c["k_d"] = torch.exp(_sigmoid_bounded(
                p["u_k"], torch.log(data.k_bounds[0]),
                torch.log(data.k_bounds[1])))
    return c


def _f_t(cfg: DriftConfig, data: DriftData, c: dict):
    m = cfg.drift_model
    t = data.times
    if m == "RQ":
        return 1.0 - torch.exp(-c["k_d"][..., None] * t)
    if m == "RQ-lin":
        return t / data.t_max
    if m == "RQ-from-final":
        return -torch.exp(-c["k_d"][..., None] * t)
    if m == "RQ-lin-from-final":
        return (t - data.t_max) / (data.t_max - data.t_min)
    raise ValueError(m)


def _matvec(x, A):
    """A @ x over the last axis of x: (..., K) -> (..., N)."""
    return x @ A.T


def predict_drift_target(cfg: DriftConfig, data: DriftData, c: dict):
    """Stacked [Z'; Z''] prediction (..., 2N) with per-point time
    dependence. The coefficient trajectory X(t) enters as A @ x0 plus the
    decays times A @ (the increments), which equals the row sums of
    A * X(t)."""
    m = cfg.drift_model
    t = data.times
    omega = 2.0 * math.pi * data.freq

    def sc(name):
        return c[name][..., None]

    if m in ("x1", "x2", "dx", "dx-lin"):
        decay1 = (1.0 - torch.exp(-t / sc("tau_1")) if m != "dx-lin"
                  else t / data.t_max)
        inc = c["x1"] - c["x0"] if m in ("x1", "x2") else c["dx"]
        zr = _matvec(c["x0"], data.A_re) + _matvec(inc, data.A_re) * decay1
        zi = _matvec(c["x0"], data.A_im) + _matvec(inc, data.A_im) * decay1
        if m == "x2":
            decay2 = 1.0 - torch.exp(-t / sc("tau_2"))
            zr = zr + _matvec(c["x2"], data.A_re) * decay2
            zi = zi + _matvec(c["x2"], data.A_im) * decay2
        if cfg.dist_type == "parallel":
            denom = zr ** 2 + zi ** 2
            zr, zi = zr / denom, -zi / denom
        if m == "dx-lin":
            rinf_t = sc("Rinf_0") + sc("delta_Rinf") * (t / data.t_max)
        else:
            rinf_t = (sc("Rinf_0") + sc("delta_Rinf")
                      * (1.0 - torch.exp(-t / sc("tau_Rinf"))))
    else:
        x_static = c["x1"] if m.endswith("from-final") else c["x0"]
        zr = _matvec(x_static, data.A_re)
        zi = _matvec(x_static, data.A_im)
        if cfg.dist_type == "parallel":
            denom = zr ** 2 + zi ** 2
            zr, zi = zr / denom, -zi / denom
        f_t = _f_t(cfg, data, c)
        # R / (1 + (j w tau)^phi), (j w tau)^phi = (w tau)^phi e^{j phi pi/2}
        phi = sc("phi_rq")
        mag = (omega * sc("tau_rq")) ** phi
        a = 1.0 + mag * torch.cos(0.5 * math.pi * phi)
        b = mag * torch.sin(0.5 * math.pi * phi)
        den = a * a + b * b
        zr = zr + f_t * (sc("R_rq") * a / den)
        zi = zi + f_t * (-sc("R_rq") * b / den)
        # Rinf_0 plays Rinf_1 for the *-from-final models
        rinf_t = sc("Rinf_0") + sc("delta_Rinf") * f_t
    zr = zr + rinf_t
    zi = zi + sc("induc") * omega
    return torch.cat([zr, zi], dim=-1)


def drift_log_density(cfg: DriftConfig, data: DriftData, p: dict,
                      jacobian: bool = False):
    """MAP objective for drift fits (Stan optimizing semantics by default);
    one value per leading row."""
    c = constrain_drift(cfg, data, p)
    terms = []
    pos_x = cfg.nonneg or cfg.dist_type == "parallel"

    def s(v):
        return v[..., None]

    if jacobian:
        for nm in _coef_vector_names(cfg):
            if nm in ("x0", "x1") and pos_x:
                terms.append(torch.sum(p[nm], dim=-1))
            terms.append(torch.sum(p[f"ups_raw_{nm}"], dim=-1)
                         + torch.sum(p[f"d_strength_{nm}"], dim=-1))
        for nm in ("Rinf0_raw", "induc_raw", "sigma_res_raw",
                   "alpha_prop_raw", "alpha_re_raw", "alpha_im_raw"):
            terms.append(p[nm])
        m = cfg.drift_model
        if m in ("x1", "x2", "dx"):
            u_t1 = p["u_tau_x1"] if "u_tau_x1" in p else p["u_tau_dx"]
            terms.append(_sigmoid_log_jac(u_t1, data.tau_bounds[0],
                                          data.tau_bounds[1]))
            terms.append(_sigmoid_log_jac(p["u_tau_Rinf"], data.tau_bounds[0],
                                          data.tau_bounds[1]))
            if m == "x2":
                terms.append(_sigmoid_log_jac(
                    p["u_tau_x2"], data.tau2_bounds[0], data.tau2_bounds[1]))
        elif m.startswith("RQ"):
            terms.append(p["R_rq_raw"])                 # exp transform
            # tau_rq = exp(bounded(u)) in log space -> chain both Jacobians
            terms.append(torch.log(c["tau_rq"]) + _sigmoid_log_jac(
                p["u_tau_rq"], torch.log(data.rq_tau_bounds[0]),
                torch.log(data.rq_tau_bounds[1])))
            terms.append(_sigmoid_log_jac(p["u_phi_rq"], 0.0, 1.0))
            if m in ("RQ", "RQ-from-final"):
                terms.append(torch.log(c["k_d"]) + _sigmoid_log_jac(
                    p["u_k"], torch.log(data.k_bounds[0]),
                    torch.log(data.k_bounds[1])))

    for nm in ("Rinf0_raw", "induc_raw", "sigma_res_raw", "alpha_prop_raw",
               "alpha_re_raw", "alpha_im_raw"):
        terms.append(std_normal_lpdf(s(torch.exp(p[nm]))))
        if nm == "Rinf0_raw":
            terms.append(std_normal_lpdf(s(p["dRinf_raw"])))
    if cfg.drift_model.startswith("RQ"):
        terms.append(std_normal_lpdf(s(torch.exp(p["R_rq_raw"]))))

    for nm in _coef_vector_names(cfg):
        x_raw = c[nm]
        ds = c[f"d_strength_{nm}"]
        terms.append(inv_gamma_lpdf(ds, 5.0, 5.0))
        terms.append(inv_gamma_lpdf(torch.exp(p[f"ups_raw_{nm}"]),
                                    data.ups_alpha, data.ups_beta))
        L = data.L
        q = torch.sqrt(ds[..., 0:1] * _matvec(x_raw, L[0]) ** 2
                       + ds[..., 1:2] * _matvec(x_raw, L[1]) ** 2
                       + ds[..., 2:3] * _matvec(x_raw, L[2]) ** 2)
        ups = c[f"ups_{nm}"]
        terms.append(normal_lpdf(q, 0.0, ups))
        dups = (0.5 * (ups[..., 1:-1] - 0.5 * (ups[..., :-2] + ups[..., 2:]))
                / ups[..., 1:-1])
        terms.append(std_normal_lpdf(dups))

    pred = predict_drift_target(cfg, data, c)
    n = data.freq.shape[0]
    pred_re = pred[..., :n].repeat((1,) * (pred.ndim - 1) + (2,))
    pred_im = pred[..., n:].repeat((1,) * (pred.ndim - 1) + (2,))
    st = torch.sqrt(data.sigma_min ** 2 + s(c["sigma_res"]) ** 2
                    + (s(c["alpha_prop"]) * pred) ** 2
                    + (s(c["alpha_re"]) * pred_re) ** 2
                    + (s(c["alpha_im"]) * pred_im) ** 2)
    terms.append(normal_lpdf(data.Z - pred, 0.0, st))
    lp = terms[0]
    for t in terms[1:]:
        lp = lp + t
    return lp


def drift_value_and_grad(cfg: DriftConfig, data: DriftData,
                         jacobian: bool = False):
    """``vg(q)``: flat rows q (R, D), row r fitting ``data.Z[r]`` (or the
    one target), -> (logp (R,), grad (R, D)) from one backward pass of
    ``logp.sum()``."""
    def vg(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lp = drift_log_density(cfg, data, unravel_drift(cfg, x),
                                   jacobian=jacobian)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    return vg
