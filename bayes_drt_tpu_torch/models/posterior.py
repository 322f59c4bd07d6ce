"""The calibrated hierarchical log posterior of the single series DRT (the
Stan ``Series`` model), in torch (port of bayes_drt_tpu/models/posterior.py).

Covered: one series distribution, centered or non-centered (``ncp``),
with or without ``nonneg``. Outliers, fitY, SA and multi-distribution
models raise ``NotImplementedError``.

Parameters are a dict of unconstrained tensors; the flat layout is the
JAX package's ``ravel_pytree`` order (keys sorted), so flat vectors cross
between the two packages unchanged. ``constrain`` and ``predict_target``
broadcast over leading batch dimensions; ``log_density`` takes one
parameter set and is the autograd oracle for the hand-written gradient of
infer/shmc_flat.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .priors import inv_gamma_lpdf, normal_lpdf, std_normal_lpdf


class DistConfig(NamedTuple):
    """Static per-distribution configuration."""
    name: str
    dist_type: str          # 'series' ('parallel' is not ported yet)
    kernel: str = "DRT"
    K: int = 0              # number of basis functions


class PosteriorConfig(NamedTuple):
    """Static model configuration selecting the Stan-model equivalent."""
    dists: tuple            # tuple[DistConfig, ...]
    nonneg: bool = False
    outliers: bool = False
    fitY: bool = False
    part: str = "both"      # 'both' | 'real' | 'imag' (likelihood mask)
    ncp: bool = False       # non-centered coefficients: x = ups * z
    sa: bool = False

    def model_name(self) -> str:
        name = "Series" if len(self.dists) == 1 else "MultiDist"
        if self.nonneg:
            name += "_pos"
        if self.fitY:
            name += "_fitY"
        if self.sa:
            name += "_SA"
        if self.outliers:
            name += "_outliers"
        return name


class PosteriorData(NamedTuple):
    """Numeric inputs, torch tensors on one device in one dtype."""
    A: tuple                # per dist: (2N, K) stacked [[A'], [A'']]
    L: tuple                # per dist: (3, K, K) mode-scaled L0/L1/L2
    target: torch.Tensor    # (2N,) stacked Z
    freq: torch.Tensor      # (N,)
    sigma_min: torch.Tensor
    ups_alpha: torch.Tensor
    ups_beta: torch.Tensor
    induc_scale: torch.Tensor
    x_sum_invscale: torch.Tensor
    x_scales: tuple         # per dist scalar
    sigma_out_lambda: torch.Tensor
    sigma_out_alpha: torch.Tensor
    sigma_out_beta: torch.Tensor
    lik_mask: torch.Tensor  # (2N,) 1/0 mask for part='both'/'real'/'imag'
    sa_inv: object = None


def check_supported(cfg: PosteriorConfig) -> None:
    """Raise for any model outside the ported single-series family."""
    if (len(cfg.dists) != 1 or cfg.dists[0].dist_type != "series"
            or cfg.outliers or cfg.fitY or cfg.sa):
        raise NotImplementedError(
            "the torch port covers the single series-distribution model "
            f"(Series, Series_pos) only; got {cfg.model_name()}")


def param_shapes(cfg: PosteriorConfig) -> list:
    """(name, shape) of every unconstrained parameter in flat-layout order
    (sorted names, as ravel_pytree orders a dict)."""
    check_supported(cfg)
    k = cfg.dists[0].K
    shapes = {"x_0": (k,), "ups_raw_0": (k,), "d_strength_0": (3,),
              "Rinf_raw": (), "induc_raw": (), "sigma_res_raw": (),
              "alpha_prop_raw": (), "alpha_re_raw": (), "alpha_im_raw": ()}
    return sorted(shapes.items())


def ravel(cfg: PosteriorConfig, params: dict) -> torch.Tensor:
    """Parameter dict (leading batch dims allowed) -> flat (..., D)."""
    parts = []
    for name, shape in param_shapes(cfg):
        v = params[name]
        parts.append(v.unsqueeze(-1) if len(shape) == 0 else v)
    return torch.cat(parts, dim=-1)


def unravel(cfg: PosteriorConfig, flat: torch.Tensor) -> dict:
    """Flat (..., D) -> parameter dict of views."""
    out, off = {}, 0
    for name, shape in param_shapes(cfg):
        size = shape[0] if shape else 1
        v = flat[..., off:off + size]
        out[name] = v if shape else v[..., 0]
        off += size
    return out


def init_unconstrained(cfg: PosteriorConfig, data: PosteriorData,
                       generator: torch.Generator, batch_shape=()) -> dict:
    """Stan-style random init: every unconstrained value ~ U(-2, 2) (Stan's
    init=2), drawn from ``generator`` per parameter in flat-layout order."""
    dt, dev = data.target.dtype, data.target.device
    params = {}
    for name, shape in param_shapes(cfg):
        u = torch.rand(tuple(batch_shape) + shape, generator=generator,
                       dtype=dt, device=dev)
        params[name] = 4.0 * u - 2.0
    return params


def constrain(cfg: PosteriorConfig, data: PosteriorData, params: dict) -> dict:
    """Map unconstrained parameters to the Stan-model quantities."""
    out = {"Rinf": torch.exp(params["Rinf_raw"]) * 100.0,
           "induc": torch.exp(params["induc_raw"]) * data.induc_scale}
    ups = torch.exp(params["ups_raw_0"]) * 0.15
    out["ups_0"] = ups
    out["d_strength_0"] = torch.exp(params["d_strength_0"])
    u = params["x_0"]
    if cfg.nonneg:
        x_raw = torch.exp(u) * ups if cfg.ncp else torch.exp(u)
    else:
        x_raw = u * ups if cfg.ncp else u
    out["x_raw_0"] = x_raw
    out["x_0"] = x_raw * data.x_scales[0]
    out["sigma_res"] = torch.exp(params["sigma_res_raw"]) * 0.05
    out["alpha_prop"] = torch.exp(params["alpha_prop_raw"]) * 0.05
    out["alpha_re"] = torch.exp(params["alpha_re_raw"]) * 0.05
    out["alpha_im"] = torch.exp(params["alpha_im_raw"]) * 0.05
    return out


def predict_target(cfg: PosteriorConfig, data: PosteriorData, c: dict):
    """Model prediction of the stacked target vector: A @ x plus the R_inf
    and inductance offsets (broadcasts over leading batch dims of c)."""
    pred = c["x_0"] @ data.A[0].T
    rinf_vec = torch.cat([torch.ones_like(data.freq),
                          torch.zeros_like(data.freq)])
    induc_vec = torch.cat([torch.zeros_like(data.freq),
                           2.0 * math.pi * data.freq])
    return (pred + c["Rinf"][..., None] * rinf_vec
            + c["induc"][..., None] * induc_vec)


def sigma_tot(cfg: PosteriorConfig, data: PosteriorData, c: dict, pred):
    """Heteroscedastic error scale (Stan Series model)."""
    n = data.freq.shape[0]
    pred_re = pred[:n].repeat(2)
    pred_im = pred[n:].repeat(2)
    var = (data.sigma_min ** 2 + c["sigma_res"] ** 2
           + (c["alpha_prop"] * pred) ** 2
           + (c["alpha_re"] * pred_re) ** 2 + (c["alpha_im"] * pred_im) ** 2)
    return torch.sqrt(var)


def log_density(cfg: PosteriorConfig, data: PosteriorData, params: dict,
                jacobian: bool = True):
    """Joint log density of one parameter set, matching the Stan program's
    model block. jacobian=True is the sampling measure on the unconstrained
    space; jacobian=False is Stan's ``optimizing`` objective."""
    check_supported(cfg)
    c = constrain(cfg, data, params)
    lp = torch.zeros((), dtype=data.target.dtype, device=data.target.device)
    if jacobian:
        for name, u in params.items():
            if name == "x_0" and not cfg.nonneg:
                continue
            lp = lp + torch.sum(u)
        if cfg.ncp:
            lp = lp + torch.sum(torch.log(c["ups_0"]))

    lp = lp + std_normal_lpdf(torch.exp(params["Rinf_raw"]))
    lp = lp + std_normal_lpdf(torch.exp(params["induc_raw"]))
    lp = lp + std_normal_lpdf(torch.exp(params["sigma_res_raw"]))
    lp = lp + std_normal_lpdf(torch.exp(params["alpha_prop_raw"]))
    lp = lp + std_normal_lpdf(torch.exp(params["alpha_re_raw"]))
    lp = lp + std_normal_lpdf(torch.exp(params["alpha_im_raw"]))

    ds = c["d_strength_0"]
    lp = lp + inv_gamma_lpdf(ds, 5.0, 5.0)
    lp = lp + inv_gamma_lpdf(torch.exp(params["ups_raw_0"]), data.ups_alpha,
                             data.ups_beta)
    x_raw = c["x_raw_0"]
    L = data.L[0]
    q = torch.sqrt(ds[0] * (L[0] @ x_raw) ** 2 + ds[1] * (L[1] @ x_raw) ** 2
                   + ds[2] * (L[2] @ x_raw) ** 2)
    ups = c["ups_0"]
    lp = lp + normal_lpdf(q, 0.0, ups)
    dups = 0.5 * (ups[1:-1] - 0.5 * (ups[:-2] + ups[2:])) / ups[1:-1]
    lp = lp + std_normal_lpdf(dups)

    pred = predict_target(cfg, data, c)
    st = sigma_tot(cfg, data, c, pred)
    z = (data.target - pred) / st
    loglik_terms = (-0.5 * z * z - torch.log(st)
                    - 0.5 * math.log(2.0 * math.pi)) * data.lik_mask
    return lp + torch.sum(loglik_terms)
