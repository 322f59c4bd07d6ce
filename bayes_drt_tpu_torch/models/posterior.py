"""The calibrated hierarchical Bayesian model as one parameterized log
posterior, in torch (port of bayes_drt_tpu/models/posterior.py).

One function covers the reference's Stan programs, selected by:

- the number and type of distributions (series / parallel): Series,
  Parallel, Series-Parallel, Series-2Parallel and MultiDist;
- ``nonneg`` (the ``_pos`` variants): series coefficients >= 0 (parallel
  coefficients are always >= 0);
- ``outliers`` (the ``_outliers`` variants): a per-frequency outlier error
  with an exponential / inverse-gamma hyperprior;
- ``fitY`` (the ``_fitY`` variants): fit the admittance, no R_inf or
  inductance; ``sa`` (the ``_SA`` variant): row-scaled design matrix with
  the likelihood in unscaled admittance space.

Parameters are a dict of unconstrained tensors. The flat layout is the JAX
package's ``ravel_pytree`` order (keys sorted by Python's ``sorted``), so
flat vectors cross between the two packages unchanged. ``constrain``,
``predict_target`` and ``log_density`` broadcast over leading batch
dimensions of the parameters and of ``data.target``: the gradient of
``log_density(...).sum()`` is every row's gradient in one backward pass
(``posterior_value_and_grad``). Spectra measured on different grids
carry per-spectrum data: A (B, 2N, K), freq (B, N) and lik_mask (B, 2N),
which ``group_data`` shapes to broadcast against parameters grouped (B,
rows, ...). Nothing here synchronizes with the host, so that value and
gradient can be captured in a CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .priors import (exponential_lpdf, inv_gamma_lpdf, normal_lpdf,
                     std_normal_lpdf)


class DistConfig(NamedTuple):
    """Static per-distribution configuration."""
    name: str
    dist_type: str          # 'series' | 'parallel'
    kernel: str = "DRT"     # 'DRT' | 'DDT' (informational)
    K: int = 0              # number of basis functions


class PosteriorConfig(NamedTuple):
    """Static model configuration selecting the Stan-model equivalent."""
    dists: tuple            # tuple[DistConfig, ...]
    nonneg: bool = False
    outliers: bool = False
    fitY: bool = False
    part: str = "both"      # 'both' | 'real' | 'imag' (likelihood mask)
    ncp: bool = False       # non-centered coefficients: x = ups * z
    sa: bool = False        # _SA variant: data.A holds SA = S @ A and
                            # predictions are un-scaled by data.sa_inv

    @property
    def n_series(self):
        return sum(1 for d in self.dists if d.dist_type == "series")

    @property
    def n_parallel(self):
        return sum(1 for d in self.dists if d.dist_type == "parallel")

    def model_name(self) -> str:
        """Reference-style model name."""
        ns, npar = self.n_series, self.n_parallel
        if ns == 1 and npar == 0:
            name = "Series"
        elif ns == 0 and npar == 1:
            name = "Parallel"
        elif ns == 1 and npar == 1:
            name = "Series-Parallel"
        elif ns == 1 and npar == 2:
            name = "Series-2Parallel"
        else:
            name = "MultiDist"
        if self.nonneg and ns >= 1:
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
    A: tuple                # per dist: (2N, K) stacked [[A'], [A'']], or
                            # (B, 2N, K) per spectrum
    L: tuple                # per dist: (3, K, K) mode-scaled L0/L1/L2
    target: torch.Tensor    # (..., 2N) stacked Z (or Y when fitY)
    freq: torch.Tensor      # (N,), or (B, N) per spectrum
    sigma_min: torch.Tensor
    ups_alpha: torch.Tensor
    ups_beta: torch.Tensor
    induc_scale: torch.Tensor
    x_sum_invscale: torch.Tensor
    x_scales: tuple         # per dist scalar (xp_scale for parallel dists)
    sigma_out_lambda: torch.Tensor
    sigma_out_alpha: torch.Tensor
    sigma_out_beta: torch.Tensor
    lik_mask: torch.Tensor  # (2N,) 1/0 mask for part='both'/'real'/'imag'
                            # (and padded frequencies), or (B, 2N)
    sa_inv: object = None   # (2N,) S_inv diagonal when cfg.sa


def group_data(data: PosteriorData, sl=slice(None)) -> PosteriorData:
    """Per-spectrum data (freq (B, N)) restricted to the spectra ``sl``,
    with freq and lik_mask given a row axis ((b, 1, N), (b, 1, 2N)) and A
    left (b, 2N, K), so that all of it broadcasts against parameters
    grouped (b, rows, ...). Shared-grid data is returned as it is."""
    if data.freq.ndim != 2:
        return data
    return data._replace(A=tuple(a[sl] for a in data.A),
                         freq=data.freq[sl, None],
                         lik_mask=data.lik_mask[sl, None])


def _x_is_positive(cfg: PosteriorConfig, dist: DistConfig) -> bool:
    return dist.dist_type == "parallel" or cfg.nonneg


def param_shapes(cfg: PosteriorConfig, n=None) -> list:
    """(name, shape) of every unconstrained parameter in flat-layout order
    (sorted names, as ravel_pytree orders a dict). ``n``, the number of
    frequencies, sizes the outlier parameters."""
    shapes = {}
    for i, d in enumerate(cfg.dists):
        shapes[f"x_{i}"] = (d.K,)
        shapes[f"ups_raw_{i}"] = (d.K,)
        shapes[f"d_strength_{i}"] = (3,)
    if not cfg.fitY:
        shapes["Rinf_raw"] = ()
        shapes["induc_raw"] = ()
    for name in ("sigma_res_raw", "alpha_prop_raw", "alpha_re_raw",
                 "alpha_im_raw"):
        shapes[name] = ()
    if cfg.outliers:
        if n is None:
            raise ValueError("the outlier model's layout needs n")
        shapes["sigma_out_raw"] = (int(n),)
        shapes["sigma_out_scale"] = (int(n),)
    return sorted(shapes.items())


def flat_dim(cfg: PosteriorConfig, n=None) -> int:
    """Width D of the flat parameter vector."""
    return sum(s[0] if s else 1 for _, s in param_shapes(cfg, n))


def _n_from_width(cfg: PosteriorConfig, width: int):
    """The outlier layout's n from a flat width (None without outliers)."""
    if not cfg.outliers:
        return None
    rest = width - flat_dim(cfg._replace(outliers=False))
    if rest <= 0 or rest % 2:
        raise ValueError(f"flat width {width} does not fit "
                         f"{cfg.model_name()}")
    return rest // 2


def ravel(cfg: PosteriorConfig, params: dict) -> torch.Tensor:
    """Parameter dict (leading batch dims allowed) -> flat (..., D)."""
    n = params["sigma_out_raw"].shape[-1] if cfg.outliers else None
    parts = []
    for name, shape in param_shapes(cfg, n):
        v = params[name]
        parts.append(v.unsqueeze(-1) if len(shape) == 0 else v)
    return torch.cat(parts, dim=-1)


def unravel(cfg: PosteriorConfig, flat: torch.Tensor) -> dict:
    """Flat (..., D) -> parameter dict of views."""
    out, off = {}, 0
    for name, shape in param_shapes(cfg, _n_from_width(cfg, flat.shape[-1])):
        size = shape[0] if shape else 1
        v = flat[..., off:off + size]
        out[name] = v if shape else v[..., 0]
        off += size
    return out


def init_unconstrained(cfg: PosteriorConfig, data: PosteriorData,
                       generator: torch.Generator, batch_shape=(),
                       init_values=None, jitter: float = 2.0) -> dict:
    """Stan-style random init: every unconstrained value ~ U(-jitter,
    jitter) (Stan's init=2), drawn from ``generator`` per parameter in
    flat-layout order, optionally overridden by constrained-space
    ``init_values`` (e.g. from a ridge fit), each broadcastable against
    ``batch_shape`` plus the parameter's shape: ``Rinf_raw`` and
    ``induc_raw`` (the values before the x100 / induc_scale transforms),
    ``x_<i>`` (the x_scale, the exp of a positive distribution and, for
    ``ncp``, the drawn ups are inverted) and ``sigma_out_raw``."""
    dt, dev = data.freq.dtype, data.freq.device
    params = {}
    for name, shape in param_shapes(cfg, data.freq.shape[-1]):
        u = torch.rand(tuple(batch_shape) + shape, generator=generator,
                       dtype=dt, device=dev)
        params[name] = (2.0 * jitter) * u - jitter
    if not init_values:
        return params

    def iv(name):
        return torch.as_tensor(init_values[name], device=dev).to(dt)

    def log_clip(name):
        return torch.log(torch.clamp(iv(name), min=1e-10)).expand(
            params[name].shape).clone()

    if not cfg.fitY:
        for name in ("Rinf_raw", "induc_raw"):
            if name in init_values:
                params[name] = log_clip(name)
    for i, d in enumerate(cfg.dists):
        key = f"x_{i}"
        if key not in init_values:
            continue
        x0 = (iv(key) / data.x_scales[i]).expand(params[key].shape)
        ups = torch.exp(params[f"ups_raw_{i}"]) * 0.15
        if _x_is_positive(cfg, d):
            u0 = torch.log(torch.clamp(x0, min=1e-10))
            params[key] = u0 - torch.log(ups) if cfg.ncp else u0.clone()
        else:
            # exact zeros (active-set QP ridge inits) sit on the sqrt
            # penalty's non-differentiable point; nudge to a tiny interior
            # value
            x0 = torch.where(x0 == 0.0, torch.full_like(x0, 1e-8), x0)
            params[key] = x0 / ups if cfg.ncp else x0.clone()
    if cfg.outliers and "sigma_out_raw" in init_values:
        params["sigma_out_raw"] = log_clip("sigma_out_raw")
    return params


def constrain(cfg: PosteriorConfig, data: PosteriorData, params: dict) -> dict:
    """Map unconstrained parameters to the Stan-model quantities (R_inf,
    inductance, per-dist x, error-structure parameters)."""
    out = {}
    if not cfg.fitY:
        out["Rinf"] = torch.exp(params["Rinf_raw"]) * 100.0
        out["induc"] = torch.exp(params["induc_raw"]) * data.induc_scale
    else:
        out["Rinf"] = torch.zeros_like(params["sigma_res_raw"])
        out["induc"] = torch.zeros_like(params["sigma_res_raw"])
    for i, d in enumerate(cfg.dists):
        ups = torch.exp(params[f"ups_raw_{i}"]) * 0.15
        out[f"ups_{i}"] = ups
        out[f"d_strength_{i}"] = torch.exp(params[f"d_strength_{i}"])
        u = params[f"x_{i}"]
        if _x_is_positive(cfg, d):
            x_raw = torch.exp(u) * ups if cfg.ncp else torch.exp(u)
        else:
            x_raw = u * ups if cfg.ncp else u
        out[f"x_raw_{i}"] = x_raw
        out[f"x_{i}"] = x_raw * data.x_scales[i]
    for name in ("sigma_res", "alpha_prop", "alpha_re", "alpha_im"):
        out[name] = torch.exp(params[name + "_raw"]) * 0.05
    if cfg.outliers:
        out["sigma_out"] = (torch.exp(params["sigma_out_raw"])
                            * torch.exp(params["sigma_out_scale"]) * 0.05)
    return out


def predict_target(cfg: PosteriorConfig, data: PosteriorData, c: dict):
    """Model prediction of the stacked target vector (..., 2N).

    Series distributions contribute A @ x; parallel ones the elementwise
    complex inversion of Y = A @ x; R_inf and the inductance offsets are
    added unless fitY."""
    n = data.freq.shape[-1]
    pred = None
    for i, d in enumerate(cfg.dists):
        contrib = c[f"x_{i}"] @ data.A[i].transpose(-1, -2)
        if d.dist_type == "parallel" and not cfg.fitY:
            y_re, y_im = contrib[..., :n], contrib[..., n:]
            denom = y_re ** 2 + y_im ** 2
            contrib = torch.cat([y_re / denom, -y_im / denom], dim=-1)
        pred = contrib if pred is None else pred + contrib
    if cfg.sa:
        pred = data.sa_inv * pred
    if not cfg.fitY:
        rinf_vec = torch.cat([torch.ones_like(data.freq),
                              torch.zeros_like(data.freq)], dim=-1)
        induc_vec = torch.cat([torch.zeros_like(data.freq),
                               2.0 * math.pi * data.freq], dim=-1)
        pred = (pred + c["Rinf"][..., None] * rinf_vec
                + c["induc"][..., None] * induc_vec)
    return pred


def sigma_tot(cfg: PosteriorConfig, data: PosteriorData, c: dict, pred):
    """Heteroscedastic error scale (Stan Series model), (..., 2N)."""
    n = data.freq.shape[-1]
    pred_re = pred[..., :n].tile(2)
    pred_im = pred[..., n:].tile(2)
    var = (data.sigma_min ** 2 + c["sigma_res"][..., None] ** 2
           + (c["alpha_prop"][..., None] * pred) ** 2
           + (c["alpha_re"][..., None] * pred_re) ** 2
           + (c["alpha_im"][..., None] * pred_im) ** 2)
    if cfg.outliers:
        var = var + c["sigma_out"].tile(2) ** 2
    return torch.sqrt(var)


# the scalar columns that lead a fit's monitor draws (fit_spectra_batch's
# ``monitor_thin``), then gamma at ``gamma_eval_tau`` and, with outliers,
# sigma_out at ``outlier_monitor_indices``
MONITOR_SCALARS = ("Rinf", "induc", "sigma_res", "alpha_prop",
                   "alpha_re", "alpha_im")


def outlier_monitor_indices(n: int) -> tuple:
    """Frequency indices at which sigma_out is monitored for rank
    statistics of the ``_outliers`` variants."""
    return (n // 5, n // 2, (4 * n) // 5)


def log_density(cfg: PosteriorConfig, data: PosteriorData, params: dict,
                jacobian: bool = True):
    """Joint log density matching the Stan programs' model blocks, one
    value per leading index of ``params``. jacobian=True is the sampling
    measure on the unconstrained space; jacobian=False is Stan's
    ``optimizing`` objective (MAP in constrained space)."""
    c = constrain(cfg, data, params)
    n = data.freq.shape[-1]
    terms = []
    # log|J| of the exp transforms of every <lower=0> parameter
    if jacobian:
        for name, shape in param_shapes(cfg, n):
            if (name.startswith("x_") and not _x_is_positive(
                    cfg, cfg.dists[int(name.split("_")[1])])):
                continue
            u = params[name]
            terms.append(torch.sum(u, dim=-1) if shape else u)
        if cfg.ncp:
            # x = ups * z (dx/dz = ups) or x = exp(u) * ups: one more
            # sum(log ups) either way
            for i in range(len(cfg.dists)):
                terms.append(torch.sum(torch.log(c[f"ups_{i}"]), dim=-1))

    def half_normal(name):
        return std_normal_lpdf(torch.exp(params[name])[..., None])

    if not cfg.fitY:
        terms += [half_normal("Rinf_raw"), half_normal("induc_raw")]
    terms.append(half_normal("sigma_res_raw"))
    if not cfg.fitY:
        # the fitY model omits the alpha_* priors
        terms += [half_normal("alpha_prop_raw"), half_normal("alpha_re_raw"),
                  half_normal("alpha_im_raw")]

    x_raw_sum = None
    for i in range(len(cfg.dists)):
        ds = c[f"d_strength_{i}"]
        terms.append(inv_gamma_lpdf(ds, 5.0, 5.0))
        terms.append(inv_gamma_lpdf(torch.exp(params[f"ups_raw_{i}"]),
                                    data.ups_alpha, data.ups_beta))
        x_raw = c[f"x_raw_{i}"]
        L = data.L[i]
        q = torch.sqrt(ds[..., 0:1] * (x_raw @ L[0].T) ** 2
                       + ds[..., 1:2] * (x_raw @ L[1].T) ** 2
                       + ds[..., 2:3] * (x_raw @ L[2].T) ** 2)
        ups = c[f"ups_{i}"]
        terms.append(normal_lpdf(q, 0.0, ups))
        dups = (0.5 * (ups[..., 1:-1] - 0.5 * (ups[..., :-2] + ups[..., 2:]))
                / ups[..., 1:-1])
        terms.append(std_normal_lpdf(dups))
        s = torch.sum(x_raw, dim=-1)
        x_raw_sum = s if x_raw_sum is None else x_raw_sum + s

    # soft sum constraint of the multi-distribution models
    if len(cfg.dists) > 1:
        terms.append(std_normal_lpdf((x_raw_sum * data.x_sum_invscale)[..., None]))

    if cfg.outliers:
        terms.append(exponential_lpdf(torch.exp(params["sigma_out_raw"]),
                                      data.sigma_out_lambda))
        terms.append(inv_gamma_lpdf(torch.exp(params["sigma_out_scale"]),
                                    data.sigma_out_alpha,
                                    data.sigma_out_beta))

    pred = predict_target(cfg, data, c)
    st = sigma_tot(cfg, data, c, pred)
    z = (data.target - pred) / st
    terms.append(torch.sum((-0.5 * z * z - torch.log(st)
                            - 0.5 * math.log(2.0 * math.pi)) * data.lik_mask,
                           dim=-1))
    lp = terms[0]
    for t in terms[1:]:
        lp = lp + t
    return lp


def posterior_value_and_grad(cfg: PosteriorConfig, data: PosteriorData,
                             targets, jacobian: bool = True, density=None):
    """Batched value and gradient of ``log_density`` by autograd (the
    counterpart of the JAX package's ``jax.value_and_grad`` of
    ``log_density`` vmapped over rows): returns ``vg(q)`` taking flat rows
    q (R, D), row r fitting ``targets[r]`` (R, 2N), and returning (logp
    (R,), grad (R, D)) from one backward pass of ``logp.sum()``. With
    per-spectrum data (freq (B, N)) the rows are grouped spectrum-major,
    row r fitting spectrum r // (R / B), and each spectrum's A multiplies
    its own rows only. No host synchronization, so CUDA graphs can capture
    it (the NUTS trees, the SHMC trajectories and the L-BFGS iterations
    do). ``density`` replaces ``log_density`` by a function of the same
    signature ``(cfg, data, params, jacobian)``."""
    if density is None:
        density = log_density
    nb = data.freq.shape[0] if data.freq.ndim == 2 else None
    if nb is None:
        dat = data._replace(target=targets)
    else:
        dat = group_data(data)._replace(
            target=targets.reshape(nb, -1, targets.shape[-1]))

    def vg(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            xs = x if nb is None else x.reshape(nb, -1, x.shape[-1])
            lp = density(cfg, dat, unravel(cfg, xs), jacobian=jacobian)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach().reshape(-1), g

    return vg
