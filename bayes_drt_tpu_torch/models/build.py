"""Assembly of PosteriorConfig/PosteriorData from distribution definitions
(port of bayes_drt_tpu/models/build.py).

Reproduces the reference's Stan data preparation: stacking [Z'; Z''] and
[[A'], [A'']], the mode-dependent penalty-matrix scalings and
hyperparameters (the baked-in calibration of the hierarchical model, the
tables copied verbatim from the JAX package), the soft sum constraint of
the multi-distribution models and the outlier hyperparameters.
"""

from __future__ import annotations

import numpy as np
import torch

from .._numerics import resolve_device, resolve_dtype
from .posterior import DistConfig, PosteriorConfig, PosteriorData

# mode-dependent multipliers on (L0, L1, L2) -- the model calibration tables
# (reference: inversion.py:1725-1737 single dist, 1907-1927 series-parallel,
# 1984-2010 series-2parallel, 2067-2087 multidist)
_L_SCALES = {
    ("optimize", "single"): (1.5 * 0.24, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "single"): (1.0, 1.0, 0.75),
    ("optimize", "series"): (1.5 * 0.24, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "series"): (1.0, 1.0, 0.75),
    ("optimize", "parallel"): (1.5 * 0.36, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "parallel"): (1.0, 1.0, 0.75),
    ("optimize", "multi"): (1.5 * 0.24, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "multi"): (1.0, 1.0, 0.5),
}


def _x_sum_invscale(mode: str, n_series: int, n_parallel: int) -> float:
    """Soft sum-constraint scale: on only in sample mode, for
    Series-Parallel (1.0) and Series-2Parallel (0.1)."""
    if n_series + n_parallel <= 1 or mode == "optimize":
        return 0.0
    if n_series == 1 and n_parallel == 1:
        return 1.0
    if n_series == 1 and n_parallel == 2:
        return 0.1
    return 0.0


def z_scale_for(distributions: dict, Z, fit_type: str = "map"):
    """The reference's Z-scale rule, per spectrum (last axis of ``Z``).

    Default: std|Z| / sqrt(N/81) (hyperparameters calibrated at N=81). For
    a single parallel planar DDT in a map/bayes fit the scale instead
    targets a calibrated admittance std: std|Y*| = 14 (transmissive) or
    2.4 (blocking), since that likelihood fits Y = A @ x."""
    Z = np.asarray(Z)
    n = Z.shape[-1]
    infos = list(distributions.values())
    n_series = sum(1 for i in infos if i["dist_type"] == "series")
    n_par = len(infos) - n_series
    if n_par == 1 and n_series == 0 and fit_type != "ridge":
        info = [i for i in infos if i["dist_type"] == "parallel"][0]
        if (info.get("kernel") == "DDT"
                and info.get("symmetry", "planar") == "planar"):
            ystar_std = (14.0 if info.get("bc", "transmissive")
                         == "transmissive" else 2.4)
            ymod = np.abs(1.0 / Z)
            return ystar_std * np.sqrt(n / 81) / np.std(ymod, axis=-1)
    return np.std(np.abs(Z), axis=-1) / np.sqrt(n / 81)


def sort_distributions(distributions: dict) -> list:
    """Canonical ordering: series first, then parallel, each by name."""
    series = sorted(n for n, i in distributions.items()
                    if i["dist_type"] == "series")
    parallel = sorted(n for n, i in distributions.items()
                      if i["dist_type"] == "parallel")
    return series + parallel


def build_posterior(distributions: dict, dist_matrices: dict, frequencies,
                    Z_scaled, mode: str = "optimize", part: str = "both",
                    nonneg: bool = False, outliers: bool = False,
                    fitY: bool = False, sigma_min: float = 0.002,
                    inductance_scale: float = 1.0, outlier_lambda=None,
                    dtype=None, ncp: bool = False, SA: bool = False,
                    SASY: bool = False, device=None):
    """Returns (PosteriorConfig, PosteriorData) on ``device`` in ``dtype``.

    ``Z_scaled`` is the complex impedance after Z-scaling;
    ``dist_matrices[name]`` holds A_re, A_im (N, K) and L0, L1, L2 (K, K)
    as numpy arrays or tensors. ``SA`` / ``SASY`` are the reference's
    row-scaling experiments, valid only with ``fitY`` and mutually
    exclusive: SA keeps the likelihood in unscaled admittance space, SASY
    also scales the data."""
    if mode not in ("optimize", "sample"):
        raise ValueError(f"Invalid mode {mode!r}")
    if part not in ("both", "real", "imag"):
        raise ValueError(f"Invalid part {part!r}")
    if outlier_lambda is None:
        outlier_lambda = 10.0
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)

    def tens(a, to=dt):
        if not isinstance(a, torch.Tensor):
            a = np.array(a, dtype=float)  # a copy: contiguous, keeps 0-d
        return torch.as_tensor(a, device=dev).to(to)

    def f64(a):
        return tens(a, torch.float64)

    freq = np.asarray(frequencies, dtype=float)
    n = len(freq)
    names = sort_distributions(distributions)
    n_series = sum(1 for nm in names
                   if distributions[nm]["dist_type"] == "series")
    n_parallel = len(names) - n_series
    if fitY and (n_parallel == 0 or n_series > 0):
        raise ValueError("fitY=True is only valid for parallel distributions")
    if (SA or SASY) and not fitY:
        raise ValueError("SA/SASY row scaling is only valid with fitY=True")
    if SA and SASY:
        raise ValueError(
            "SA and SASY are mutually exclusive: the reference's combined "
            "branch is inconsistent (scaled Y against an unscaled Y_hat); "
            "choose one")

    if len(names) == 1:
        kinds = {names[0]: "single"}
    elif n_series <= 1 and n_parallel <= 2 and len(names) <= 3:
        kinds = {nm: distributions[nm]["dist_type"] for nm in names}
    else:
        kinds = {nm: "multi" for nm in names}

    # row-equilibration scale of SA/SASY: S = diag(1/|Y|)
    if SA or SASY:
        Ymod = np.abs(1.0 / np.asarray(Z_scaled))
        row_scale = np.concatenate([Ymod, Ymod])
    else:
        row_scale = None

    dist_cfgs, A_list, L_list, x_scales = [], [], [], []
    for nm in names:
        info = distributions[nm]
        mats = dist_matrices[nm]
        k = mats["A_re"].shape[1]
        dist_cfgs.append(DistConfig(name=nm, dist_type=info["dist_type"],
                                    kernel=info.get("kernel", "DRT"), K=k))
        # scaled in float64, then cast, as the JAX package does in numpy
        A = torch.cat([f64(mats["A_re"]), f64(mats["A_im"])])
        if row_scale is not None:
            A = A / f64(row_scale)[:, None]
        s0, s1, s2 = _L_SCALES[(mode, kinds[nm])]
        L_list.append(torch.stack([s0 * f64(mats["L0"]),
                                   s1 * f64(mats["L1"]),
                                   s2 * f64(mats["L2"])]).to(dt))
        A_list.append(A.to(dt))
        x_scales.append(tens(info.get("x_scale", 1.0)
                             if info["dist_type"] == "parallel" else 1.0))

    Z = np.asarray(Z_scaled)
    if fitY:
        Y = 1.0 / Z
        target = np.concatenate([Y.real, Y.imag])
        if SASY:
            target = target / row_scale
    else:
        target = np.concatenate([Z.real, Z.imag])
    if part == "both":
        mask = np.ones(2 * n)
    elif part == "real":
        mask = np.concatenate([np.ones(n), np.zeros(n)])
    else:
        mask = np.concatenate([np.zeros(n), np.ones(n)])
    # mode-dependent hyperparameters
    if mode == "sample":
        ups_alpha, ups_beta, sigma_out_alpha = 1.0, 0.1, 5.0
    else:
        ups_alpha, ups_beta, sigma_out_alpha = 0.05, 0.1, 2.0

    cfg = PosteriorConfig(dists=tuple(dist_cfgs), nonneg=nonneg,
                          outliers=outliers, fitY=fitY, part=part, ncp=ncp,
                          sa=SA)
    data = PosteriorData(
        A=tuple(A_list), L=tuple(L_list), target=tens(target),
        freq=tens(freq), sigma_min=tens(sigma_min),
        ups_alpha=tens(ups_alpha), ups_beta=tens(ups_beta),
        induc_scale=tens(inductance_scale),
        x_sum_invscale=tens(_x_sum_invscale(mode, n_series, n_parallel)),
        x_scales=tuple(x_scales), sigma_out_lambda=tens(outlier_lambda),
        sigma_out_alpha=tens(sigma_out_alpha), sigma_out_beta=tens(1.0),
        lik_mask=tens(mask), sa_inv=tens(row_scale) if SA else None)
    return cfg, data
