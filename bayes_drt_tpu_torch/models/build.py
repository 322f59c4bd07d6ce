"""Assembly of PosteriorConfig/PosteriorData for the single series
distribution (port of bayes_drt_tpu/models/build.py:46-214).

The calibration table ``_L_SCALES`` is copied verbatim from the JAX
package; only its single-distribution rows are reachable here.
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


def z_scale_for(distributions: dict, Z):
    """The reference's Z-scale rule for series distributions:
    std|Z| / sqrt(N/81) (hyperparameters calibrated at N=81)."""
    infos = list(distributions.values())
    if any(i["dist_type"] != "series" for i in infos):
        raise NotImplementedError("only series distributions are ported")
    Z = np.asarray(Z)
    n = Z.shape[-1]
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
                    nonneg: bool = False, sigma_min: float = 0.002,
                    dtype=None, ncp: bool = False, device=None):
    """Returns (PosteriorConfig, PosteriorData) for one series
    distribution. ``Z_scaled`` is the complex impedance after Z-scaling;
    ``dist_matrices[name]`` holds A_re, A_im (N, K) and L0, L1, L2 (K, K)
    as numpy arrays or tensors."""
    if mode not in ("optimize", "sample"):
        raise ValueError(f"Invalid mode {mode!r}")
    if part not in ("both", "real", "imag"):
        raise ValueError(f"Invalid part {part!r}")
    names = sort_distributions(distributions)
    if len(names) != 1 or distributions[names[0]]["dist_type"] != "series":
        raise NotImplementedError(
            "the torch port builds the single series-distribution model "
            "only")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)

    def tens(a):
        if not isinstance(a, torch.Tensor):
            a = np.array(a, dtype=float)  # a copy: contiguous, keeps 0-d
        return torch.as_tensor(a, device=dev).to(dt)

    freq = np.asarray(frequencies, dtype=float)
    n = len(freq)
    nm = names[0]
    info = distributions[nm]
    mats = dist_matrices[nm]
    k = mats["A_re"].shape[1]
    dist = DistConfig(name=nm, dist_type="series",
                      kernel=info.get("kernel", "DRT"), K=k)
    A = torch.cat([tens(mats["A_re"]), tens(mats["A_im"])])
    s0, s1, s2 = _L_SCALES[(mode, "single")]
    L = torch.stack([s0 * tens(mats["L0"]), s1 * tens(mats["L1"]),
                     s2 * tens(mats["L2"])])

    Z = np.asarray(Z_scaled)
    target = np.concatenate([Z.real, Z.imag])
    if part == "both":
        mask = np.ones(2 * n)
    elif part == "real":
        mask = np.concatenate([np.ones(n), np.zeros(n)])
    else:
        mask = np.concatenate([np.zeros(n), np.ones(n)])
    if mode == "sample":
        ups_alpha, ups_beta, sigma_out_alpha = 1.0, 0.1, 5.0
    else:
        ups_alpha, ups_beta, sigma_out_alpha = 0.05, 0.1, 2.0

    cfg = PosteriorConfig(dists=(dist,), nonneg=nonneg, part=part, ncp=ncp)
    data = PosteriorData(
        A=(A,), L=(L,), target=tens(target), freq=tens(freq),
        sigma_min=tens(sigma_min), ups_alpha=tens(ups_alpha),
        ups_beta=tens(ups_beta), induc_scale=tens(1.0),
        x_sum_invscale=tens(0.0), x_scales=(tens(1.0),),
        sigma_out_lambda=tens(10.0), sigma_out_alpha=tens(sigma_out_alpha),
        sigma_out_beta=tens(1.0), lik_mask=tens(mask))
    return cfg, data
