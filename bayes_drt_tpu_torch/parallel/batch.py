"""Batched Bayesian inversion of many spectra on one frequency grid (port
of bayes_drt_tpu/parallel/batch.py).

``fit_spectra_batch`` fits any model of the distributions mini-DSL (DRT
and DDT, series and parallel, any number of each, with or without the
outlier error). ``mode='sample'`` samples B spectra x C chains as one
(B*C, D) chain axis through NUTS (infer/nuts.py, the default) or, for the
single series DRT, the flat-chain SHMC sampler (infer/shmc_flat.py, every
draw one launch of the hand-written trajectory kernel), summarizes each
spectrum's posterior on the device, and by default refits the spectra
that fail the mixing gate with a ridge-seeded NUTS run spliced into the
result. ``mode='optimize'`` finds each spectrum's MAP point with the
batched L-BFGS and Newton polish of infer/map.py, from random restarts or
a ridge seed. The single series DRT takes the hand-written value and
gradient; every other model autograd of models/posterior.log_density.
``ridge_fit_spectra_batch`` is the batched hyper-lambda ridge
(infer/ridge.py) that seeds both; ``predict_Z_batch`` evaluates a fit's
impedance. A DRT's A matrices come from the hand-written quadrature
kernel (ops/quad.py).

Not ported yet: the generic SHMC sampler, ChEES, warm starts, the pooled
preconditioner, the ridge seed of a single parallel distribution,
cross-validated and hyper-weights ridge, ragged batches and meshes.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._numerics import resolve_device, resolve_dtype
from ..infer.chees import SHMCConfig
from ..infer.diagnostics import ess_bulk_jnp, ess_jnp, rhat_rank_jnp
from ..infer.map import newton_polish, run_lbfgs, run_lbfgs_restarts
from ..infer.nuts import NUTSConfig, sample_nuts
from ..infer.ridge import (HyperLambdaConfig, RidgeData, run_hyper_lambda,
                           run_ordinary_ridge)
from ..infer.shmc_flat import (flat_eligible, flat_shared_for,
                               flat_spec_for, flat_value_and_grad,
                               sample_shmc_flat)
from ..models.build import build_posterior, sort_distributions, z_scale_for
from ..models.posterior import (constrain, flat_dim, init_unconstrained,
                                log_density, posterior_value_and_grad,
                                predict_target, ravel, unravel)
from ..ops.matrices import (construct_A, construct_L, construct_M,
                            default_epsilon, get_tau_basis)


def _pad_rows(arr, b):
    """Pad the leading (spectra) axis to b rows by repeating the first row
    (matches _pad_pow2's padding of the spectra themselves)."""
    if arr.shape[0] == b:
        return arr
    pad = np.repeat(arr[:1], b - arr.shape[0], axis=0)
    return np.concatenate([arr, pad], axis=0)


def _pad_pow2(Z_batch, min_size: int = 8):
    """Pad the batch to the next power of two (>= min_size) by repeating the
    first spectrum, as the JAX package does. Here it keeps the flat chain
    axis a multiple of the trajectory kernel's row tile. Returns
    (padded batch, real batch size)."""
    b = Z_batch.shape[0]
    target = min_size
    while target < b:
        target *= 2
    return _pad_rows(Z_batch, target), b


class BatchFitResult(NamedTuple):
    """Results for a batch of spectra (numpy arrays on the host)."""
    coef: np.ndarray          # (B, K) posterior-mean coefficients, rescaled
    r_inf: np.ndarray         # (B,)
    inductance: np.ndarray    # (B,)
    gamma_lo: Optional[np.ndarray]   # (B, K) 2.5th percentile coefs
    gamma_hi: Optional[np.ndarray]   # (B, K) 97.5th percentile coefs
    z_scales: np.ndarray      # (B,)
    tau: np.ndarray           # (K,)
    epsilon: float
    diagnostics: dict
    basis: str = "gaussian"   # RBF family the coefficients live in


# named sampler presets for fit_spectra_batch(quality=...), the JAX
# package's, less what the port does not have: 'fast' is the bench's SHMC
# configuration without the bf16x3 matmuls (precision="high") and the scan
# unroll knobs of the JAX package's compiled loops, and without
# recompute_grad (the trajectory kernel returns the selected gradient);
# 'strict' is the calibrated-interval NUTS configuration (md8, not Stan's
# md10: the DRT posterior's trajectories saturate at ~255 leapfrogs).
QUALITY_PRESETS = {
    "fast": dict(
        sampler="shmc", ncp=True, chains=4, warmup=150, samples=250,
        shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32, eps_quantile=0.5)),
    "strict": dict(
        sampler="nuts", ncp=True, chains=4, warmup=1000, samples=1000,
        max_tree_depth=8, tree_scan=True, scan_unroll=2),
}


# spectra summarized at a time: bounds the sort and FFT workspace
_SUMMARY_BLOCK = 64


def _gaussian_rbf_np(y, epsilon):
    return np.exp(-((epsilon * y) ** 2))


def _percentile(x, q: float, dim: int):
    """numpy/jnp 'linear' percentile along ``dim`` by sorting (torch's
    quantile refuses inputs above 2**24 elements)."""
    m = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    pos = q / 100.0 * (m - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, m - 1)
    frac = pos - lo
    a = s.select(dim, lo)
    return a + frac * (s.select(dim, hi) - a)


def _make_summarize(cfg, chains, samples):
    """Per-spectrum posterior summary on the device for a block of spectra:
    posterior means and percentiles, logp split-Rhat and chain gap,
    divergence/accept statistics, bulk ESS of logp and gamma monitors,
    rank-normalized Rhat/ESS over all parameters (d_chunk=32 blocking), the
    metric-normalized largest posterior eigenvalue, optional pointwise
    gamma bands, the posterior-predictive impedance (the mean over draws of
    each draw's prediction, through the parallel inversion) and the
    posterior-mean coefficients of every further distribution
    (``coef_<i>``)."""

    def summarize(dat, draws, info, phi_mon, phi_eval):
        bc, _, _, d = draws.shape                     # (Bc, C, S, D)
        flat = draws.reshape(bc, chains * samples, d)
        c = constrain(cfg, dat, unravel(cfg, flat))
        xs = c["x_0"]                                 # (Bc, CS, K)
        lp = info["logp"]                             # (Bc, C, S)
        half = lp.shape[-1] // 2
        lp_split = torch.cat([lp[..., :half], lp[..., half:2 * half]], dim=1)
        cm = lp_split.mean(dim=-1)
        w_var = lp_split.var(dim=-1, correction=1).mean(dim=-1)
        b_var = half * cm.var(dim=-1, correction=1)
        var_plus = (half - 1) / half * w_var + b_var / half
        lp_rhat = torch.sqrt(var_plus / torch.clamp(w_var, min=1e-12))
        cmeans = lp.mean(dim=-1)
        inv_mass = info["inv_mass"]                   # (Bc, C, D)
        out = {
            "coef": xs.mean(dim=1),
            "coef_lo": _percentile(xs, 2.5, dim=1),
            "coef_hi": _percentile(xs, 97.5, dim=1),
            "r_inf": c["Rinf"].mean(dim=1),
            "induc": c["induc"].mean(dim=1),
            "divergence_rate": info["diverging"].to(lp.dtype).mean(
                dim=(1, 2)),
            "accept_prob": info["accept_prob"].mean(dim=(1, 2)),
            "n_leapfrog": info["n_leapfrog"].to(torch.float32).mean(
                dim=(1, 2)),
            "logp_rhat": lp_rhat,
            "logp_chain_gap": cmeans.max(dim=1).values
            - cmeans.min(dim=1).values,
            "state_q": draws[:, :, -1, :],
            "state_inv_mass": inv_mass,
            "state_step_size": info["step_size"],
        }
        gmon = (xs @ phi_mon.T).reshape(bc, chains, samples, -1)
        ess_q = ess_jnp(torch.cat([lp[..., None], gmon], dim=-1))
        out["ess_logp"] = ess_q[:, 0]
        out["min_ess"] = ess_q.min(dim=-1).values
        out["rank_rhat_max"] = rhat_rank_jnp(draws, d_chunk=32).max(
            dim=-1).values
        out["ess_bulk_min"] = ess_bulk_jnp(draws, d_chunk=32).min(
            dim=-1).values
        # power iteration on the pooled draws, centered on the global mean
        # and scaled by the adapted metric
        y = ((draws - flat.mean(dim=1)[:, None, None, :])
             / torch.sqrt(torch.clamp(inv_mass, min=1e-30))[:, :, None, :])
        yf = y.reshape(bc, chains * samples, d)
        nrm = yf.shape[1] - 1
        v = torch.full((bc, d, 1), 1.0 / math.sqrt(d), dtype=yf.dtype,
                       device=yf.device)
        for _ in range(24):
            w = torch.bmm(yf.transpose(1, 2), torch.bmm(yf, v)) / nrm
            lam = torch.linalg.norm(w, dim=(1, 2))
            v = w / (lam + 1e-30)[:, None, None]
        out["metric_lambda_max"] = lam
        if phi_eval.shape[0] > 0:
            ge = xs @ phi_eval.T
            out["gamma_eval_mean"] = ge.mean(dim=1)
            out["gamma_eval_lo"] = _percentile(ge, 2.5, dim=1)
            out["gamma_eval_hi"] = _percentile(ge, 97.5, dim=1)
        if not cfg.fitY:
            preds = predict_target(cfg, dat, c)
            out["z_hat_mean"] = preds.mean(dim=1)
            out["z_hat_std"] = preds.std(dim=1, correction=0)
        for i in range(1, len(cfg.dists)):
            out[f"coef_{i}"] = c[f"x_{i}"].mean(dim=1)
        return out

    return summarize


def _normalize_distributions(distributions):
    """Light normalization of the distributions mini-DSL with the JAX
    package's defaults (a DDT's ``bc`` defaults to 'blocking', not
    construct_A's 'transmissive'); default: one series DRT."""
    if distributions is None:
        return {"DRT": {"kernel": "DRT", "dist_type": "series"}}
    distributions = {k: dict(v) for k, v in distributions.items()}
    for info in distributions.values():
        if info.get("kernel") == "DRT":
            info.setdefault("dist_type", "series")
        else:
            info.setdefault("dist_type", "parallel")
            info.setdefault("symmetry", "planar")
            info.setdefault("bc", "blocking")
            info.setdefault("ct", False)
    return distributions


def _build_shared(frequencies, mode="sample", basis_freq=None, epsilon=None,
                  nonneg=False, dtype=None, ncp=False, sigma_min=0.002,
                  distributions=None, basis="gaussian", outliers=False,
                  device=None):
    """Matrices at the common (descending) frequency grid for every
    distribution of ``distributions`` (default: one series DRT), each with
    its own ``basis_freq`` / ``epsilon`` (falling back to the arguments,
    then to the grid), and the ``mode`` posterior built from them. A DRT's
    A is integrated in float64 by ops/quad.py (two kernel launches on a
    CUDA device), a DDT's in plain torch. Returns (frequencies, tau and
    epsilon of the first distribution, cfg, data, the normalized
    distributions, each carrying its grid under ``_tau`` / ``_epsilon``)."""
    dev = resolve_device(device)
    frequencies = np.sort(np.asarray(frequencies, float))[::-1]
    distributions = _normalize_distributions(distributions)
    dist_mats = {}
    first = None
    for name, info in distributions.items():
        bf = info.get("basis_freq", basis_freq)
        if bf is None:
            tau = get_tau_basis(frequencies)
        else:
            tau = 1.0 / (2 * np.pi * np.asarray(bf, float))
        eps = info.get("epsilon", epsilon)
        eps = default_epsilon(tau) if eps is None else float(eps)
        f_coll = 1.0 / (2 * np.pi * tau)
        kw = dict(tau=tau, epsilon=eps, basis=info.get("basis", basis),
                  dtype=torch.float64, device=dev)
        akw = dict(kernel=info.get("kernel", "DRT"),
                   dist_type=info["dist_type"],
                   symmetry=info.get("symmetry", "planar"),
                   bc=info.get("bc", "transmissive"),
                   ct=info.get("ct", False), k_ct=info.get("k_ct", None))
        mats = {"A_re": construct_A(frequencies, "real", **kw, **akw),
                "A_im": construct_A(frequencies, "imag", **kw, **akw)}
        for o in (0, 1, 2):
            mats[f"L{o}"] = construct_L(f_coll, order=o, **kw)
        dist_mats[name] = mats
        info["_tau"], info["_epsilon"] = tau, eps
        if first is None:
            first = (tau, eps)
    z_dummy = np.ones(len(frequencies)) + 0j   # replaced per spectrum
    cfg, data = build_posterior(distributions, dist_mats, frequencies,
                                z_dummy, mode=mode, nonneg=nonneg,
                                outliers=outliers, sigma_min=sigma_min,
                                dtype=dtype, ncp=ncp, device=dev)
    return (frequencies,) + first + (cfg, data, distributions)


def _dist_geometry(dists_norm):
    """Each distribution's kernel and grid in the posterior's order (series
    first, then parallel, each by name: the order of coef and coef_<i>),
    from which predict_Z_batch rebuilds A at new frequencies."""
    return tuple(
        {"name": nm, "kernel": dists_norm[nm].get("kernel", "DRT"),
         "dist_type": dists_norm[nm]["dist_type"],
         "symmetry": dists_norm[nm].get("symmetry", "planar"),
         "bc": dists_norm[nm].get("bc", "transmissive"),
         "ct": dists_norm[nm].get("ct", False),
         "k_ct": dists_norm[nm].get("k_ct", None),
         "basis": dists_norm[nm].get("basis", "gaussian"),
         "tau": dists_norm[nm]["_tau"],
         "epsilon": dists_norm[nm]["_epsilon"]}
        for nm in sort_distributions(dists_norm))


class MapObjective:
    """The MAP loss on (R, D) rows of unconstrained parameters, row i
    fitting ``targets[i]`` (R, 2n): minus the log posterior without the
    transforms' Jacobian (Stan's ``optimizing`` objective).
    ``value_and_grad`` is the hand-written gradient of infer/shmc_flat.py
    for the single series DRT and autograd of models/posterior.log_density
    (one backward pass over all rows) for every other model; ``hessian``
    is autograd of log_density for every model, as the JAX package takes
    ``jax.hessian``: reverse over reverse (torch.func.jacrev twice), since
    torch.func.hessian's forward-over-reverse fails on a float32 matmul (a
    float64 tangent) and is slower. Both take the rows' indices into
    ``targets`` (all rows when None)."""

    def __init__(self, cfg, data, targets):
        self.cfg, self.data, self.targets = cfg, data, targets
        self.flat = flat_eligible(cfg)
        if self.flat:
            self.spec = flat_spec_for(cfg, data)
            self.shared = flat_shared_for(cfg, data, targets.dtype)

    def _targets(self, rows):
        return self.targets if rows is None else self.targets[rows]

    def value_and_grad(self, q, rows=None):
        if self.flat:
            sh = self.shared
            lp, g = flat_value_and_grad(self.spec, sh.A, sh.L, sh.vecs,
                                        sh.scal, q, self._targets(rows),
                                        jacobian=False)
        else:
            lp, g = posterior_value_and_grad(self.cfg, self.data,
                                             self._targets(rows),
                                             jacobian=False)(q)
        return -lp, -g

    def hessian(self, q, rows=None):
        cfg, data = self.cfg, self.data

        def loss(q_row, t_row):
            return -log_density(cfg, data._replace(target=t_row),
                                unravel(cfg, q_row), jacobian=False)

        hess = torch.func.jacrev(torch.func.jacrev(loss))
        return torch.func.vmap(hess)(q, self._targets(rows))


def _ridge_init_values(frequencies, Z_batch, b_real, z_scales, K,
                       ridge_kw, dtype, device, basis_freq=None,
                       epsilon=None):
    """Per-spectrum ridge-seeded init values for a single series
    distribution: one batched hyper-lambda ridge pass over the real
    spectra, padded like the batch, in the scaled coordinates
    init_unconstrained expects (x, and R_inf and inductance before their
    x100 / induc_scale transforms)."""
    rdefaults = dict(penalty="integral", hyper_lambda=True, lambda_0=1.0,
                     hl_beta=5, weights="modulus")
    rdefaults.update(ridge_kw or {})
    rres = ridge_fit_spectra_batch(frequencies, Z_batch[:b_real],
                                   basis_freq=basis_freq, epsilon=epsilon,
                                   dtype=dtype, device=device, **rdefaults)
    b = Z_batch.shape[0]
    iv_x = _pad_rows(np.asarray(rres.coef), b)
    iv_rinf_t = _pad_rows(np.asarray(rres.r_inf), b)
    iv_induc_t = _pad_rows(np.asarray(rres.inductance), b)
    if iv_x.shape[1] != K:
        raise ValueError(f"ridge init basis ({iv_x.shape[1]}) does not "
                         f"match the fit basis ({K})")
    iv_x = iv_x / z_scales[:, None]
    iv_rinf = np.maximum(iv_rinf_t / z_scales, 1e-10) / 100.0
    iv_induc = np.maximum(iv_induc_t / z_scales, 1e-10)
    return iv_x, iv_rinf, iv_induc


def _outlier_seed(iv_x, iv_rinf, iv_induc, targets, data):
    """The outlier model's sigma_out seed from a ridge solution: 1.0 at the
    frequencies whose real or imaginary ridge residual exceeds 3 standard
    deviations of the spectrum's residuals, 0.1 elsewhere (a z-score form
    of the reference's IQR check). numpy, (b, n)."""
    freq = data.freq.cpu().numpy()
    n_f = len(freq)
    rv = np.concatenate([np.ones(n_f), np.zeros(n_f)])
    lv = np.concatenate([np.zeros(n_f), 2.0 * np.pi * freq])
    zhat = (iv_x @ data.A[0].cpu().numpy().T
            + (iv_rinf * 100.0)[:, None] * rv[None, :]
            + iv_induc[:, None] * lv[None, :])
    resid = targets.cpu().numpy() - zhat
    sig = resid.std(axis=1, keepdims=True) + 1e-12
    flag = ((np.abs(resid[:, :n_f]) > 3 * sig)
            | (np.abs(resid[:, n_f:]) > 3 * sig))
    return np.where(flag, 1.0, 0.1)


def _ridge_seed(frequencies, Z_batch, b_real, z_scales, cfg, data, targets,
                ridge_kw, dtype, device, basis_freq, epsilon, outliers):
    """init_unconstrained's init_values from the batched ridge, (b, ...)
    rows: x_0, Rinf_raw, induc_raw and, with ``outliers``, the 3-sigma
    sigma_out_raw seed."""
    iv_x, iv_rinf, iv_induc = _ridge_init_values(
        frequencies, Z_batch, b_real, z_scales, cfg.dists[0].K, ridge_kw,
        dtype, device, basis_freq=basis_freq, epsilon=epsilon)
    iv = {"x_0": iv_x, "Rinf_raw": iv_rinf, "induc_raw": iv_induc}
    if outliers:
        iv["sigma_out_raw"] = _outlier_seed(iv_x, iv_rinf, iv_induc,
                                            targets, data)
    return iv


def _per_spectrum(x, b, chains):
    """(T, b*chains, ...) per-draw rows -> (b, chains, T, ...)."""
    return x.reshape((x.shape[0], b, chains) + x.shape[2:]).movedim(0, 2)


_ITEM_10 = "is not ported yet (ROADMAP Queue 1 item 10)"
_ITEM_11 = ("needs the per-spectrum admittance ridge of a single parallel "
            "distribution, which is not ported yet (ROADMAP Queue 1 item 11)")


def fit_spectra_batch(frequencies, Z_batch, mode: str = "sample",
                      basis_freq=None, epsilon=None, nonneg: bool = False,
                      outliers: bool = False, chains: int = 4,
                      warmup: int = 500, samples: int = 500,
                      max_iter: int = 2000, n_restarts: int = 2,
                      polish: bool = True,
                      init_from_ridge: bool = False,
                      ridge_kw: Optional[dict] = None,
                      random_seed: int = 0, max_tree_depth: int = 10,
                      dtype=None, distributions=None,
                      precondition: Optional[str] = None,
                      ncp: bool = False, unroll: int = 1,
                      flat_tree: bool = False, tree_scan: bool = False,
                      scan_unroll: int = 1, basis: str = "gaussian",
                      gamma_eval_tau=None, monitor_thin: int = 0,
                      z_scale=None, sigma_min: float = 0.002,
                      sampler: str = "nuts", shmc_cfg=None,
                      warm_start=None, quality: Optional[str] = None,
                      escalate: Optional[bool] = None,
                      escalate_gate: Optional[dict] = None,
                      escalate_kw: Optional[dict] = None,
                      timing: bool = False, device=None) -> BatchFitResult:
    """Fit B spectra sharing one frequency grid. ``distributions`` uses the
    Inverter mini-DSL (default: one series DRT): any number of series and
    parallel DRT/DDT distributions, each with its own ``basis_freq``,
    ``epsilon``, ``x_scale`` (parallel), DDT ``symmetry``/``bc``/``ct``;
    the basis is at ``basis_freq`` with inverse length scale ``epsilon``
    unless a distribution says otherwise, both from the grid by default;
    ``sigma_min`` is the error model's floor, ``nonneg`` makes series
    coefficients nonnegative and ``outliers`` adds the per-frequency
    outlier error (the ``_outliers`` models). ``coef`` holds the first
    distribution in the posterior's order (series first, then parallel,
    each by name), the others are under ``diagnostics['coef_<i>']``;
    series coefficients are in impedance units, parallel ones in
    admittance units. ``diagnostics['dist_geometry']`` records each
    distribution's kernel and grid.

    ``mode='optimize'`` finds each spectrum's MAP point: L-BFGS from
    ``n_restarts`` Stan-random starts (all B * n_restarts runs as one row
    axis, each spectrum keeping its best finite optimum) or, with
    ``init_from_ridge``, one run from the batched hyper-lambda ridge
    solution, capped at ``max_iter`` iterations, then (``polish``) a
    damped Newton refinement. ``gamma_lo``/``gamma_hi`` are None;
    ``diagnostics`` holds each spectrum's ``value`` (the minimized
    objective), ``n_iter`` (L-BFGS plus polish iterations), ``grad_norm``
    and ``converged`` (exited on tolerance; the certificate).

    ``mode='sample'``: Z_batch is complex (B, N). All B*chains chains run
    as one (B*chains, D) row axis. ``sampler='nuts'`` (the default) runs
    NUTS with ``max_tree_depth`` and a per-chain step size and diagonal
    metric;
    ``tree_scan`` runs every tree's static 2^max_tree_depth - 1 leaves,
    ``flat_tree`` and the default stop a tree once no chain is still
    building it (the same draws either way). ``unroll`` and
    ``scan_unroll`` tune the JAX package's compiled loops and have no
    effect here. ``sampler='shmc'`` runs the flat-chain SHMC sampler, one
    launch of the hand-written trajectory kernel per draw, with
    ``shmc_cfg`` (the single series DRT only). Runs on CUDA unless
    ``device`` says otherwise, float32 unless ``dtype`` says otherwise;
    random numbers come from a torch.Generator seeded with
    ``random_seed``. The single series DRT without outliers takes the
    hand-written value and gradient (infer/shmc_flat.py); every other
    model autograd of models/posterior.log_density.

    ``init_from_ridge`` (a single series distribution): every chain, or
    the one L-BFGS run, starts at the coordinates of a batched
    hyper-lambda ridge solution (``ridge_kw`` overrides its defaults), the
    other parameters Stan-random; with ``outliers``, ``sigma_out`` starts
    high at the frequencies whose ridge residual exceeds 3 standard
    deviations. ``z_scale`` overrides the data-derived per-spectrum scale
    (for a single parallel planar DDT the rule targets the calibrated
    admittance std Y*).

    ``quality``: a named preset of QUALITY_PRESETS overriding the sampler
    choice and budget ('fast': the bench's SHMC configuration; 'strict':
    NUTS md8, 4x(1000+1000)).

    ``escalate``: refit spectra that fail the per-spectrum mixing gate
    (``escalation_mask``; ``escalate_gate`` overrides its thresholds) with
    NUTS max_depth=8, tree_scan, seeded from the ridge solution when the
    model has one distribution (``escalate_kw`` overrides the refit's
    arguments), and splice the refit into the result;
    ``diagnostics['escalated']`` records the mask. The default None is on
    for ``sampler='shmc'`` and for single-distribution NUTS without
    ``init_from_ridge``.

    ``timing`` records host-clock spans closed by a device synchronize
    (``diagnostics['phase_s']``: setup, ridge when seeded, then sample and
    summary, or lbfgs and polish, with the L-BFGS part of ``n_iter`` in
    ``diagnostics['n_iter_lbfgs']``), the trajectory kernel's per-draw device
    times (SHMC, ``diagnostics['traj_ms']``), each NUTS draw's seconds
    (``diagnostics['draw_s']``) and the escalation refit's seconds
    (``diagnostics['refit_s']``).

    Not ported (they raise, naming their ROADMAP item): ``sampler='shmc'``
    and the 'fast' preset beyond the single series DRT and bases other
    than 'gaussian' and ``monitor_thin`` (item 10); a ridge seed of a
    single parallel distribution, so its default escalation too (item
    11); ChEES, ``warm_start`` and ``precondition`` (item 12).
    """
    if quality is not None:
        if quality not in QUALITY_PRESETS:
            raise ValueError(f"Unknown quality preset {quality!r}; options "
                             f"are {sorted(QUALITY_PRESETS)}")
        if mode != "sample":
            raise ValueError("quality presets configure the sampler; use "
                             "mode='sample'")
        p = QUALITY_PRESETS[quality]
        sampler = p["sampler"]
        ncp = p["ncp"]
        chains = p["chains"]
        warmup = p["warmup"]
        samples = p["samples"]
        shmc_cfg = p.get("shmc_cfg", shmc_cfg)
        max_tree_depth = p.get("max_tree_depth", max_tree_depth)
        tree_scan = p.get("tree_scan", tree_scan)
        scan_unroll = p.get("scan_unroll", scan_unroll)
    if mode not in ("sample", "optimize"):
        raise ValueError(f"Invalid mode {mode!r}; options are 'sample', "
                         "'optimize'")
    if basis != "gaussian":
        raise NotImplementedError(f"basis={basis!r} {_ITEM_10}")
    if monitor_thin:
        raise NotImplementedError(f"monitor_thin {_ITEM_10}")
    dists = _normalize_distributions(distributions)
    n_dists = len(dists)
    single_parallel = (n_dists == 1 and next(iter(dists.values()))[
        "dist_type"] == "parallel")
    if init_from_ridge:
        if n_dists > 1:
            raise ValueError("Ridge initialization can only be performed "
                             "for single-distribution fits")
        if single_parallel:
            raise NotImplementedError(f"init_from_ridge {_ITEM_11}")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    phases = {}
    clock = [time.perf_counter()]

    def mark(name):
        if timing:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            phases[name] = now - clock[0]
            clock[0] = now

    Z_batch = np.asarray(Z_batch)
    order = np.argsort(np.asarray(frequencies, float))[::-1]
    frequencies = np.asarray(frequencies, float)[order]
    Z_batch, b_real = _pad_pow2(Z_batch[:, order])
    b = Z_batch.shape[0]
    setup_kw = dict(basis_freq=basis_freq, epsilon=epsilon, nonneg=nonneg,
                    sigma_min=sigma_min, distributions=distributions,
                    outliers=outliers)
    if mode == "optimize":
        return _fit_map(frequencies, Z_batch, b_real, setup_kw, z_scale, dt,
                        dev, random_seed, init_from_ridge, ridge_kw,
                        n_restarts, max_iter, polish, mark,
                        phases if timing else None)
    if sampler == "chees":
        raise NotImplementedError("sampler='chees' is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")
    if sampler not in ("nuts", "shmc"):
        raise ValueError(f"Unknown sampler {sampler!r}; options are "
                         "'nuts', 'chees', 'shmc'")
    for name, val in (("warm_start", warm_start),
                      ("precondition", precondition)):
        if val is not None:
            raise NotImplementedError(f"{name}= is not ported yet (ROADMAP "
                                      "Queue 1 item 12)")
    flat = (n_dists == 1 and not single_parallel and not outliers)
    if sampler == "shmc" and not flat:
        raise NotImplementedError(
            "sampler='shmc' beyond the single series DRT needs the generic "
            f"sample_shmc, which {_ITEM_10}")
    if init_from_ridge and sampler == "shmc":
        raise ValueError("init_from_ridge does not support the flat-chain "
                         "SHMC sampler; use sampler='nuts'")
    # the escalation's refit, resolved up front so that a refit the port
    # cannot run raises before the fit, not after a spectrum is flagged
    if escalate is None:
        escalate = (warm_start is None
                    and (sampler == "shmc"
                         or (sampler == "nuts" and n_dists == 1
                             and not init_from_ridge)))
    esc_kw = dict(sampler="nuts", max_tree_depth=8, tree_scan=True,
                  scan_unroll=2, ncp=ncp)
    if n_dists == 1:
        # the refit's chains start from a ridge solution: stuck chains are
        # an initialization pathology, not a trajectory-length one
        esc_kw["init_from_ridge"] = True
    esc_kw.update(escalate_kw or {})
    if escalate and single_parallel and esc_kw.get("init_from_ridge"):
        raise NotImplementedError(
            f"the default escalation refit (escalate=None or True) {_ITEM_11}"
            "; pass escalate=False")
    if sampler == "shmc":
        sh_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
        sh_cfg.validate()
    else:
        nuts_cfg = NUTSConfig(max_depth=max_tree_depth, unroll=unroll,
                              flat_tree=flat_tree, tree_scan=tree_scan,
                              scan_unroll=scan_unroll)
        nuts_cfg.validate()
    frequencies, tau, eps, cfg, data, dists_norm = _build_shared(
        frequencies, dtype=dt, ncp=ncp, device=dev, **setup_kw)
    z_scales, targets = _scaled_targets(Z_batch, b_real, z_scale, dt, dev,
                                        dists_norm)

    k0 = len(tau)
    mon_idx = np.unique(np.linspace(0, k0 - 1, 8).astype(int))
    phi_mon = torch.as_tensor(_gaussian_rbf_np(
        np.log(tau[mon_idx][:, None] / tau[None, :]), eps), device=dev).to(dt)
    if gamma_eval_tau is not None:
        ge_tau = np.asarray(gamma_eval_tau, float)
        phi_eval = torch.as_tensor(_gaussian_rbf_np(
            np.log(ge_tau[:, None] / tau[None, :]), eps), device=dev).to(dt)
    else:
        phi_eval = torch.zeros((0, k0), dtype=dt, device=dev)

    D = flat_dim(cfg, data.freq.shape[0])
    gen = torch.Generator(device=dev).manual_seed(int(random_seed))
    tgt_rows = targets.repeat_interleave(chains, dim=0).contiguous()
    if flat:
        spec = flat_spec_for(cfg, data)
        shared = flat_shared_for(cfg, data, dt)

        def vg(q):
            return flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                       shared.scal, q, tgt_rows)
    else:
        vg = posterior_value_and_grad(cfg, data, tgt_rows)
    mark("setup")
    init_values = None
    if init_from_ridge:
        iv = _ridge_seed(frequencies, Z_batch, b_real, z_scales, cfg, data,
                         targets, ridge_kw, dt, dev, basis_freq, epsilon,
                         outliers)
        init_values = {k: v[:, None] for k, v in iv.items()}
        mark("ridge")
    q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                       batch_shape=(b, chains),
                                       init_values=init_values))
    q0 = q0.reshape(b * chains, D).contiguous()

    if sampler == "shmc":
        time_traj = timing and dev.type == "cuda"
        draws, info = sample_shmc_flat(spec, shared, tgt_rows, q0, warmup,
                                       samples, sh_cfg, chains, generator=gen,
                                       time_traj=time_traj)
        info["inv_mass"] = info["inv_mass"][:, None, :].expand(-1, chains, -1)
    else:
        draws, raw = sample_nuts(vg, q0, warmup, samples, nuts_cfg,
                                 generator=gen, time_draws=timing)
        draws = _per_spectrum(draws, b, chains)
        info = {k: _per_spectrum(raw[k], b, chains)
                for k in ("logp", "accept_prob", "diverging", "n_leapfrog",
                          "energy", "warmup_diverging")}
        info["step_size"] = raw["step_size"].reshape(b, chains)
        info["inv_mass"] = raw["inv_mass"].reshape(b, chains, D)
        if timing:
            info["draw_s"] = raw["draw_s"]
    mark("sample")

    summarize = _make_summarize(cfg, chains, samples)
    blocks = []
    for i in range(0, b_real, _SUMMARY_BLOCK):
        sl = slice(i, min(i + _SUMMARY_BLOCK, b_real))
        inf_b = {k: v[sl] for k, v in info.items()
                 if k not in ("traj_ms", "draw_s")}
        blocks.append(summarize(data, draws[sl], inf_b, phi_mon, phi_eval))
    out = {k: torch.cat([blk[k] for blk in blocks]).cpu().numpy()
           for k in blocks[0]}
    mark("summary")
    z_scales = z_scales[:b_real]
    diagnostics = _rescaled_diagnostics(cfg, out, z_scales, dists_norm)
    for k_ge in ("gamma_eval_mean", "gamma_eval_lo", "gamma_eval_hi"):
        if k_ge in diagnostics:
            diagnostics[k_ge] = diagnostics[k_ge] * _coef_scale(
                cfg, 0, z_scales)
    for k_z in ("z_hat_mean", "z_hat_std"):
        if k_z in diagnostics:
            diagnostics[k_z] = diagnostics[k_z] * z_scales[:, None]
    if "z_hat_mean" in diagnostics:
        # the training grid (descending), where predict_Z_batch serves the
        # draws' mean prediction
        diagnostics["f_train"] = np.asarray(frequencies, float)
    if timing:
        for k in ("traj_ms", "draw_s"):
            if k in info:
                diagnostics[k] = np.asarray(info[k])
        diagnostics["phase_s"] = phases
    scale0 = _coef_scale(cfg, 0, z_scales)
    result = BatchFitResult(
        coef=out["coef"] * scale0, r_inf=out["r_inf"] * z_scales,
        inductance=out["induc"] * z_scales,
        gamma_lo=out["coef_lo"] * scale0, gamma_hi=out["coef_hi"] * scale0,
        z_scales=z_scales, tau=tau, epsilon=eps, diagnostics=diagnostics,
        basis=basis)

    # ---- gate-triggered escalation: refit the under-mixed tail ----
    if escalate:
        gate_kw = dict(n_draws=chains * samples)
        gate_kw.update(escalate_gate or {})
        esc_mask = escalation_mask(diagnostics, b_real, **gate_kw)
        diagnostics["escalated"] = esc_mask
        if esc_mask.any():
            sub_z_scale = None
            if z_scale is not None:
                sub_z_scale = np.broadcast_to(
                    np.asarray(z_scale, float), (b_real,))[esc_mask]
            warnings.warn(
                f"{int(esc_mask.sum())}/{b_real} spectra failed the mixing "
                f"gate; refitting them with "
                f"{esc_kw.get('sampler', 'nuts')} (escalate=False disables)")
            t_refit = time.perf_counter()
            sub = fit_spectra_batch(
                frequencies, Z_batch[:b_real][esc_mask], mode="sample",
                basis_freq=basis_freq, epsilon=epsilon, nonneg=nonneg,
                outliers=outliers, chains=chains, warmup=warmup,
                samples=samples, random_seed=random_seed + 1,
                distributions=distributions, basis=basis,
                gamma_eval_tau=gamma_eval_tau, z_scale=sub_z_scale,
                sigma_min=sigma_min, dtype=dtype, escalate=False,
                timing=timing, device=dev, **esc_kw)
            if timing:
                diagnostics["refit_s"] = time.perf_counter() - t_refit
            result = _splice_results(result, sub, esc_mask)
    return result


def _coef_scale(cfg, i, z_scales):
    """(b, 1) factor from scaled to physical coefficients of distribution
    i: series coefficients multiply by the Z scale, parallel (admittance)
    ones divide."""
    if cfg.dists[i].dist_type == "parallel":
        return 1.0 / z_scales[:, None]
    return z_scales[:, None]


def _rescaled_diagnostics(cfg, out, z_scales, dists_norm):
    """Every per-spectrum output but the result's own fields, the further
    distributions' coefficients (``coef_<i>``) rescaled, and the
    distributions' geometry."""
    diagnostics = {k: out[k] for k in out
                   if k not in ("coef", "coef_lo", "coef_hi", "r_inf",
                                "induc")}
    for i in range(1, len(cfg.dists)):
        diagnostics[f"coef_{i}"] = (diagnostics[f"coef_{i}"]
                                    * _coef_scale(cfg, i, z_scales))
    diagnostics["dist_geometry"] = _dist_geometry(dists_norm)
    return diagnostics


def _scaled_targets(Z_batch, b_real, z_scale, dtype, device,
                    distributions=None):
    """Per-spectrum Z scales (the data-derived rule of ``distributions``,
    default one series DRT, or ``z_scale`` for the real rows and the last
    of it for the padding) and the scaled stacked [Re | Im] targets
    (b, 2n)."""
    b = Z_batch.shape[0]
    if z_scale is None:
        z_scales = np.atleast_1d(z_scale_for(
            _normalize_distributions(distributions), Z_batch,
            fit_type="map"))
    else:
        zs = np.broadcast_to(np.asarray(z_scale, float), (b_real,))
        z_scales = np.concatenate([zs, np.full(b - b_real, zs[-1])])
    Zs = Z_batch / z_scales[:, None]
    targets = torch.as_tensor(np.concatenate([Zs.real, Zs.imag], axis=1),
                              device=device).to(dtype)
    return z_scales, targets


def _fit_map(frequencies, Z_batch, b_real, setup_kw, z_scale, dtype, device,
             random_seed, init_from_ridge, ridge_kw, n_restarts, max_iter,
             polish, mark, phases):
    """fit_spectra_batch(mode='optimize') on the padded, descending batch:
    L-BFGS from Stan-random restarts or the ridge seed, the Newton polish,
    and the result at the real rows."""
    b = Z_batch.shape[0]
    frequencies, tau, eps, cfg, data, dists_norm = _build_shared(
        frequencies, mode="optimize", dtype=dtype, device=device,
        **setup_kw)
    z_scales, targets = _scaled_targets(Z_batch, b_real, z_scale, dtype,
                                        device, dists_norm)
    gen = torch.Generator(device=device).manual_seed(int(random_seed))
    obj = MapObjective(cfg, data, targets)
    mark("setup")
    if init_from_ridge:
        iv = _ridge_seed(frequencies, Z_batch, b_real, z_scales, cfg, data,
                         targets, ridge_kw, dtype, device,
                         setup_kw["basis_freq"], setup_kw["epsilon"],
                         cfg.outliers)
        mark("ridge")
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen, batch_shape=(b,),
                                           init_values=iv))
        res = run_lbfgs(obj.value_and_grad, q0, max_iter=max_iter)
    else:
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                           batch_shape=(b, n_restarts)))
        rows = MapObjective(cfg, data, targets.repeat_interleave(
            n_restarts, dim=0))
        res = run_lbfgs_restarts(rows.value_and_grad, q0, max_iter=max_iter)
    mark("lbfgs")
    n_lbfgs = res.n_iter
    if polish:
        # the L-BFGS cap binds before Stan-grade convergence on this
        # posterior; a damped Newton pass certifies the optimum
        pol = newton_polish(obj.value_and_grad, obj.hessian, res.params)
        res = pol._replace(n_iter=res.n_iter + pol.n_iter)
        mark("polish")
    c = constrain(cfg, data, unravel(cfg, res.params[:b_real]))
    z_scales = z_scales[:b_real]

    def host(t):
        return t[:b_real].cpu().numpy()

    out = {"value": host(res.value),
           "n_iter": host(res.n_iter).astype(np.float32),
           "grad_norm": host(res.grad_norm),
           "converged": host(res.converged)}
    for i in range(1, len(cfg.dists)):
        out[f"coef_{i}"] = c[f"x_{i}"].cpu().numpy()
    diagnostics = _rescaled_diagnostics(cfg, out, z_scales, dists_norm)
    if phases is not None:
        diagnostics["phase_s"] = phases
        diagnostics["n_iter_lbfgs"] = host(n_lbfgs).astype(np.float32)
    return BatchFitResult(
        coef=c["x_0"].cpu().numpy() * _coef_scale(cfg, 0, z_scales),
        r_inf=c["Rinf"].cpu().numpy() * z_scales,
        inductance=c["induc"].cpu().numpy() * z_scales, gamma_lo=None,
        gamma_hi=None, z_scales=z_scales, tau=tau, epsilon=eps,
        diagnostics=diagnostics)


# ---- escalation gate and splice (copied from the JAX package's
# parallel/batch.py, which this package may not import) ----

# mixing-gate thresholds for the automatic escalation pass, calibrated on
# the full 80-cell committed-reference sweep at the production SHMC config
# (benchmarks/results/paper_batch_hmc_full_shmc.csv): the failing 2RC
# double-delta cells separate from every healthy cell by the
# worst-parameter bulk ESS — the slow direction is a PARAMETER-space
# direction, invisible to the logp monitor (the 3 failing cells sat at
# logp split-Rhat 1.55-1.87 while healthy cells range to 23).
ESCALATE_ESS_BULK_MIN = 2.0

# bf16x3 ('high') matmul gradient-discrepancy probe: relative L2 error of
# the log-density gradient under bf16x3 vs true-f32 matmuls, evaluated at
# the chains' final positions; recorded as
# diagnostics['bf16x3_grad_err'] for every precision='high' fit on TPU.
# Measured across the full committed-reference sweep
# (paper_batch_hmc_full_shmc.csv): the raw endpoint discrepancy is
# CONFOUNDED by posterior sharpness (healthy noiseless cells reach 0.27
# while the 2RC bf16x3-regression cells sit at 0.013-0.036), so it is NOT
# a default escalation gate (tol=inf = opt-in via
# escalate_gate=dict(bf16x3_tol=...)); the ENFORCED guard is the
# deterministic regime warning below (long trajectories / strict budgets
# — exactly where the 2RC n128-bf16x3 regression appeared,
# paper_batch_hmc_2rc_n128.csv: 8/10 vs f32 10/10).
BF16X3_GRAD_TOL = np.inf
BF16X3_WARN_STEPS = 64            # n_steps above which bf16x3 warns
BF16X3_WARN_SAMPLES = 400         # samples above which bf16x3 warns


ESCALATE_LOGP_GAP = 100.0         # nats; stuck-chain detector, active at
                                  # Stan-grade budgets (>= ESCALATE_MIN_
                                  # DRAWS draws) where converged healthy
                                  # chains sit within ~40 nats while the
                                  # BP-DDT trap sits ~800 below — see
                                  # escalation_mask docstring
ESCALATE_LOGP_RHAT = 4.5          # absolute gate (strict budgets)
ESCALATE_MIN_DRAWS = 1600         # chains*samples below which the logp
                                  # gate is OFF: split-Rhat is mechanically
                                  # high at screening budgets (bench median
                                  # ~2.6 at 4x250 vs ~1.5 at 4x500) and
                                  # recovery there is certified by
                                  # SBC/coverage, not by Rhat
ESCALATE_LAMBDA_MAX = np.inf      # measured NON-discriminating: healthy
                                  # ill-identified (noiseless) posteriors
                                  # reach lambda ~4e4 while the 2RC failure
                                  # class sits at 855-2693 — recorded as a
                                  # diagnostic, not a default gate
                                  # (paper_batch_hmc_full_shmc.csv)


def escalation_mask(diagnostics, b_real, ess_bulk_min=None,
                    bf16x3_tol=None, logp_rhat=None, lambda_max=None,
                    n_draws=None, logp_gap=None):
    """Per-spectrum under-mixing flags from in-program diagnostics.

    Returns a boolean (b_real,) mask flagging spectra where any of:

    - between-chain mean-logp gap (``logp_chain_gap``) above
      ESCALATE_LOGP_GAP nats — a stuck-chain detector: a chain K nats
      below the best carries e^-K posterior weight, so a 100+ nat gap at
      a converged budget is never legitimate multimodality (healthy
      full-budget gaps are ~<40 nats; the BimodalBP-DDT Y~0 trap sits
      ~800 nats below, benchmarks/probe_bpddt.py). Budget-aware by
      default (screening-budget funnel chains freeze at legitimately
      different logp levels); an explicit ``logp_gap=`` applies
      unconditionally;

    - worst-parameter bulk ESS (rank-normalized, Vehtari et al. 2021)
      below its floor — catastrophic non-mixing;
    - logp split-Rhat above the absolute gate, only at Stan-grade budgets
      (chains*samples >= ESCALATE_MIN_DRAWS; split-Rhat is mechanically
      high at screening budgets) — chains sitting at different density
      levels. Calibration: every posterior-predictive-Z disagreement vs
      the reference's committed Stan fits had logp_rhat >= 4.95 while the
      healthy full-budget population's median sits ~1.5 (a batch-RELATIVE
      rule was tried and dropped: small per-family batches of
      mostly-pathological spectra push their own median past the gate)
      (benchmarks/results/paper_batch_hmc_full_shmc.csv);
    - metric-normalized slow-direction eigenvalue (``metric_lambda_max``)
      above its gate — OPT-IN (default off): measured non-discriminating
      as a universal gate because healthy ill-identified posteriors are
      equally wide (see ESCALATE_LAMBDA_MAX note), but useful on
      populations known to be well-identified;
    - the bf16x3 gradient-discrepancy probe
      (``diagnostics['bf16x3_grad_err']``, present for precision='high'
      fits on TPU) above its tolerance — also OPT-IN by default (the raw
      endpoint-gradient discrepancy is confounded by posterior sharpness;
      see the precision='high' regime warning for the enforced guard)."""
    if ess_bulk_min is None:
        ess_bulk_min = ESCALATE_ESS_BULK_MIN
    if bf16x3_tol is None:
        bf16x3_tol = BF16X3_GRAD_TOL
    if lambda_max is None:
        lambda_max = ESCALATE_LAMBDA_MAX
    ess = np.asarray(diagnostics["ess_bulk_min"])[:b_real]
    mask = ess < ess_bulk_min
    if "logp_chain_gap" in diagnostics:
        gap = np.asarray(diagnostics["logp_chain_gap"])[:b_real]
        if logp_gap is None:
            # budget-aware like the logp_rhat gate: at screening budgets
            # (short warmup) healthy funnel chains freeze at legitimately
            # different logp levels (bench-config ZARC: gap p50 ~77,
            # max ~620 nats) and the gate cannot discriminate; at
            # Stan-grade budgets chains converge in distribution and the
            # stuck-mode gap (~800 nats, benchmarks/probe_bpddt.py)
            # separates cleanly from healthy (~<40)
            if n_draws is None or n_draws >= ESCALATE_MIN_DRAWS:
                mask = mask | (gap > ESCALATE_LOGP_GAP)
        else:
            mask = mask | (gap > logp_gap)
    lp = np.asarray(diagnostics["logp_rhat"])[:b_real]
    if logp_rhat is None:
        if n_draws is None or n_draws >= ESCALATE_MIN_DRAWS:
            mask = mask | (lp > ESCALATE_LOGP_RHAT)
    else:
        mask = mask | (lp > logp_rhat)
    if "metric_lambda_max" in diagnostics:
        mask = mask | (np.asarray(
            diagnostics["metric_lambda_max"])[:b_real] > lambda_max)
    if "bf16x3_grad_err" in diagnostics:
        mask = mask | (np.asarray(diagnostics["bf16x3_grad_err"])[:b_real]
                       > bf16x3_tol)
    return np.asarray(mask, bool)


def _splice_results(result, sub, mask):
    """Overwrite the masked rows of ``result`` with ``sub``'s rows (the
    escalation refit). Array fields and per-spectrum diagnostics splice;
    non-array / non-batch diagnostics keep the primary run's values."""
    idx = np.flatnonzero(mask)
    b = result.coef.shape[0]

    def splice(a, s):
        a = np.array(a, copy=True)
        a[idx] = s
        return a

    diag = dict(result.diagnostics)
    for k, v in sub.diagnostics.items():
        cur = diag.get(k)
        if (isinstance(cur, np.ndarray) and isinstance(v, np.ndarray)
                and cur.ndim >= 1 and cur.shape[0] == b
                and v.shape[:1] == (len(idx),)
                and cur.shape[1:] == v.shape[1:]):
            diag[k] = splice(cur, v)
    diag["escalated"] = np.asarray(mask, bool)
    return result._replace(
        coef=splice(result.coef, sub.coef),
        r_inf=splice(result.r_inf, sub.r_inf),
        inductance=splice(result.inductance, sub.inductance),
        gamma_lo=(splice(result.gamma_lo, sub.gamma_lo)
                  if result.gamma_lo is not None else None),
        gamma_hi=(splice(result.gamma_hi, sub.gamma_hi)
                  if result.gamma_hi is not None else None),
        z_scales=splice(result.z_scales, sub.z_scales),
        diagnostics=diag)


# ---- batched ridge ----

def _format_weights_batch(Z, weights):
    """Batched version of Inverter._format_weights: (B, N) complex spectra ->
    (w_re, w_im) rows, supporting the full reference weights vocabulary
    (unity/modulus/Orazem/proportional/prop_adj, scalars, shared or
    per-spectrum arrays; reference: inversion.py weight formatting)."""
    Z = np.asarray(Z)
    b, n = Z.shape
    if weights is None or (isinstance(weights, str) and weights == "unity"):
        w = np.ones((b, n)) * (1 + 1j)
    elif isinstance(weights, str):
        if weights == "modulus":
            w = (1 + 1j) / np.abs(Z)
        elif weights == "Orazem":
            w = (1 + 1j) / (np.abs(Z.real) + np.abs(Z.imag))
        elif weights == "proportional":
            w = 1 / np.abs(Z.real) + 1j / np.abs(Z.imag)
        elif weights == "prop_adj":
            zmod2 = np.real(Z * Z.conjugate())
            q25 = np.percentile(zmod2, 25, axis=1, keepdims=True)
            w = 1 / (np.abs(Z.real) + q25) + 1j / (np.abs(Z.imag) + q25)
        else:
            raise ValueError(
                f"Invalid weights argument {weights!r}. String options are "
                "'unity', 'modulus', 'Orazem', 'proportional', and 'prop_adj'")
    elif isinstance(weights, complex):
        w = np.full((b, n), weights)
    elif isinstance(weights, (int, float)):
        w = np.full((b, n), weights * (1 + 1j))
    else:
        w = np.asarray(weights)
        if w.ndim == 1:
            w = np.broadcast_to(w[None, :], (b, n))
        if w.shape != (b, n):
            raise ValueError(f"Weights array shape {w.shape} must be (N,) or "
                             f"(B, N) = {(b, n)}")
        if np.isrealobj(w):
            w = w * (1 + 1j)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


def ridge_fit_spectra_batch(frequencies, Z_batch, basis_freq=None,
                            epsilon=None, penalty: str = "integral",
                            hyper_lambda: bool = True,
                            hl_beta: float = 2.5, lambda_0: float = 1e-2,
                            reg_ord=2, nonneg: bool = True,
                            weights="modulus", max_iter: int = 20,
                            xtol: float = 1e-3, mesh=None,
                            basis: str = "gaussian", dtype=None,
                            cv_lambdas=None, hyper_weights: bool = False,
                            device=None) -> BatchFitResult:
    """Batched hyper-lambda (or ordinary, ``hyper_lambda=False``) ridge
    DRT fits of B spectra on one frequency grid: a series DRT with R_inf
    and inductance columns, the ``penalty`` 'integral' (M matrices) or
    'discrete' (L^T L), mixed over derivative orders by ``reg_ord`` (an
    order or three weights), the weights vocabulary of
    ``_format_weights_batch``, ``nonneg`` bounds. The A matrices come
    from the quadrature kernel in float64 on a CUDA device; the QPs run
    in ``dtype`` (float32 by default). ``diagnostics`` holds each
    spectrum's iteration count and convergence flag.

    Not ported: ``cv_lambdas`` and ``hyper_weights`` (ROADMAP Queue 1 item
    8) and ``mesh`` (item 12) raise."""
    if hyper_weights and hyper_lambda:
        raise ValueError("hyper_lambda and hyper_weights fits cannot be "
                         "combined; pass hyper_lambda=False")
    if hyper_weights or cv_lambdas is not None:
        raise NotImplementedError(
            "hyper_weights and cv_lambdas ridge fits are not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP Queue 1 "
                                  "item 12)")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    Z_batch = np.asarray(Z_batch)
    f_order = np.argsort(np.asarray(frequencies, float))[::-1]
    frequencies = np.asarray(frequencies, float)[f_order]
    Z_batch = Z_batch[:, f_order]
    b, n = Z_batch.shape
    if basis_freq is None:
        tau = get_tau_basis(frequencies)
    else:
        tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
    eps = default_epsilon(tau) if epsilon is None else float(epsilon)
    f_coll = 1.0 / (2 * np.pi * tau)
    kb = len(tau)
    k = kb + 2
    f64 = dict(dtype=torch.float64, device=dev)

    A_re = torch.zeros((n, k), **f64)
    A_re[:, 0] = 1.0
    A_re[:, 2:] = construct_A(frequencies, "real", tau=tau, basis=basis,
                              epsilon=eps, **f64)
    A_im = torch.zeros((n, k), **f64)
    A_im[:, 1] = torch.as_tensor(2 * np.pi * frequencies * 1e-4, **f64)
    A_im[:, 2:] = construct_A(frequencies, "imag", tau=tau, basis=basis,
                              epsilon=eps, **f64)
    L2_base, L_ops = [], []
    for order in (0, 1, 2):
        if penalty == "integral":
            M = torch.zeros((k, k), **f64)
            M[2:, 2:] = construct_M(f_coll, order=order, basis=basis,
                                    epsilon=eps, **f64)
            L2_base.append(M)
            L_ops.append(torch.zeros((kb, k), **f64))
        else:
            L = torch.cat([torch.zeros((kb, 2), **f64),
                           construct_L(f_coll, tau=tau, epsilon=eps,
                                       basis=basis, order=order, **f64)],
                          dim=1)
            L_ops.append(L)
            L2_base.append(L.T @ L)

    if isinstance(reg_ord, (int, np.integer)):
        frac = np.zeros(3)
        frac[reg_ord] = 1.0
    else:
        frac = np.asarray(reg_ord, float)

    z_scales = np.std(np.abs(Z_batch), axis=1) / np.sqrt(n / 81)
    Zs = Z_batch / z_scales[:, None]
    w_re, w_im = _format_weights_batch(Zs, weights)
    lb = np.zeros(k) if nonneg else np.concatenate([np.zeros(2),
                                                    np.full(kb, -10.0)])
    ub = np.full(k, np.inf)
    cfg = HyperLambdaConfig(part="both", penalty=penalty, n_fixed=2,
                            max_iter=max_iter)

    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.ascontiguousarray(a, float), device=dev)
        return a.to(dt)

    wr, wi = t(w_re), t(w_im)
    data = RidgeData(WA_re=wr[:, :, None] * t(A_re), WA_im=wi[:, :, None]
                     * t(A_im), WT_re=wr * t(Zs.real), WT_im=wi * t(Zs.imag),
                     L2_base=t(torch.stack(L2_base)),
                     L_ops=t(torch.stack(L_ops)),
                     L1_vec=torch.zeros(k, dtype=dt, device=dev),
                     reg_frac=t(frac), lb=t(lb), ub=t(ub))
    if hyper_lambda:
        res = run_hyper_lambda(cfg, data, torch.full((k,), 1e-6, dtype=dt,
                                                     device=dev),
                               torch.full((3,), float(hl_beta), dtype=dt,
                                          device=dev), lambda_0, xtol=xtol)
    else:
        res = run_ordinary_ridge("both", data, lambda_0)
    coefs = res.coef.cpu().numpy() * z_scales[:, None]
    diagnostics = {"n_iter": res.n_iter.cpu().numpy(),
                   "converged": res.converged.cpu().numpy()}
    return BatchFitResult(
        coef=coefs[:, 2:], r_inf=coefs[:, 0], inductance=coefs[:, 1] * 1e-4,
        gamma_lo=None, gamma_hi=None, z_scales=z_scales, tau=tau, epsilon=eps,
        diagnostics=diagnostics, basis=basis)


def evaluate_gamma(result: BatchFitResult, eval_tau, which: str = "coef"):
    """gamma(tau) curves for every spectrum of a batch result: 'coef'
    (posterior mean), 'lo'/'hi' (coefficient band edges), or a
    diagnostics key holding a coefficient array."""
    eval_tau = np.asarray(eval_tau, float)
    if which in ("coef", "lo", "hi"):
        coefs = {"coef": result.coef, "lo": result.gamma_lo,
                 "hi": result.gamma_hi}[which]
    else:
        coefs = result.diagnostics[which]
    y = np.log(eval_tau[:, None] / result.tau[None, :])
    return coefs @ _gaussian_rbf_np(y, result.epsilon).T


def predict_Z_batch(result: BatchFitResult, frequencies, device=None):
    """Predicted impedance of every spectrum of a batch fit at
    ``frequencies``: Z = R_inf + j w L + sum(series A @ x) + sum(parallel
    1 / (A @ x)) at the MAP point or posterior-mean coefficients, each A
    rebuilt from ``diagnostics['dist_geometry']`` (a single series DRT on
    the result's grid when absent) by ``construct_A`` in float64 (the
    quadrature kernel for a DRT on a CUDA device). At exactly the training
    grid of a sample-mode fit it returns the draws' mean prediction
    (``diagnostics['z_hat_mean']``), the reference's generated-quantities
    semantics, which differs from Z at the mean coefficients for parallel
    distributions. Returns a complex (B, N) array."""
    frequencies = np.asarray(frequencies, float)
    f_train = result.diagnostics.get("f_train")
    if f_train is not None and len(f_train) == len(frequencies):
        # match the requested grid against f_train up to reordering
        idx = np.argsort(f_train)[::-1][np.argsort(
            np.argsort(frequencies)[::-1])]
        if np.allclose(f_train[idx], frequencies, rtol=1e-10):
            zm = np.asarray(result.diagnostics["z_hat_mean"], float)
            n = len(f_train)
            return (zm[:, :n] + 1j * zm[:, n:])[:, idx]
    dev = resolve_device(device)
    geometry = result.diagnostics.get("dist_geometry") or (
        {"kernel": "DRT", "dist_type": "series", "symmetry": "planar",
         "bc": "transmissive", "ct": False, "k_ct": None,
         "basis": result.basis, "tau": result.tau,
         "epsilon": result.epsilon},)
    z = (np.asarray(result.r_inf, float)[:, None]
         + 1j * 2 * np.pi * frequencies[None, :]
         * np.asarray(result.inductance, float)[:, None])
    for i, g in enumerate(geometry):
        kw = dict(tau=g["tau"], epsilon=g["epsilon"], basis=g["basis"],
                  kernel=g["kernel"], dist_type=g["dist_type"],
                  symmetry=g["symmetry"], bc=g["bc"], ct=g["ct"],
                  k_ct=g["k_ct"], dtype=torch.float64, device=dev)
        A = (construct_A(frequencies, "real", **kw).cpu().numpy()
             + 1j * construct_A(frequencies, "imag", **kw).cpu().numpy())
        coef = result.coef if i == 0 else result.diagnostics[f"coef_{i}"]
        t = np.asarray(coef) @ A.T
        z = z + (1.0 / t if g["dist_type"] == "parallel" else t)
    return z
