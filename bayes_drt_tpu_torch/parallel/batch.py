"""Batched Bayesian inversion of many spectra on one frequency grid (port
of the sample/shmc path of bayes_drt_tpu/parallel/batch.py).

``fit_spectra_batch`` runs B spectra x C chains as one flat (B*C, D) chain
axis through the flat-chain SHMC sampler (infer/shmc_flat.py), whose
every draw is one launch of the hand-written trajectory kernel, then
summarizes each spectrum's posterior on the device. The A matrices come
from the hand-written quadrature kernel (ops/quad.py).

Not ported yet: MAP (mode='optimize'), the NUTS and ChEES samplers, the
escalation refit, warm starts, presets, ridge initialization, meshes and
models beyond the single series DRT.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._numerics import resolve_device, resolve_dtype
from ..infer.chees import SHMCConfig
from ..infer.diagnostics import ess_bulk_jnp, ess_jnp, rhat_rank_jnp
from ..infer.shmc_flat import (flat_shared_for, flat_spec_for,
                               sample_shmc_flat)
from ..models.build import build_posterior, z_scale_for
from ..models.posterior import (constrain, init_unconstrained,
                                predict_target, ravel, unravel)
from ..ops.matrices import (construct_A, construct_L, default_epsilon,
                            get_tau_basis)


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
    gamma bands and the posterior-predictive impedance."""

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
        preds = predict_target(cfg, dat, c)
        out["z_hat_mean"] = preds.mean(dim=1)
        out["z_hat_std"] = preds.std(dim=1, correction=0)
        return out

    return summarize


def _build_shared(frequencies, nonneg=False, dtype=None, ncp=False,
                  device=None):
    """Matrices at the common (descending) frequency grid for the single
    series DRT with the default basis, and the sampling posterior built
    from them. A is integrated in float64 by ops/quad.py (two kernel
    launches on a CUDA device)."""
    dev = resolve_device(device)
    frequencies = np.sort(np.asarray(frequencies, float))[::-1]
    tau = get_tau_basis(frequencies)
    eps = default_epsilon(tau)
    f_coll = 1.0 / (2 * np.pi * tau)
    kw = dict(tau=tau, epsilon=eps, dtype=torch.float64, device=dev)
    mats = {"A_re": construct_A(frequencies, "real", **kw),
            "A_im": construct_A(frequencies, "imag", **kw)}
    for o in (0, 1, 2):
        mats[f"L{o}"] = construct_L(f_coll, order=o, **kw)
    dists = {"DRT": {"kernel": "DRT", "dist_type": "series"}}
    z_dummy = np.ones(len(frequencies)) + 0j   # replaced per spectrum
    cfg, data = build_posterior(dists, {"DRT": mats}, frequencies, z_dummy,
                                mode="sample", nonneg=nonneg, dtype=dtype,
                                ncp=ncp, device=dev)
    return frequencies, tau, eps, cfg, data


def fit_spectra_batch(frequencies, Z_batch, mode: str = "sample",
                      nonneg: bool = False, chains: int = 4,
                      warmup: int = 500, samples: int = 500,
                      random_seed: int = 0, dtype=None, ncp: bool = False,
                      gamma_eval_tau=None, sampler: str = "shmc",
                      shmc_cfg=None, escalate: Optional[bool] = None,
                      timing: bool = False, device=None) -> BatchFitResult:
    """Fit B spectra sharing one frequency grid (single series DRT).

    Z_batch: complex (B, N). Every spectrum runs ``chains`` chains of the
    flat-chain SHMC sampler, all B*chains chains in one trajectory launch
    per draw. Runs on CUDA unless ``device`` says otherwise, float32
    unless ``dtype`` says otherwise; random numbers come from a
    torch.Generator seeded with ``random_seed``. Escalation is not ported,
    so ``escalate`` must be False (None, its default, raises as True
    does). ``timing`` records
    each trajectory launch with CUDA events (per-draw device times under
    ``diagnostics['traj_ms']``) and host-clock spans of setup, sampling and
    summary, each closed by a device synchronize
    (``diagnostics['phase_s']``).
    """
    if mode != "sample":
        raise NotImplementedError(
            "mode='optimize' (MAP) is not ported yet (ROADMAP Queue 1 "
            "item 9)")
    if sampler != "shmc":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet; the port runs the "
            "flat-chain SHMC sampler (ROADMAP Queue 1 item 7 adds NUTS)")
    # escalate=None means on for the fixed-trajectory SHMC sampler, as in
    # the JAX package; only an explicit False runs without it
    if escalate is None or escalate:
        raise NotImplementedError(
            "escalation (the NUTS refit of under-mixed spectra, on by "
            "default for sampler='shmc') is not ported yet (ROADMAP Queue 1 "
            "item 7); pass escalate=False")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    sh_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
    sh_cfg.validate()
    marks = []

    def mark():
        if timing:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

    mark()

    Z_batch = np.asarray(Z_batch)
    order = np.argsort(np.asarray(frequencies, float))[::-1]
    frequencies = np.asarray(frequencies, float)[order]
    Z_batch, b_real = _pad_pow2(Z_batch[:, order])
    b = Z_batch.shape[0]
    frequencies, tau, eps, cfg, data = _build_shared(
        frequencies, nonneg=nonneg, dtype=dt, ncp=ncp, device=dev)
    z_scales = z_scale_for({"DRT": {"dist_type": "series"}}, Z_batch)
    Zs = Z_batch / z_scales[:, None]
    targets = torch.as_tensor(np.concatenate([Zs.real, Zs.imag], axis=1),
                              device=dev).to(dt)

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

    spec = flat_spec_for(cfg, data)
    shared = flat_shared_for(cfg, data, dt)
    gen = torch.Generator(device=dev).manual_seed(int(random_seed))
    q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                       batch_shape=(b, chains)))
    q0 = q0.reshape(b * chains, spec.D).contiguous()
    tgt_rows = targets.repeat_interleave(chains, dim=0).contiguous()
    mark()
    draws, info = sample_shmc_flat(spec, shared, tgt_rows, q0, warmup,
                                   samples, sh_cfg, chains, generator=gen,
                                   time_traj=timing)
    mark()
    info["inv_mass"] = info["inv_mass"][:, None, :].expand(-1, chains, -1)

    summarize = _make_summarize(cfg, chains, samples)
    blocks = []
    for i in range(0, b_real, _SUMMARY_BLOCK):
        sl = slice(i, min(i + _SUMMARY_BLOCK, b_real))
        inf_b = {k: v[sl] for k, v in info.items() if k != "traj_ms"}
        blocks.append(summarize(data, draws[sl], inf_b, phi_mon, phi_eval))
    out = {k: torch.cat([blk[k] for blk in blocks]).cpu().numpy()
           for k in blocks[0]}
    mark()
    z_scales = z_scales[:b_real]

    scale0 = z_scales[:, None]
    diagnostics = {k: out[k] for k in out
                   if k not in ("coef", "coef_lo", "coef_hi", "r_inf",
                                "induc")}
    for k_ge in ("gamma_eval_mean", "gamma_eval_lo", "gamma_eval_hi"):
        if k_ge in diagnostics:
            diagnostics[k_ge] = diagnostics[k_ge] * scale0
    for k_z in ("z_hat_mean", "z_hat_std"):
        diagnostics[k_z] = diagnostics[k_z] * z_scales[:, None]
    if timing:
        diagnostics["traj_ms"] = np.asarray(info["traj_ms"])
        diagnostics["phase_s"] = dict(zip(("setup", "sample", "summary"),
                                          np.diff(marks).tolist()))
    return BatchFitResult(
        coef=out["coef"] * scale0, r_inf=out["r_inf"] * z_scales,
        inductance=out["induc"] * z_scales,
        gamma_lo=out["coef_lo"] * scale0, gamma_hi=out["coef_hi"] * scale0,
        z_scales=z_scales, tau=tau, epsilon=eps, diagnostics=diagnostics)


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
