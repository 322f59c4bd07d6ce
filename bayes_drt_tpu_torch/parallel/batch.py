"""Batched Bayesian inversion of many spectra on one frequency grid (port
of the sample path of bayes_drt_tpu/parallel/batch.py).

``fit_spectra_batch`` runs B spectra x C chains as one (B*C, D) chain axis
through NUTS (infer/nuts.py, the default) or the flat-chain SHMC sampler
(infer/shmc_flat.py, every draw one launch of the hand-written trajectory
kernel), summarizes each spectrum's posterior on the device, and by
default refits the spectra that fail the mixing gate with a ridge-seeded
NUTS run spliced into the result. ``ridge_fit_spectra_batch`` is the
batched hyper-lambda ridge (infer/ridge.py) that seeds it. The A matrices
come from the hand-written quadrature kernel (ops/quad.py).

Not ported yet: MAP (mode='optimize'), ChEES, warm starts, the pooled
preconditioner, cross-validated and hyper-weights ridge, meshes and models
beyond the single series DRT.
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
from ..infer.nuts import NUTSConfig, sample_nuts
from ..infer.ridge import (HyperLambdaConfig, RidgeData, run_hyper_lambda,
                           run_ordinary_ridge)
from ..infer.shmc_flat import (flat_shared_for, flat_spec_for,
                               flat_value_and_grad, sample_shmc_flat)
from ..models.build import build_posterior, z_scale_for
from ..models.posterior import (constrain, init_unconstrained,
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


def _ridge_init_values(frequencies, Z_batch, b_real, z_scales, K,
                       ridge_kw, dtype, device):
    """Per-spectrum ridge-seeded init values for a single series DRT: one
    batched hyper-lambda ridge pass over the real spectra, padded like the
    batch, in the scaled coordinates init_unconstrained expects (x, and
    R_inf and inductance before their x100 / induc_scale transforms)."""
    rdefaults = dict(penalty="integral", hyper_lambda=True, lambda_0=1.0,
                     hl_beta=5, weights="modulus")
    rdefaults.update(ridge_kw or {})
    rres = ridge_fit_spectra_batch(frequencies, Z_batch[:b_real],
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


def _per_spectrum(x, b, chains):
    """(T, b*chains, ...) per-draw rows -> (b, chains, T, ...)."""
    return x.reshape((x.shape[0], b, chains) + x.shape[2:]).movedim(0, 2)


def fit_spectra_batch(frequencies, Z_batch, mode: str = "sample",
                      nonneg: bool = False, chains: int = 4,
                      warmup: int = 500, samples: int = 500,
                      init_from_ridge: bool = False,
                      ridge_kw: Optional[dict] = None,
                      random_seed: int = 0, max_tree_depth: int = 10,
                      dtype=None, precondition: Optional[str] = None,
                      ncp: bool = False, unroll: int = 1,
                      flat_tree: bool = False, tree_scan: bool = False,
                      scan_unroll: int = 1, gamma_eval_tau=None,
                      z_scale=None, sampler: str = "nuts", shmc_cfg=None,
                      warm_start=None, quality: Optional[str] = None,
                      escalate: Optional[bool] = None,
                      escalate_gate: Optional[dict] = None,
                      escalate_kw: Optional[dict] = None,
                      timing: bool = False, device=None) -> BatchFitResult:
    """Fit B spectra sharing one frequency grid (single series DRT).

    Z_batch: complex (B, N). All B*chains chains run as one (B*chains, D)
    row axis. ``sampler='nuts'`` (the default) runs NUTS with
    ``max_tree_depth`` and a per-chain step size and diagonal metric;
    ``tree_scan`` runs every tree's static 2^max_tree_depth - 1 leaves,
    ``flat_tree`` and the default stop a tree once no chain is still
    building it (the same draws either way). ``unroll`` and
    ``scan_unroll`` tune the JAX package's compiled loops and have no
    effect here. ``sampler='shmc'`` runs the flat-chain SHMC sampler, one
    launch of the hand-written trajectory kernel per draw, with
    ``shmc_cfg``. Runs on CUDA unless ``device`` says otherwise, float32
    unless ``dtype`` says otherwise; random numbers come from a
    torch.Generator seeded with ``random_seed``.

    ``init_from_ridge`` (NUTS): every chain starts at the coordinates of a
    batched hyper-lambda ridge solution (``ridge_kw`` overrides its
    defaults), the other parameters Stan-random. ``z_scale`` overrides the
    data-derived per-spectrum scale.

    ``quality``: a named preset of QUALITY_PRESETS overriding the sampler
    choice and budget ('fast': the bench's SHMC configuration; 'strict':
    NUTS md8, 4x(1000+1000)).

    ``escalate``: refit spectra that fail the per-spectrum mixing gate
    (``escalation_mask``; ``escalate_gate`` overrides its thresholds) with
    NUTS max_depth=8, tree_scan, seeded from the ridge solution
    (``escalate_kw`` overrides the refit's arguments), and splice the refit
    into the result; ``diagnostics['escalated']`` records the mask. The
    default None is on for ``sampler='shmc'`` and for NUTS without
    ``init_from_ridge``.

    ``timing`` records host-clock spans closed by a device synchronize
    (``diagnostics['phase_s']``: setup, ridge when seeded, sample, summary),
    the trajectory kernel's per-draw device times (SHMC,
    ``diagnostics['traj_ms']``), each NUTS draw's seconds
    (``diagnostics['draw_s']``) and the escalation refit's seconds
    (``diagnostics['refit_s']``).
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
    if mode != "sample":
        raise NotImplementedError(
            "mode='optimize' (MAP) is not ported yet (ROADMAP Queue 1 "
            "item 9)")
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
    if init_from_ridge and sampler == "shmc":
        raise ValueError("init_from_ridge does not support the flat-chain "
                         "SHMC sampler; use sampler='nuts'")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    if sampler == "shmc":
        sh_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
        sh_cfg.validate()
    else:
        nuts_cfg = NUTSConfig(max_depth=max_tree_depth, unroll=unroll,
                              flat_tree=flat_tree, tree_scan=tree_scan,
                              scan_unroll=scan_unroll)
        nuts_cfg.validate()
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
    frequencies, tau, eps, cfg, data = _build_shared(
        frequencies, nonneg=nonneg, dtype=dt, ncp=ncp, device=dev)
    if z_scale is None:
        z_scales = z_scale_for({"DRT": {"dist_type": "series"}}, Z_batch)
    else:
        zs = np.broadcast_to(np.asarray(z_scale, float), (b_real,))
        z_scales = np.concatenate([zs, np.full(b - b_real, zs[-1])])
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
    tgt_rows = targets.repeat_interleave(chains, dim=0).contiguous()
    mark("setup")
    init_values = None
    if init_from_ridge:
        iv_x, iv_rinf, iv_induc = _ridge_init_values(
            frequencies, Z_batch, b_real, z_scales, spec.K, ridge_kw, dt,
            dev)
        init_values = {"x_0": iv_x[:, None, :], "Rinf_raw": iv_rinf[:, None],
                       "induc_raw": iv_induc[:, None]}
        mark("ridge")
    q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                       batch_shape=(b, chains),
                                       init_values=init_values))
    q0 = q0.reshape(b * chains, spec.D).contiguous()

    if sampler == "shmc":
        time_traj = timing and dev.type == "cuda"
        draws, info = sample_shmc_flat(spec, shared, tgt_rows, q0, warmup,
                                       samples, sh_cfg, chains, generator=gen,
                                       time_traj=time_traj)
        info["inv_mass"] = info["inv_mass"][:, None, :].expand(-1, chains, -1)
    else:
        def vg(q):
            return flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                       shared.scal, q, tgt_rows)

        draws, raw = sample_nuts(vg, q0, warmup, samples, nuts_cfg,
                                 generator=gen, time_draws=timing)
        draws = _per_spectrum(draws, b, chains)
        info = {k: _per_spectrum(raw[k], b, chains)
                for k in ("logp", "accept_prob", "diverging", "n_leapfrog",
                          "energy", "warmup_diverging")}
        info["step_size"] = raw["step_size"].reshape(b, chains)
        info["inv_mass"] = raw["inv_mass"].reshape(b, chains, spec.D)
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
        for k in ("traj_ms", "draw_s"):
            if k in info:
                diagnostics[k] = np.asarray(info[k])
        diagnostics["phase_s"] = phases
    result = BatchFitResult(
        coef=out["coef"] * scale0, r_inf=out["r_inf"] * z_scales,
        inductance=out["induc"] * z_scales,
        gamma_lo=out["coef_lo"] * scale0, gamma_hi=out["coef_hi"] * scale0,
        z_scales=z_scales, tau=tau, epsilon=eps, diagnostics=diagnostics)

    # ---- gate-triggered escalation: refit the under-mixed tail ----
    # default on for the fixed-trajectory sampler (the flat-chain sampler
    # stands in for the JAX package's default sample_shmc path) and for
    # NUTS unless the fit is already ridge-seeded
    if escalate is None:
        escalate = (warm_start is None
                    and (sampler == "shmc"
                         or (sampler == "nuts" and not init_from_ridge)))
    if escalate:
        gate_kw = dict(n_draws=chains * samples)
        gate_kw.update(escalate_gate or {})
        esc_mask = escalation_mask(diagnostics, b_real, **gate_kw)
        diagnostics["escalated"] = esc_mask
        if esc_mask.any():
            # the refit's chains start from a ridge solution: stuck chains
            # are an initialization pathology, not a trajectory-length one
            esc_kw = dict(sampler="nuts", max_tree_depth=8, tree_scan=True,
                          scan_unroll=2, ncp=ncp, init_from_ridge=True)
            esc_kw.update(escalate_kw or {})
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
                nonneg=nonneg, chains=chains, warmup=warmup,
                samples=samples, random_seed=random_seed + 1,
                gamma_eval_tau=gamma_eval_tau, z_scale=sub_z_scale,
                dtype=dtype, escalate=False, timing=timing, device=dev,
                **esc_kw)
            if timing:
                diagnostics["refit_s"] = time.perf_counter() - t_refit
            result = _splice_results(result, sub, esc_mask)
    return result


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
