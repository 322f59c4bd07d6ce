"""Simulation-based calibration (SBC) of the sampling stack (port of
bayes_drt_tpu/sbc.py).

Talts et al. 2018: draw (theta, y) pairs from the model's joint prior
predictive, fit each y with the sampler under test, and rank the true theta
among the posterior draws. If the sampler targets the right posterior, every
rank statistic is uniform, which certifies the whole tower (posterior,
sampler, adaptation, precision) at once.

The Series model's soft prior ``q ~ normal(0, ups)`` with
``q_j = sqrt(sum_k ds_k (L_k x)_j^2)`` is an unnormalized Gaussian in x.
With

    M(ups, ds) = sum_k ds_k L_k^T diag(ups^-2) L_k                   (K, K)

the joint prior factorizes exactly as

    p(ups_raw, ds)  propto  IG(ups_raw; a, b) * IG(ds; 5, 5)
                            * N(dups(ups); 0, 1)
                            * prod_j ups_j^-1 * |M|^{-1/2}
    x | ups, ds  ~  N(0, M^{-1})

with the other scalars independent half-normals. So:

1. ``sample_prior_marginal`` draws the (ups_raw, ds) marginal by NUTS, one
   chain a draw, all chains as the rows of one ``sample_nuts`` call, one
   retained draw each (independent across chains by construction; their
   cross-chain rank-Rhat is the certificate).
2. ``generate_datasets`` samples x by a Cholesky solve, the scalars from
   their half-normals (and sigma_out from its exact prior with outliers),
   and y through the model's own ``predict_target`` / ``sigma_tot``. Its
   draws come from numpy and feed ``datasets_from_draws``, the
   deterministic core, so that any stream can be replayed through it.
3. The caller fits the batch with the production path
   (``fit_spectra_batch(..., z_scale=1, monitor_thin=...)``) and ranks the
   truths among ``monitor_draws`` (``sbc_ranks``, ``rank_uniformity``,
   ``ecdf_envelope_violations``; ``monitor_ess`` picks the thinning).
"""

from __future__ import annotations

import numpy as np
import torch

from .infer.diagnostics import ess_bulk, rhat_rank
from .infer.nuts import NUTSConfig, sample_nuts
from .models.posterior import (MONITOR_SCALARS, outlier_monitor_indices,
                               predict_target, sigma_tot)
from .models.priors import inv_gamma_lpdf, std_normal_lpdf


def _precision(data, ups_raw, ds):
    """M(ups, ds) (..., K, K) of rows ups_raw (..., K), ds (..., 3)."""
    L = data.L[0]                          # (3, K, K) mode-scaled roots
    w = 1.0 / (0.15 * ups_raw) ** 2
    m = 0.0
    for i in range(3):                     # (L_i^T * w) @ L_i
        m = m + ds[..., i, None, None] * (
            (L[i].transpose(-1, -2) * w[..., None, :]) @ L[i])
    return m


def _marginal_logdensity(cfg, data):
    """Log density of the (ups_raw, ds) prior marginal on the
    unconstrained rows u = [log ups_raw (K,), log ds (3,)] (R, K + 3), x
    integrated out exactly; returns (logp, K), logp(u) of shape (R,).

    The Cholesky runs through ``torch.linalg.cholesky_ex``, which neither
    checks nor syncs (CUDA graphs capture it); a row whose M is not
    positive definite gets a NaN log density, as the JAX package's Cholesky
    gives, and its sampler treats it as divergent."""
    k = data.L[0].shape[-1]

    def logp(u):
        ups_raw = torch.exp(u[..., :k])
        ds = torch.exp(u[..., k:])
        ups = 0.15 * ups_raw
        lp = inv_gamma_lpdf(ups_raw, data.ups_alpha, data.ups_beta)
        lp = lp + inv_gamma_lpdf(ds, 5.0, 5.0)
        lp = lp + u.sum(dim=-1)            # log|J| of the exp transforms
        mid = ups[..., 1:-1]
        dups = 0.5 * (mid - 0.5 * (ups[..., :-2] + ups[..., 2:])) / mid
        lp = lp + std_normal_lpdf(dups)
        chol, info = torch.linalg.cholesky_ex(_precision(data, ups_raw, ds))
        # -sum(log ups) from the normal_lpdf(q, 0, ups) normalization,
        # -1/2 logdet M from integrating the Gaussian in x
        lp = lp - torch.log(ups).sum(dim=-1)
        lp = lp - torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return torch.where(info == 0, lp, torch.full_like(lp, float("nan")))

    return logp, k


def marginal_value_and_grad(logp):
    """(value (R,), gradient (R, K + 3)) of the marginal by autograd, with
    no host synchronization (the NUTS trees capture it as CUDA graphs)."""
    def vg(u):
        with torch.enable_grad():
            x = u.detach().requires_grad_(True)
            lp = logp(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g
    return vg


def sample_prior_marginal(cfg, data, n_draws, seed=0, warmup=600,
                          max_tree_depth=7, chunk=None):
    """n_draws independent draws of (ups_raw, ds): one NUTS chain a draw
    (``max_depth=max_tree_depth``; each tree stops where no row is still
    building it, which gives the draws of the JAX package's static
    ``tree_scan`` form), warmup + 2 draws each, the last retained. Returns (ups_raw (n, K), ds (n, 3),
    diagnostics) with the divergence rate and, from 32 draws up, the
    cross-chain rank-Rhat and bulk ESS of the retained set folded into 8
    pseudo-chains (the prior-exactness certificate).

    All chains are the rows of one ``sample_nuts`` call on ``data``'s
    device (each leapfrog a batched (R, K, K) Cholesky); ``chunk`` caps
    the rows of a call where the device's memory needs it. Each chain
    starts at a constant ups profile at the prior's mode, jittered by one
    log-factor ~ N(0, 0.5^2), and ds ~ Gamma(5, 1/5), from numpy's
    generator seeded with ``seed`` (the sampler's own generator is seeded
    with ``seed`` too)."""
    logp, k = _marginal_logdensity(cfg, data)
    vg = marginal_value_and_grad(logp)
    cfg_n = NUTSConfig(max_depth=max_tree_depth)
    dt, dev = data.L[0].dtype, data.L[0].device
    rng = np.random.default_rng(seed)
    # a flat ups profile starts at the dups mode: iid IG draws start far
    # outside the smoothness prior's typical set
    mode_ups = float(data.ups_beta) / (float(data.ups_alpha) + 1.0)
    jit_u = 0.5 * rng.standard_normal(n_draws)
    g_ds = rng.standard_gamma(5.0, (n_draws, 3)) / 5.0
    u0 = np.concatenate([np.log(mode_ups) + jit_u[:, None] * np.ones(k),
                         np.log(g_ds)], axis=1)
    u0 = torch.as_tensor(u0, dtype=dt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    step = n_draws if chunk is None else int(chunk)
    us, div = [], []
    for lo in range(0, n_draws, step):
        draws, info = sample_nuts(vg, u0[lo:lo + step], warmup=warmup,
                                  samples=2, cfg=cfg_n, generator=gen)
        us.append(draws[-1].cpu().numpy().astype(np.float64))
        div.append(info["diverging"].to(torch.float64).mean(0).cpu().numpy())
    us = np.concatenate(us, axis=0)
    diag = {"divergence_rate": float(np.mean(np.concatenate(div)))}
    m = (n_draws // 8) * 8
    if m // 8 >= 4:
        pseudo = us[:m].reshape(8, m // 8, us.shape[-1])
        diag["rank_rhat_max"] = float(np.max(rhat_rank(pseudo)))
        diag["ess_bulk_min"] = float(np.min(ess_bulk(pseudo)))
    return np.exp(us[:, :k]), np.exp(us[:, k:]), diag


def datasets_from_draws(cfg, data, ups_raw, ds, gamma_eval_phi, xi, hn, eps,
                        so_exp=None, so_gamma=None):
    """The deterministic core of ``generate_datasets``: datasets from
    given standard draws, on ``data``'s device and dtype.

    ups_raw (n, K), ds (n, 3); gamma_eval_phi (E, K); xi (n, K) and eps
    (n, 2N) standard normals, hn (n, 6) standard normals (their absolute
    values are the half-normal scalars); with ``cfg.outliers`` so_exp (n, N)
    standard exponentials and so_gamma (n, N) Gamma(sigma_out_alpha, 1)
    draws. x_raw = chol(M)^{-T} xi, the scalars in the model's constrain()
    scaling, y = pred + sigma_tot * eps. Returns (Z complex (n, N) numpy,
    truths (n, 6 + E [+ 3]) numpy in the model's scaled space)."""
    dt, dev = data.L[0].dtype, data.L[0].device

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dt, device=dev)

    ups_raw, ds, phi = t(ups_raw), t(ds), t(gamma_eval_phi)
    n = data.freq.shape[-1]
    chol = torch.linalg.cholesky(_precision(data, ups_raw, ds))
    x_raw = torch.linalg.solve_triangular(
        chol.transpose(-1, -2), t(xi)[..., None], upper=True)[..., 0]
    hn = torch.abs(t(hn))
    c = {"x_0": x_raw * data.x_scales[0],
         "Rinf": 100.0 * hn[:, 0],
         "induc": hn[:, 1] * data.induc_scale,
         "sigma_res": 0.05 * hn[:, 2],
         "alpha_prop": 0.05 * hn[:, 3],
         "alpha_re": 0.05 * hn[:, 4],
         "alpha_im": 0.05 * hn[:, 5]}
    cols = [torch.stack([c[s] for s in MONITOR_SCALARS], dim=-1),
            c["x_0"] @ phi.T]
    if cfg.outliers:
        so_raw = t(so_exp) / data.sigma_out_lambda
        so_scale = data.sigma_out_beta / t(so_gamma)
        c["sigma_out"] = so_raw * so_scale * 0.05
        cols.append(c["sigma_out"][:, list(outlier_monitor_indices(n))])
    pred = predict_target(cfg, data, c)
    y = pred + sigma_tot(cfg, data, c, pred) * t(eps)
    ys = y.cpu().numpy()
    return (ys[:, :n] + 1j * ys[:, n:],
            torch.cat(cols, dim=-1).cpu().numpy())


def generate_datasets(cfg, data, ups_raw, ds, gamma_eval_phi, seed=0):
    """Exact prior-predictive datasets given marginal draws: Z_batch
    complex (n, N) and truths (n, 6 + E [+ 3]) in the model's scaled space
    (fit with z_scale=1 to compare). The standard draws come from numpy's
    generator seeded with ``seed`` and run through
    ``datasets_from_draws``; with ``cfg.outliers`` sigma_out comes from
    its exact prior (Exponential(lambda) x InvGamma(alpha, beta) x 0.05)
    and the truths gain it at ``outlier_monitor_indices``, the columns
    the batch summarizer's monitor_draws add."""
    n_sets, k = np.shape(ups_raw)
    n = data.freq.shape[-1]
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((n_sets, k))
    hn = rng.standard_normal((n_sets, 6))
    eps = rng.standard_normal((n_sets, 2 * n))
    so_exp = so_gamma = None
    if cfg.outliers:
        so_exp = rng.standard_exponential((n_sets, n))
        so_gamma = rng.standard_gamma(float(data.sigma_out_alpha),
                                      (n_sets, n))
    return datasets_from_draws(cfg, data, ups_raw, ds, gamma_eval_phi, xi,
                               hn, eps, so_exp, so_gamma)


def monitor_ess(monitor_draws, chains):
    """Per-monitor bulk ESS of stored (possibly unthinned) monitor draws.

    monitor_draws: (n_sets, chains*per_chain, n_mon), chain-major (the
    layout the batch summarizer writes). Returns (n_sets, n_mon) ESS
    estimates via FFT autocovariance with Geyer's initial-positive-sequence
    truncation, chains pooled within each dataset. Used to choose the SBC
    monitor thinning from measurement."""
    md = np.asarray(monitor_draws, np.float64)
    n_sets, L, n_mon = md.shape
    s = L // chains
    x = md.reshape(n_sets, chains, s, n_mon)
    xc = x - x.mean(axis=2, keepdims=True)
    nfft = 1
    while nfft < 2 * s:
        nfft *= 2
    f = np.fft.rfft(xc, n=nfft, axis=2)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=2)[:, :, :s].real / s
    # chains pooled within dataset; guard zero-variance monitors
    rho = acov.mean(axis=1) / np.maximum(acov[:, :, :1].mean(axis=1), 1e-300)
    ess = np.empty((n_sets, n_mon))
    for i in range(n_sets):
        for j in range(n_mon):
            r = rho[i, :, j]
            # Geyer: sum consecutive lag pairs while positive
            m = (s - 1) // 2 * 2
            pair = (r[1:1 + m].reshape(-1, 2).sum(axis=1)
                    if m >= 2 else np.empty(0))
            k = 0
            while k < len(pair) and pair[k] > 0:
                k += 1
            tau = 1.0 + 2.0 * r[1:1 + 2 * k].sum() if k else 1.0
            ess[i, j] = chains * s / max(tau, 1.0)
    return ess


def sbc_ranks(truths, monitor_draws):
    """Rank of each true value among its thinned posterior draws.
    truths: (n_sets, n_mon); monitor_draws: (n_sets, L, n_mon).
    Returns integer ranks in {0..L}, shape (n_sets, n_mon)."""
    return np.sum(np.asarray(monitor_draws) < truths[:, None, :], axis=1)


def rank_uniformity(ranks, n_levels, n_bins=10):
    """Chi-squared rank-uniformity test per monitor (Talts et al. 2018)
    with the exact expected count of each bin (equal-width bins over the
    discrete support {0..n_levels} hold unequal numbers of support
    points). ranks: (n_sets, n_mon). Returns (p_values (n_mon,),
    chi2 (n_mon,))."""
    from scipy.stats import chi2 as chi2_dist

    ranks = np.asarray(ranks)
    n_sets, n_mon = ranks.shape
    edges = np.linspace(0, n_levels + 1, n_bins + 1)
    support_counts, _ = np.histogram(np.arange(n_levels + 1), bins=edges)
    expected = n_sets * support_counts / (n_levels + 1)
    stats = np.empty(n_mon)
    for j in range(n_mon):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        stats[j] = np.sum((counts - expected) ** 2 / expected)
    return chi2_dist.sf(stats, n_bins - 1), stats


def ecdf_envelope_violations(ranks, n_levels, alpha=0.05):
    """Per monitor, whether its rank ECDF leaves a pointwise
    (Dvoretzky-Kiefer-Wolfowitz) confidence band, a plot-free stand-in for
    the ECDF-envelope plots of Sailynoja et al. 2022."""
    ranks = np.asarray(ranks)
    n_sets, n_mon = ranks.shape
    eps = np.sqrt(np.log(2.0 / alpha) / (2 * n_sets))
    grid = np.arange(n_levels + 1)
    viol = np.zeros(n_mon, dtype=bool)
    for j in range(n_mon):
        ecdf = np.searchsorted(np.sort(ranks[:, j]), grid,
                               side="right") / n_sets
        ideal = (grid + 1) / (n_levels + 1)
        viol[j] = np.any(np.abs(ecdf - ideal) > eps + 1.0 / (n_levels + 1))
    return viol
