"""Convergence diagnostics (port of bayes_drt_tpu/infer/diagnostics.py).

The ``*_jnp`` estimators run on the device: they take draws with leading
batch dimensions, (..., chains, n, d), and treat parameters
independently, so ``d_chunk`` blocking is exact; it bounds the FFT and
argsort workspace at the main path's size. The host estimators below
them (``split_chains`` to ``summary``) are numpy copies of the JAX
package's, for one fit's draws (chains, n, d), as the Inverter reports
them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def ess_jnp(draws):
    """Bulk ESS: split chains, FFT autocovariance, Geyer initial monotone
    positive sequence as a masked prefix. (..., c, n, d) -> (..., d)."""
    x = draws
    c0, n0 = x.shape[-3], x.shape[-2]
    half = n0 // 2
    x = torch.cat([x[..., :, :half, :], x[..., :, half:2 * half, :]], dim=-3)
    c, n = 2 * c0, half
    if n < 4:
        return torch.full(x.shape[:-3] + x.shape[-1:], float(c * n),
                          dtype=x.dtype, device=x.device)

    xc = x - x.mean(dim=-2, keepdim=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = torch.fft.rfft(xc, n=m, dim=-2)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-2)[..., :n, :] / n

    chain_var = acov[..., 0, :]                              # (..., c, d)
    mean_var = chain_var.mean(dim=-2) * n / (n - 1.0)
    var_plus = (mean_var * (n - 1.0) / n
                + x.mean(dim=-2).var(dim=-2, correction=1))
    var_plus = torch.where(var_plus > 0, var_plus,
                           torch.ones_like(var_plus))

    rho = 1.0 - (mean_var[..., None, :] - acov.mean(dim=-3)) \
        / var_plus[..., None, :]                             # (..., n, d)
    rho[..., 0, :] = 1.0

    n_pairs = n // 2
    pair = rho[..., 0:2 * n_pairs:2, :] + rho[..., 1:2 * n_pairs:2, :]
    kept = torch.cumprod((pair >= 0).to(rho.dtype), dim=-2)
    mono = torch.cummin(torch.where(kept > 0, pair,
                                    torch.full_like(pair, math.inf)),
                        dim=-2).values
    tau = -1.0 + 2.0 * torch.sum(torch.where(kept > 0, mono,
                                             torch.zeros_like(mono)), dim=-2)
    tau = torch.clamp(tau, min=1.0 / np.log10(c * n + 10.0))
    return c * n / tau


def _rank_normalize_jnp(x):
    """Rank-normal transform with ordinal ranks (double argsort), pooled
    over chains and draws. (..., c, n, d) -> (..., c, n, d). The argsort
    is stable, as jnp's is: ties (a repeated draw, or the two middle
    draws' equal distances from an even count's median in the folded
    Rhat) rank in draw order. The second argsort of the double argsort
    inverts a permutation, done here as a scatter."""
    c, n, d = x.shape[-3:]
    flat = x.reshape(x.shape[:-3] + (c * n, d))
    order = torch.argsort(flat, dim=-2, stable=True)
    pos = torch.arange(1, c * n + 1, device=x.device)[:, None]
    ranks = torch.empty_like(order).scatter_(-2, order,
                                             pos.expand_as(order))
    z = torch.special.ndtri((ranks.to(x.dtype) - 0.375) / (c * n + 0.25))
    return z.reshape(x.shape)


def _split_rhat_jnp(x):
    """Plain split-Rhat. (..., c, n, d) -> (..., d)."""
    half = x.shape[-2] // 2
    xs = torch.cat([x[..., :, :half, :], x[..., :, half:2 * half, :]],
                   dim=-3)
    n = half
    cm = xs.mean(dim=-2)
    w = xs.var(dim=-2, correction=1).mean(dim=-2)
    b = n * cm.var(dim=-2, correction=1)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.clamp(w, min=torch.finfo(x.dtype).tiny))


def _median_pooled(x):
    """Median over pooled chains and draws, averaging the two middle
    values for an even count. (..., c, n, d) -> (..., 1, 1, d)."""
    c, n, d = x.shape[-3:]
    s = torch.sort(x.reshape(x.shape[:-3] + (c * n, d)), dim=-2).values
    m = c * n
    med = 0.5 * (s[..., (m - 1) // 2, :] + s[..., m // 2, :])
    return med[..., None, None, :]


def _map_param_chunks(fn, draws, d_chunk):
    """Apply a per-parameter diagnostic sequentially over parameter blocks
    of at most ``d_chunk`` (exact: parameters are independent)."""
    d = draws.shape[-1]
    return torch.cat([fn(draws[..., i:i + d_chunk])
                      for i in range(0, d, d_chunk)], dim=-1)


def rhat_rank_jnp(draws, d_chunk=None):
    """Rank-normalized split-Rhat (Vehtari et al. 2021): the max of the
    bulk and the folded (tail) split-Rhat. (..., c, n, d) -> (..., d)."""
    def _all(x):
        z = _rank_normalize_jnp(x)
        zf = _rank_normalize_jnp(torch.abs(x - _median_pooled(x)))
        return torch.maximum(_split_rhat_jnp(z), _split_rhat_jnp(zf))

    if d_chunk is None or d_chunk >= draws.shape[-1]:
        return _all(draws)
    return _map_param_chunks(_all, draws, d_chunk)


def ess_bulk_jnp(draws, d_chunk=None):
    """Bulk ESS on rank-normalized draws. (..., c, n, d) -> (..., d)."""
    def _all(x):
        return ess_jnp(_rank_normalize_jnp(x))

    if d_chunk is None or d_chunk >= draws.shape[-1]:
        return _all(draws)
    return _map_param_chunks(_all, draws, d_chunk)


# ---- host estimators (numpy) ----

def split_chains(draws):
    """(chains, draws, ...) -> (2*chains, draws//2, ...)"""
    draws = np.asarray(draws)
    c, n = draws.shape[:2]
    half = n // 2
    return np.concatenate([draws[:, :half], draws[:, half:2 * half]], axis=0)


def rhat(draws) -> np.ndarray:
    """Split-Rhat (Gelman et al.). draws: (chains, n, dim) -> (dim,)."""
    x = split_chains(draws)
    c, n = x.shape[:2]
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    w = chain_var.mean(axis=0)
    b = n * chain_mean.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return np.sqrt(var_plus / np.where(w > 0, w, 1.0))


def _autocov_fft(x):
    """Per-chain autocovariance via FFT. x: (c, n, d)."""
    c, n, d = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=1)[:, :n].real
    return acov / n


def ess(draws) -> np.ndarray:
    """Bulk effective sample size. draws: (chains, n, dim) -> (dim,)."""
    x = split_chains(np.asarray(draws, dtype=float))
    c, n, d = x.shape
    if n < 4:
        return np.full(d, float(c * n))
    acov = _autocov_fft(x)                      # (c, n, d)
    chain_var = acov[:, 0]                      # biased var (ddof=0)
    mean_var = chain_var.mean(axis=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n + x.mean(axis=1).var(axis=0, ddof=1)
    var_plus = np.where(var_plus > 0, var_plus, 1.0)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus   # (n, d)
    rho[0] = 1.0

    out = np.empty(d)
    for j in range(d):
        # Geyer initial monotone positive sequence: pair (rho_0 + rho_1),
        # (rho_2 + rho_3), ... — positivity/monotonicity hold only for this
        # even-odd pairing
        t = 0
        pair_sums = []
        while t + 1 < n:
            s = rho[t, j] + rho[t + 1, j]
            if s < 0:
                break
            pair_sums.append(s)
            t += 2
        # enforce monotone decrease
        for i in range(1, len(pair_sums)):
            pair_sums[i] = min(pair_sums[i], pair_sums[i - 1])
        tau = -1.0 + 2.0 * sum(pair_sums)
        tau = max(tau, 1.0 / np.log10(c * n + 10.0))
        out[j] = c * n / tau
    return out


def _rank_normalize(x):
    """Fractional-rank inverse-normal transform (Vehtari et al. 2021 eq. 14):
    z = Phi^-1((r - 3/8)/(S + 1/4)) with average ranks for ties, pooled over
    all chains and draws. x: (c, n, d) -> (c, n, d)."""
    from scipy.special import ndtri
    from scipy.stats import rankdata
    c, n, d = x.shape
    r = rankdata(x.reshape(c * n, d), axis=0, method="average")
    return ndtri((r - 0.375) / (c * n + 0.25)).reshape(c, n, d)


def rhat_rank(draws) -> np.ndarray:
    """Rank-normalized split-Rhat (Vehtari et al. 2021): the max of split-Rhat
    on rank-normalized draws (bulk) and on rank-normalized folded draws
    |x - median| (tails). This is what modern Stan/arviz report; the plain
    :func:`rhat` is kept for continuity. draws: (chains, n, dim) -> (dim,)."""
    x = np.asarray(draws, dtype=float)
    z = _rank_normalize(x)
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[-1]), axis=0))
    zf = _rank_normalize(folded)
    return np.maximum(rhat(z), rhat(zf))


def ess_bulk(draws) -> np.ndarray:
    """Bulk ESS on rank-normalized draws (Vehtari et al. 2021).
    draws: (chains, n, dim) -> (dim,)."""
    return ess(_rank_normalize(np.asarray(draws, dtype=float)))


def ess_tail(draws) -> np.ndarray:
    """Tail ESS (Vehtari et al. 2021): the minimum of the ESS of the 5% and
    95% quantile indicator functions. draws: (chains, n, dim) -> (dim,)."""
    x = np.asarray(draws, dtype=float)
    flat = x.reshape(-1, x.shape[-1])
    out = None
    for q in (0.05, 0.95):
        ind = (x <= np.quantile(flat, q, axis=0)).astype(float)
        e = ess(ind)
        out = e if out is None else np.minimum(out, e)
    return out


def e_bfmi(energy) -> float:
    """Energy Bayesian fraction of missing information (Betancourt 2016):
    Var(dE)/Var(E) per chain, averaged. Values < ~0.3 flag poor energy-set
    exploration. energy: (chains, n) or (n,)."""
    e = np.atleast_2d(np.asarray(energy, dtype=float))
    num = np.mean(np.diff(e, axis=1) ** 2, axis=1)
    den = np.var(e, axis=1)
    return float(np.mean(num / np.where(den > 0, den, 1.0)))


def summary(draws) -> dict:
    """Per-parameter posterior summary. draws: (chains, n, dim)."""
    x = np.asarray(draws)
    flat = x.reshape(-1, x.shape[-1])
    return {
        "mean": flat.mean(axis=0),
        "sd": flat.std(axis=0, ddof=1),
        "q2.5": np.percentile(flat, 2.5, axis=0),
        "q97.5": np.percentile(flat, 97.5, axis=0),
        "rhat": rhat(x),
        "ess": ess(x),
        "rhat_rank": rhat_rank(x),
        "ess_bulk": ess_bulk(x),
        "ess_tail": ess_tail(x),
    }
