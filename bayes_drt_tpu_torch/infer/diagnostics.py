"""Convergence diagnostics on the device (port of the jnp estimators of
bayes_drt_tpu/infer/diagnostics.py:81-245).

Every function takes draws with leading batch dimensions, (..., chains,
n, d), and treats parameters independently, so ``d_chunk`` blocking is
exact; it bounds the FFT and argsort workspace at the main path's size.
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
