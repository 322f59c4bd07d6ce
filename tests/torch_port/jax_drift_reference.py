"""The JAX package's drift starts, for the port's parity tests: the inits
``drift_fit_spectra_batch`` and ``Inverter.drift_map_fit`` draw inside
their programs (jax.random keys; the ridge seed), rebuilt here by the
same calls, and replacements for the port's ``init_drift_params`` that
hand them to the port as torch rows. Drift basins are multimodal and
L-BFGS amplifies last-bit differences, so parity runs from these
starts."""

import jax
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.models.drift import init_drift_params as jax_init
from bayes_drt_tpu.parallel.batch import _pad_pow2, ridge_fit_spectra_batch


def _flat(p):
    return np.asarray(ravel_pytree(p)[0])


def fleet_starts(cfg, data, freq, Z_batch, tau, random_seed, n_restarts,
                 init_from_ridge=True, nonneg=False):
    """(seeded rows (b, D), restart rows (b, n_restarts, D)) of the JAX
    package's drift_fit_spectra_batch on the padded batch, a series DRT:
    its batched ridge seed and its per-cell keys."""
    Zp, _ = _pad_pow2(np.asarray(Z_batch))
    b = Zp.shape[0]
    zs = np.std(np.abs(Zp), axis=1) / np.sqrt(Zp.shape[1] / 81)
    if init_from_ridge:
        rr = ridge_fit_spectra_batch(
            freq, Zp, basis_freq=1.0 / (2 * np.pi * tau), penalty="integral",
            hyper_lambda=True, lambda_0=1.0, hl_beta=5.0, weights="modulus")
        x_r = rr.coef / zs[:, None]
        iv_x = np.log(np.clip(x_r, 1e-10, None)) if nonneg else x_r
        iv_rinf = np.log(np.clip(rr.r_inf / zs, 1e-6, None) / 100.0)
        iv_induc = np.log(np.clip(rr.inductance / zs, 1e-10, None))
    else:
        iv_x = np.zeros((b, len(tau)))
        iv_rinf = np.full(b, np.log(1e-2))
        iv_induc = np.full(b, np.log(1e-10))
    seeded, rand = [], []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(random_seed),
                                             b)):
        k_ridge, k_rand = jax.random.split(key)
        iv = {"Rinf0_raw": iv_rinf[i], "induc_raw": iv_induc[i],
              "dRinf_raw": 0.0, "x0": iv_x[i], "x1": iv_x[i],
              "dx": np.full_like(iv_x[i], 1e-3),
              "x2": np.full_like(iv_x[i], 1e-3)}
        seeded.append(_flat(jax_init(cfg, data, k_ridge, init_values=iv)))
        rand.append([_flat(jax_init(cfg, data, rk))
                     for rk in jax.random.split(k_rand, n_restarts)])
    seeded = np.array(seeded)
    return seeded, np.array(rand).reshape(b, n_restarts, seeded.shape[1])


def inverter_starts(cfg, data, random_seed, n_restarts, iv=None):
    """(seeded row (D,), restart rows (n_restarts, D)) of the JAX package's
    Inverter.drift_map_fit: restarts from split(key, n_restarts), the
    seeded candidate from the key itself with the ridge init values."""
    key = jax.random.PRNGKey(random_seed)
    rand = np.array([_flat(jax_init(cfg, data, k))
                     for k in jax.random.split(key, n_restarts)])
    return _flat(jax_init(cfg, data, key, init_values=iv)), rand


def port_init_from(seeded, rand, seen=None):
    """A replacement for the port's init_drift_params handing out the JAX
    rows: the seeded rows for a call with one batch axis, the restarts for
    one with two; ``seen`` collects the init_values the port passed to
    the seeded call."""
    from bayes_drt_tpu_torch.models.drift import unravel_drift

    def init(cfg, data, generator, batch_shape=(), init_values=None):
        rows = seeded if len(batch_shape) == 1 else rand
        if len(batch_shape) == 1 and seen is not None:
            seen.append(init_values)
        q = torch.as_tensor(np.asarray(rows), dtype=data.freq.dtype,
                            device=data.freq.device)
        q = q.reshape(tuple(batch_shape) + (q.shape[-1],))
        return {k: v.clone() for k, v in unravel_drift(cfg, q).items()}

    return init
