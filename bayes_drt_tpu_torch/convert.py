"""Carry state across from the JAX package as numpy arrays.

The two packages share the flat parameter layout and the posterior's
fields, so a caller holding the JAX package's ``PosteriorConfig`` /
``PosteriorData`` / ``FlatShared`` and sampler state can hand them to the
port unchanged: this module only converts arrays (anything ``np.asarray``
accepts) to tensors. So do a drift model's ``DriftConfig`` /
``DriftData`` and its parameter dicts, which become the port's flat rows
and back. An Inverter's saved fit state crosses as numpy
(``inverter_state_from_numpy``). It imports nothing of the JAX package;
the configuration is read by attribute.
"""

from __future__ import annotations

import numpy as np
import torch

from ._numerics import resolve_device, resolve_dtype
from .infer.shmc_flat import FlatShared, make_flat_shared
from .models.drift import (DriftConfig, DriftData, drift_param_shapes,
                           ravel_drift, unravel_drift)
from .models.posterior import DistConfig, PosteriorConfig, PosteriorData


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a, dtype=np.float64),
                           device=device).to(dtype)


def posterior_from_numpy(cfg, data, dtype=None, device=None):
    """(PosteriorConfig, PosteriorData) of the port from the JAX package's
    config and data (arrays as numpy or anything convertible)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    dists = tuple(DistConfig(name=d.name, dist_type=d.dist_type,
                             kernel=d.kernel, K=int(d.K)) for d in cfg.dists)
    pcfg = PosteriorConfig(dists=dists, nonneg=bool(cfg.nonneg),
                           outliers=bool(cfg.outliers), fitY=bool(cfg.fitY),
                           part=cfg.part, ncp=bool(cfg.ncp), sa=bool(cfg.sa))

    def t(a):
        return _tensor(a, dt, dev)

    pdata = PosteriorData(
        A=tuple(t(a) for a in data.A), L=tuple(t(a) for a in data.L),
        target=t(data.target), freq=t(data.freq),
        sigma_min=t(data.sigma_min), ups_alpha=t(data.ups_alpha),
        ups_beta=t(data.ups_beta), induc_scale=t(data.induc_scale),
        x_sum_invscale=t(data.x_sum_invscale),
        x_scales=tuple(t(a) for a in data.x_scales),
        sigma_out_lambda=t(data.sigma_out_lambda),
        sigma_out_alpha=t(data.sigma_out_alpha),
        sigma_out_beta=t(data.sigma_out_beta), lik_mask=t(data.lik_mask),
        sa_inv=None if data.sa_inv is None else t(data.sa_inv))
    return pcfg, pdata


def flat_shared_from_numpy(shared, dtype=None, device=None) -> FlatShared:
    """The port's FlatShared from the JAX package's (A, L, vecs, scal)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    return make_flat_shared(*(_tensor(a, dt, dev)
                              for a in (shared.A, shared.L, shared.vecs,
                                        shared.scal)))


def flat_state_from_numpy(q, inv_mass, step_size, dtype=None, device=None):
    """Sampler state (positions (..., D), diagonal inverse metric (..., D),
    step sizes) as contiguous tensors."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    return tuple(_tensor(a, dt, dev).contiguous()
                 for a in (q, inv_mass, step_size))


def drift_from_numpy(cfg, data, dtype=None, device=None):
    """(DriftConfig, DriftData) of the port from the JAX package's drift
    config and data (arrays as numpy or anything convertible)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    dcfg = DriftConfig(drift_model=cfg.drift_model, dist_type=cfg.dist_type,
                       nonneg=bool(cfg.nonneg), K=int(cfg.K))
    return dcfg, DriftData(*(_tensor(getattr(data, f), dt, dev)
                             for f in DriftData._fields))


def drift_rows_from_numpy(cfg, params, dtype=None, device=None):
    """Flat rows (..., D) of the port from a drift parameter dict of the
    JAX package (unconstrained values by name, leading batch dims
    allowed; the layout of its ravel_pytree)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    return ravel_drift(cfg, {nm: _tensor(params[nm], dt, dev)
                             for nm, _ in drift_param_shapes(cfg)})


def drift_rows_to_numpy(cfg, rows):
    """The inverse of drift_rows_from_numpy: flat rows (..., D) -> a drift
    parameter dict of numpy arrays."""
    return {nm: v.detach().cpu().numpy()
            for nm, v in unravel_drift(cfg, torch.as_tensor(rows)).items()}


def inverter_state_from_numpy(state):
    """An Inverter's saved fit state (``save_fit_data``'s dict, of this
    package or of the JAX package) with every array leaf as a numpy array:
    dicts, lists and tuples are walked, leaves that export ``__array__``
    (a device array of either package) are converted, and numpy arrays,
    numpy scalars and Python values are kept as they are."""
    if isinstance(state, dict):
        return {k: inverter_state_from_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(inverter_state_from_numpy(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if (hasattr(state, "__array__")
            and not isinstance(state, (np.ndarray, np.generic))):
        return np.asarray(state)
    return state
