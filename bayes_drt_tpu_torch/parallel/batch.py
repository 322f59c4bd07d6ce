"""Batched Bayesian inversion of many spectra (port of
bayes_drt_tpu/parallel/batch.py).

``fit_spectra_batch`` fits spectra on one frequency grid with any model
of the distributions mini-DSL (DRT and DDT, series and parallel, any
number of each, with or without the outlier error). ``mode='sample'``
samples B spectra x C chains as one (B*C, D) chain axis through NUTS
(infer/nuts.py, the default) or SHMC: the flat-chain sampler for the
single series DRT (infer/shmc_flat.py, every draw one launch of the
hand-written trajectory kernel), the generic autograd sampler
(infer/chees.py) for every other model, and summarizes each
spectrum's posterior on the device, and by default refits the spectra
that fail the mixing gate with a ridge-seeded NUTS run spliced into the
result. ``mode='optimize'`` finds each spectrum's MAP point with the
batched L-BFGS and Newton polish of infer/map.py, from random restarts or
a ridge seed. The single series DRT takes the hand-written value and
gradient; every other model autograd of models/posterior.log_density.
``fit_spectra_ragged`` fits spectra measured on different grids,
padded to one length and masked, each with its own A matrices.
``ridge_fit_spectra_batch`` is the batched ridge (infer/ridge.py:
hyper-lambda, ordinary or hyper-weights, lambda_0 by Re-Im
cross-validation) that seeds a single series distribution's fits, the
Inverter's admittance ridge a single parallel one's;
``predict_Z_batch`` evaluates a fit's impedance.
``drift_fit_spectra_batch`` fits fleets of time-evolving spectra on one
sweep schedule (models/drift.py): seeded and random starts of every cell
as one batch of L-BFGS rows. A DRT's A matrices come from the
hand-written quadrature kernel (ops/quad.py).

Sample-mode fits resume from an earlier fit's sampler state
(``warm_start``) or sample with one dense metric pooled from a pilot over
the batch (``precondition='pooled'``). Every captured sampler and solver
is a progcache runner kept across calls. ``sampler='chees'`` runs
ChEES-HMC (infer/chees.py:sample_chees) through the autograd value and
gradient in every route. Every entry point takes a ``mesh``
(parallel/mesh.py): the batch splits into contiguous row ranges, each
run by the same single-device code on its device in a host thread, the
results gathered in row order, the random inputs drawn once for the
whole batch drawn for it and sliced.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._numerics import resolve_device, resolve_dtype
from ..infer.chees import ChEESConfig, SHMCConfig, sample_chees, sample_shmc
from ..infer.diagnostics import ess_bulk_jnp, ess_jnp, rhat_rank_jnp
from ..infer.map import (MapResult, newton_polish, run_lbfgs,
                         run_lbfgs_restarts)
from ..infer.nuts import NUTSConfig, sample_nuts
from ..infer.ridge import (HyperLambdaConfig, RidgeData, ridge_rows,
                           run_hyper_lambda, run_hyper_weights,
                           run_ordinary_ridge)
from ..infer.shmc_flat import (cached_value_and_grad, flat_eligible,
                               flat_shared_for, flat_spec_for,
                               flat_value_and_grad, sample_shmc_flat)
from ..models.build import build_posterior, sort_distributions, z_scale_for
from ..models.drift import (DRIFT_MODELS, DriftConfig, DriftData,
                            constrain_drift, drift_value_and_grad,
                            init_drift_params, predict_drift_target,
                            ravel_drift, unravel_drift)
from ..models.posterior import (MONITOR_SCALARS, constrain, flat_dim,
                                group_data, init_unconstrained, log_density,
                                outlier_monitor_indices,
                                posterior_value_and_grad, predict_target,
                                ravel, unravel)
from ..ops.matrices import (construct_A, construct_L, construct_M,
                            default_epsilon, get_tau_basis)
from ..profiling import StageTimer, count, recorded, span
from ..progcache import _map as _tree_map
from ..progcache import bound, data_shapes, precise_matmuls
from .mesh import Shard, check_precision, resolve_mesh_device, run_shards


def _phase_clock(timing, dev):
    """(mark, phases): ``mark(name)`` records under ``phases[name]`` the
    host seconds since the previous mark (or the call), closed by a device
    synchronize, when ``timing`` is on; in a timed fit's recording scope
    each phase is also a top-level span of the fit (``StageTimer``)."""
    clock = StageTimer(dev, on=timing, phases=True)
    return clock.mark, clock.stages


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
# package's. 'fast' is the bench's SHMC configuration (the unroll knobs
# mean nothing here; recompute_grad reaches the generic sampler, the
# single series DRT's trajectory kernel returns the selected gradient
# either way) in true fp32: the JAX package's preset carries
# precision="high", but its CUDA counterpart (tf32x3) took 1.6x the fp32
# time a draw in the A/B on an H100 (PERF.md) at equal quality, so it
# stays an opt-in arm. 'strict' is the calibrated-interval NUTS
# configuration (md8, not Stan's md10: the DRT posterior's trajectories
# saturate at ~255 leapfrogs).
QUALITY_PRESETS = {
    "fast": dict(
        sampler="shmc", ncp=True, chains=4, warmup=150, samples=250,
        shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32, leaf_unroll=2,
                            draw_unroll=2, recompute_grad=True,
                            eps_quantile=0.5)),
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


def _make_summarize(cfg, chains, samples, monitor_thin: int = 0):
    """Per-spectrum posterior summary on the device for a block of spectra:
    posterior means and percentiles, logp split-Rhat and chain gap,
    divergence/accept statistics, bulk ESS of logp and gamma monitors,
    rank-normalized Rhat/ESS over all parameters (d_chunk=32 blocking), the
    metric-normalized largest posterior eigenvalue, optional pointwise
    gamma bands, the posterior-predictive impedance (the mean over draws of
    each draw's prediction, through the parallel inversion) and the
    posterior-mean coefficients of every further distribution
    (``coef_<i>``).

    ``monitor_thin`` > 0 adds ``monitor_draws`` (Bc, C * (S // thin),
    n_mon), chain-major: every ``monitor_thin``-th draw of each chain
    (Rinf, induc, sigma_res, alpha_prop, alpha_re, alpha_im, gamma at the
    ``gamma_eval_tau`` points, and sigma_out at
    ``outlier_monitor_indices`` with outliers), the raw material of rank
    statistics (simulation-based calibration)."""

    def summarize(dat, draws, info, phi_mon, phi_eval):
        bc, _, _, d = draws.shape                     # (Bc, C, S, D)
        flat = draws.reshape(bc, chains * samples, d)
        with span("summary/constrain"):
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
        inv_mass = info["inv_mass"]                   # (Bc, C, D), or
        diag_mass = (inv_mass if inv_mass.ndim == 3   # (Bc, C, D, D) dense
                     else torch.diagonal(inv_mass, dim1=-2, dim2=-1))
        with span("summary/percentiles"):
            coef_lo = _percentile(xs, 2.5, dim=1)
            coef_hi = _percentile(xs, 97.5, dim=1)
        out = {
            "coef": xs.mean(dim=1),
            "coef_lo": coef_lo,
            "coef_hi": coef_hi,
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
        with span("summary/ess"):
            gmon = (xs @ phi_mon.T).reshape(bc, chains, samples, -1)
            ess_q = ess_jnp(torch.cat([lp[..., None], gmon], dim=-1))
        out["ess_logp"] = ess_q[:, 0]
        out["min_ess"] = ess_q.min(dim=-1).values
        with span("summary/rank"):
            out["rank_rhat_max"] = rhat_rank_jnp(draws, d_chunk=32).max(
                dim=-1).values
            out["ess_bulk_min"] = ess_bulk_jnp(draws, d_chunk=32).min(
                dim=-1).values
        # power iteration on the pooled draws, centered on the global mean
        # and scaled by the adapted metric
        with span("summary/power_iter"):
            y = ((draws - flat.mean(dim=1)[:, None, None, :])
                 / torch.sqrt(torch.clamp(diag_mass, min=1e-30))[
                     :, :, None, :])
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
            with span("summary/percentiles"):
                out["gamma_eval_lo"] = _percentile(ge, 2.5, dim=1)
                out["gamma_eval_hi"] = _percentile(ge, 97.5, dim=1)
        if not cfg.fitY:
            with span("summary/predict"):
                preds = predict_target(cfg, dat, c)
                out["z_hat_mean"] = preds.mean(dim=1)
                out["z_hat_std"] = preds.std(dim=1, correction=0)
        if monitor_thin:
            td = draws[:, :, monitor_thin - 1::monitor_thin, :]
            cm = constrain(cfg, dat, unravel(cfg, td.reshape(bc, -1, d)))
            cols = [torch.stack([cm[s] for s in MONITOR_SCALARS], dim=-1),
                    cm["x_0"] @ phi_eval.T]
            if cfg.outliers:
                idx = list(outlier_monitor_indices(cm["sigma_out"].shape[-1]))
                cols.append(cm["sigma_out"][..., idx])
            out["monitor_draws"] = torch.cat(cols, dim=-1)
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
    ``targets`` (all rows when None). ``density`` replaces log_density
    (and the hand-written gradient) by a function of its signature.
    ``shared`` is the hand-written form's FlatShared (built from ``data``
    when None); ``map_objective`` keeps one as a cache entry."""

    def __init__(self, cfg, data, targets, density=None, shared=None):
        self.cfg, self.data, self.targets = cfg, data, targets
        self.density = log_density if density is None else density
        self.flat = flat_eligible(cfg) and density is None
        if self.flat:
            self.spec = flat_spec_for(cfg, data)
            self.shared = (flat_shared_for(cfg, data, targets.dtype)
                           if shared is None else shared)

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
                                             jacobian=False,
                                             density=self.density)(q)
        return -lp, -g

    def hessian(self, q, rows=None):
        cfg, data, density = self.cfg, self.data, self.density

        def loss(q_row, t_row):
            return -density(cfg, data._replace(target=t_row),
                            unravel(cfg, q_row), jacobian=False)

        hess = torch.func.jacrev(torch.func.jacrev(loss))
        return torch.func.vmap(hess)(q, self._targets(rows))


def map_objective(tag, cfg, data, targets, density=None, key=()):
    """A ``MapObjective`` as a progcache runner (``Bound``: its fn is the
    objective over static copies of data, targets and the hand-written
    form's FlatShared, this call's values copied in), keyed on ``tag``,
    the model configuration, the density, the inputs' shapes and dtypes,
    the device and ``key``."""
    flat = flat_eligible(cfg) and density is None
    inputs = (data, targets,
              flat_shared_for(cfg, data, targets.dtype) if flat else None)
    full = (tag, cfg, density, data_shapes(inputs), str(targets.device)
            ) + tuple(key)
    return bound(full, inputs, lambda buf: MapObjective(
        cfg, buf[0], buf[1], density=density, shared=buf[2]))


def _drift_loss(tag, cfg, data, key=()):
    """Minus the drift log density's value and gradient over ``data``'s
    rows as a progcache runner, keyed like ``map_objective``."""
    def make(d):
        vg = drift_value_and_grad(cfg, d)

        def loss(q, rows=None):
            lp, g = vg(q)
            return -lp, -g

        return loss

    full = (tag, cfg, data_shapes(data), str(data.Z.device)) + tuple(key)
    return bound(full, data, make)


def _sampler_entry(tag, cfg, data, tgt_rows, run_cfg, form="diag",
                   density=None, budget=()):
    """The sampler's value and gradient as a progcache runner, keyed on
    what shapes the sampler's graphs: NUTS's depth, tree form, energy
    bound and the metric's form; SHMC's leapfrog counts,
    ``recompute_grad``, energy bound, ``traj_store`` and precision. ChEES takes the autograd value
    and gradient on every model (as the JAX package's sample_chees takes
    jax.value_and_grad) and is keyed as the JAX package keys its program:
    ``budget`` is (tag, chains, warmup, samples), tag 'chees' or
    'warm-chees', beside the whole configuration."""
    if isinstance(run_cfg, NUTSConfig):
        key = ("nuts", run_cfg.max_depth, bool(run_cfg.tree_scan),
               float(run_cfg.max_energy_error), form)
    elif isinstance(run_cfg, ChEESConfig):
        key = (budget[0], run_cfg) + tuple(budget[1:])
        density = log_density if density is None else density
    else:
        key = ("shmc", run_cfg.n_steps, run_cfg.warm_steps,
               bool(run_cfg.recompute_grad), float(run_cfg.max_energy_error),
               bool(run_cfg.traj_store), run_cfg.precision)
    return cached_value_and_grad(tag, cfg, data, tgt_rows, density=density,
                                 key=key)


def _warm_state(warm_start, cfg, b_real, b, chains, ragged=False):
    """The sampler state a warm start resumes from, padded like the batch:
    (state_q (b, C, D), state_inv_mass (b, C, D) or (b, C, D, D),
    state_step_size (b, C)) numpy, after the JAX package's guards."""
    ws = warm_start.diagnostics
    for k in ("state_q", "state_inv_mass", "state_step_size"):
        if k not in ws:
            raise ValueError(
                "warm_start must be a sample-mode BatchFitResult carrying "
                f"sampler state (missing diagnostics[{k!r}])")
    if ws.get("state_cfg") is not None and ws["state_cfg"] != cfg:
        if ragged:
            raise ValueError(
                "warm_start was sampled under a different model "
                "configuration than this fit; resuming across "
                "parameterizations would mix coordinate systems")
        raise ValueError(
            "warm_start was sampled under a different model configuration "
            f"({ws['state_cfg'].model_name()}, ncp={ws['state_cfg'].ncp}) "
            f"than this fit ({cfg.model_name()}, ncp={cfg.ncp}); resuming "
            "across parameterizations would mix coordinate systems")
    b_prev = np.asarray(ws["state_q"]).shape[0]
    if b_prev != b_real:
        # silently padding a smaller prior batch would seed real spectra
        # with spectrum-0's positions and fixed metric
        layout = ("the batch layout across calls" if ragged else
                  "the batch layout (same spectra, same order) across calls")
        raise ValueError(
            f"warm_start holds sampler state for {b_prev} spectra but this "
            f"fit has {b_real}; chained refits must keep {layout}")
    wq = _pad_rows(np.asarray(ws["state_q"]), b)
    wm = _pad_rows(np.asarray(ws["state_inv_mass"]), b)
    weps = _pad_rows(np.asarray(ws["state_step_size"]), b)
    if wq.shape[1] != chains:
        raise ValueError(f"warm_start carries {wq.shape[1]} chains, this "
                         f"fit requests {chains}")
    return wq, wm, weps


def _warm_traj_time(warm_start, b, dtype, device, ragged=False):
    """A ChEES warm start's trajectory times (b,), padded like the batch,
    after the JAX package's guard."""
    ws = warm_start.diagnostics
    b_prev = np.asarray(ws["state_q"]).shape[0]
    wtt = np.asarray(ws.get("state_traj_time", np.full(b_prev, np.nan)),
                     float)
    if np.any(np.isnan(wtt)):
        raise ValueError(
            "warm_start for sampler='chees' needs "
            "diagnostics['state_traj_time']"
            + ("" if ragged else " (a previous chees fit)"))
    return torch.as_tensor(_pad_rows(wtt, b), device=device).to(dtype)


def _warm_run(sampler, run_cfg, warm, dtype, device):
    """(q0 rows, run_cfg with the metric held fixed, metric,
    init_step_size) of a warm start: NUTS resumes every chain with its
    own metric and step size; SHMC and ChEES every spectrum with its
    chains' mean metric and mean step size, as the JAX package does."""
    wq, wm, weps = warm
    b, chains, dim = wq.shape

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               device=device).to(dtype)

    q0 = t(wq.reshape(b * chains, dim))
    run_cfg = run_cfg._replace(adapt_mass=False)
    if sampler == "nuts":
        return (q0, run_cfg, t(wm.reshape((b * chains,) + wm.shape[2:])),
                t(weps.reshape(-1)))
    if wm.ndim == 4:
        raise ValueError(f"warm_start carries a dense metric; "
                         f"sampler={sampler!r} resumes from diagonal metrics "
                         "only (use sampler='nuts')")
    return q0, run_cfg, t(wm.mean(axis=1)), t(weps.mean(axis=1))


def pooled_metric(pilot):
    """One dense metric from pilot draws (b, C, S, D): each (spectrum,
    chain) centered on its own mean, so only within-posterior covariance
    pools, into one float64 covariance on the host, jittered until its
    Cholesky factor exists (the JAX package's pooled preconditioner).
    Returns (m_inv, chol) numpy float64."""
    d64 = np.asarray(pilot, np.float64)
    centered = d64 - d64.mean(axis=2, keepdims=True)
    flat_d = centered.reshape(-1, d64.shape[-1])
    dof = max(d64.shape[0] * d64.shape[1] * (d64.shape[2] - 1), 1)
    cov = flat_d.T @ flat_d / dof
    dim = cov.shape[0]
    jitter = max(1e-6 * float(np.mean(np.diag(cov))), 1e-12)
    for _ in range(8):
        try:
            chol64 = np.linalg.cholesky(cov + jitter * np.eye(dim))
            break
        except np.linalg.LinAlgError:
            jitter *= 10.0
    else:
        raise RuntimeError("pooled pilot covariance is not positive "
                           "definite; use precondition=None")
    return cov + jitter * np.eye(dim), chol64


def _ridge_init_values(frequencies, Z_batch, b_real, z_scales, K,
                       ridge_kw, dtype, device, basis_freq=None,
                       epsilon=None, mesh=None):
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
                                   dtype=dtype, device=device, mesh=mesh,
                                   **rdefaults)
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


def _parallel_ridge_init_values(frequencies, Z_batch, b_real, z_scales, K,
                                ridge_kw, dtype, device, dists_norm,
                                basis_freq, epsilon, basis, outliers):
    """Ridge-seeded init values of a single parallel distribution: one
    Inverter admittance ridge a spectrum, on the fit's device and dtype,
    in the posterior's scaled coordinates (the admittance coefficients
    scale up by the spectrum's Z scale), padded like the batch; with
    ``outliers``, sigma_out_raw 1.0 at the points the Inverter's
    ``check_outliers(threshold=3)`` flags and 0.1 elsewhere. Sampling a
    parallel model needs this seed: random-init chains can stick in the
    Y ~ 0 mode far below the data-fitting one."""
    from ..inverter import Inverter      # the Inverter imports this module
    rdefaults = dict(penalty="integral", hyper_lambda=True, lambda_0=1.0,
                     hl_beta=5, weights="modulus")
    rdefaults.update(ridge_kw or {})
    name0 = sort_distributions(dists_norm)[0]
    clean = {name0: {k: v for k, v in dists_norm[name0].items()
                     if not k.startswith("_")}}
    iv_x = np.zeros((b_real, K))
    iv_rinf = np.zeros(b_real)
    iv_induc = np.zeros(b_real)
    iv_sig = np.full((b_real, len(frequencies)), 0.1) if outliers else None
    inv = Inverter(distributions=clean, basis_freq=basis_freq, basis=basis,
                   epsilon=epsilon, device=device, dtype=dtype)
    for i in range(b_real):
        inv.ridge_fit(frequencies, Z_batch[i], **rdefaults)
        iv_x[i] = inv.distribution_fits[name0]["coef"] * z_scales[i]
        iv_rinf[i] = max(float(inv.R_inf) / z_scales[i], 1e-10) / 100.0
        iv_induc[i] = max(float(inv.inductance) / z_scales[i], 1e-10)
        if outliers:
            oidx = inv.check_outliers(frequencies, Z_batch[i], threshold=3,
                                      use_existing_fit=True)
            iv_sig[i][np.asarray(oidx).ravel()] = 1.0
    b = Z_batch.shape[0]
    iv = {"x_0": iv_x, "Rinf_raw": iv_rinf, "induc_raw": iv_induc}
    if outliers:
        iv["sigma_out_raw"] = iv_sig
    return {k: _pad_rows(v, b) for k, v in iv.items()}


def _ridge_seed(frequencies, Z_batch, b_real, z_scales, cfg, data, targets,
                ridge_kw, dtype, device, basis_freq, epsilon, outliers,
                dists_norm, basis, mesh=None):
    """init_unconstrained's init_values from a ridge fit, (b, ...) rows:
    x_0, Rinf_raw, induc_raw and, with ``outliers``, the sigma_out_raw
    seed; the batched ridge for a single series distribution (the
    3-sigma outlier seed), the Inverter's per-spectrum admittance ridge
    for a single parallel one."""
    if cfg.dists[0].dist_type == "parallel":
        return _parallel_ridge_init_values(
            frequencies, Z_batch, b_real, z_scales, cfg.dists[0].K,
            ridge_kw, dtype, device, dists_norm, basis_freq, epsilon, basis,
            outliers)
    iv_x, iv_rinf, iv_induc = _ridge_init_values(
        frequencies, Z_batch, b_real, z_scales, cfg.dists[0].K, ridge_kw,
        dtype, device, basis_freq=basis_freq, epsilon=epsilon, mesh=mesh)
    iv = {"x_0": iv_x, "Rinf_raw": iv_rinf, "induc_raw": iv_induc}
    if outliers:
        iv["sigma_out_raw"] = _outlier_seed(iv_x, iv_rinf, iv_induc,
                                            targets, data)
    return iv


def _per_spectrum(x, b, chains):
    """(T, b*chains, ...) per-draw rows -> (b, chains, T, ...)."""
    return x.reshape((x.shape[0], b, chains) + x.shape[2:]).movedim(0, 2)


def _shard_plan(mesh, b, dev):
    """The shards of a b-row batch: the mesh's (parallel/mesh.py), or the
    whole batch on ``dev`` without one."""
    if mesh is None:
        return [Shard(dev, 0, b, 0, None)]
    return mesh.shards(b)


def _shard_generator(sh, gen, random_seed):
    """A shard's generator of per-draw noise: the fit's own, continuing
    after its batch-wide draws, for the shard at row 0 (so that a
    one-device mesh draws what the meshless fit draws); for any other
    shard one seeded from ``random_seed`` and the shard's start row."""
    if sh.start == 0:
        return gen
    seed = np.random.SeedSequence([int(random_seed), sh.start])
    return torch.Generator(device=sh.device).manual_seed(
        int(seed.generate_state(1)[0]))


def _to_device(tree, device):
    """A tree of tensors (NamedTuples, tuples, dicts) on ``device``."""
    return _tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                     else t, tree)


class _SampleJob(NamedTuple):
    """What every shard of a sample-mode fit shares: the progcache tag,
    the sampler and model, the budget, whether the single series DRT's
    trajectory kernel runs (``flat``), the density (None: the default),
    the summary's options and (tau, eps, gamma_eval_tau, dtype) of its
    monitor and evaluation bases."""
    tag: str
    sampler: str
    cfg: object
    chains: int
    samples: int
    b_real: int
    timing: bool
    flat: bool
    density: object
    monitor_thin: int
    random_seed: int
    phi: tuple


class _ShardRows:
    """One shard's rows of a sample-mode fit, on the shard's device: its
    data (per-spectrum data sliced to its spectra), targets, initial
    states, metric, step sizes and trajectory times cut from the batch's,
    and its generator. ``pilot`` runs the pooled preconditioner's pilot,
    ``sample`` the sampler, ``summarize`` the summary of the shard's real
    spectra."""

    def __init__(self, job, sh, data, targets, q0, gen, metric, init_eps,
                 init_traj):
        c = job.chains
        self.job, self.sh, self.b = job, sh, sh.stop - sh.start
        spec = slice(sh.start, sh.stop)
        rows = slice(sh.start * c, sh.stop * c)
        dev = sh.device

        def cut(x, per_row):
            if not isinstance(x, torch.Tensor) or x.ndim == 0:
                return x
            return x[rows if per_row else spec].to(dev)

        per_row = job.sampler == "nuts"
        self.data = _to_device(_spectra_rows(data, spec), dev)
        self.targets = targets[spec].to(dev)
        self.q0 = cut(q0, True).contiguous()
        self.metric = cut(metric, per_row)
        self.init_eps = cut(init_eps, per_row)
        self.init_traj = cut(init_traj, False)
        self.gen = _shard_generator(sh, gen, job.random_seed)
        self.tgt_rows = self.targets.repeat_interleave(c, dim=0).contiguous()

    def _entry(self, run_cfg, form="diag", budget=()):
        return _sampler_entry(self.job.tag, self.job.cfg, self.data,
                              self.tgt_rows, run_cfg, form,
                              density=self.job.density, budget=budget)

    def pilot(self, nuts_cfg, pilot_warmup, pilot_samples):
        """The pooled preconditioner's diagonal-metric NUTS pilot: draws
        (S, rows, D)."""
        entry = self._entry(nuts_cfg)
        draws, _ = sample_nuts(entry.fn, self.q0, pilot_warmup,
                               pilot_samples, nuts_cfg, generator=self.gen,
                               graphs=entry.graphs)
        return draws

    def sample(self, run_cfg, warmup, form, budget):
        """Run the sampler on the shard's rows, keeping its draws and
        info for ``summarize``."""
        job = self.job
        flat_args = None
        entry = None
        if job.flat:
            flat_args = (flat_spec_for(job.cfg, self.data),
                         flat_shared_for(job.cfg, self.data,
                                         self.targets.dtype), self.tgt_rows)
        else:
            entry = self._entry(run_cfg, form, budget)
        self.draws, self.info = _run_sampler(
            job.sampler, entry, self.q0, job.chains, warmup, job.samples,
            run_cfg, self.gen, job.timing, flat_args, self.metric,
            self.init_eps, self.init_traj)

    def summarize(self):
        """(summary of the shard's real spectra (None without any), the
        sampler's timing records); drops the draws."""
        job, info = self.job, self.info
        n_real = max(0, min(self.sh.stop, job.b_real) - self.sh.start)
        out = None
        if n_real:
            tau, eps, gamma_eval_tau, dt = job.phi
            phi_mon, phi_eval = _phi_mats(tau, eps, gamma_eval_tau, dt,
                                          self.sh.device)
            out = _summarize_blocks(job.cfg, self.data, self.draws, info,
                                    job.chains, job.samples, n_real,
                                    phi_mon, phi_eval, job.monitor_thin)
            _add_traj_time(out, info, n_real)
        self.draws = None
        return out, {k: info[k] for k in _TIMING_KEYS if k in info}


def _spectra_rows(data, spec):
    """Posterior data restricted to the spectra ``spec``: per-spectrum
    fields (a ragged batch's A (b, 2n, K), freq (b, n) and lik_mask
    (b, 2n)) sliced, shared-grid data as it is."""
    if data.freq.ndim != 2:
        return data
    return data._replace(A=tuple(a[spec] for a in data.A),
                         freq=data.freq[spec], lik_mask=data.lik_mask[spec])


def _gather_parts(parts):
    """The shards' summaries joined in row order (numpy) and the timing
    records of the first shard's sampler."""
    outs = [o for o, _ in parts if o is not None]
    out = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return out, parts[0][1]


def _shmc_route(flat, sh_cfg) -> str:
    """``diagnostics['shmc_route']``: which SHMC trajectory ran."""
    if flat:
        return "flat-kernel"
    return "generic-store" if sh_cfg.traj_store else "generic"


@recorded
def fit_spectra_batch(frequencies, Z_batch, mode: str = "sample",
                      basis_freq=None, epsilon=None, nonneg: bool = False,
                      outliers: bool = False, chains: int = 4,
                      warmup: int = 500, samples: int = 500,
                      max_iter: int = 2000, n_restarts: int = 2,
                      polish: bool = True,
                      init_from_ridge: bool = False,
                      ridge_kw: Optional[dict] = None,
                      random_seed: int = 0, mesh=None,
                      max_tree_depth: int = 10,
                      dtype=None, distributions=None,
                      precondition: Optional[str] = None,
                      pilot_warmup: int = 50, pilot_samples: int = 25,
                      ncp: bool = False, unroll: int = 1,
                      flat_tree: bool = False, tree_scan: bool = False,
                      scan_unroll: int = 1, basis: str = "gaussian",
                      gamma_eval_tau=None, monitor_thin: int = 0,
                      z_scale=None, sigma_min: float = 0.002,
                      sampler: str = "nuts", chees_cfg=None, shmc_cfg=None,
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
    effect here. ``sampler='shmc'`` runs static multinomial HMC with
    ``shmc_cfg``: the flat-chain sampler, one launch of the hand-written
    trajectory kernel per draw, for the single series DRT without
    outliers; the generic sampler (autograd, each draw's trajectory one
    CUDA graph replay on a CUDA device) for every other model.
    ``sampler='chees'`` runs ChEES-HMC with ``chees_cfg`` (default
    ``ChEESConfig()``) on every model through the autograd value and
    gradient, a spectrum's chains sharing one metric and trajectory time
    (``diagnostics['state_traj_time']``, (B,)), each draw's leaves
    replayed as CUDA graph blocks on a CUDA device. Runs on CUDA unless
    ``device`` says otherwise, float32 unless ``dtype`` says otherwise;
    random numbers come from a torch.Generator seeded with
    ``random_seed``. The single series DRT without outliers takes the
    hand-written value and gradient (infer/shmc_flat.py); every other
    model autograd of models/posterior.log_density.

    ``init_from_ridge`` (a single distribution): every chain, or the one
    L-BFGS run, starts at the coordinates of a ridge solution
    (``ridge_kw`` overrides its defaults; the batched hyper-lambda ridge
    for a series distribution, the Inverter's admittance ridge of each
    spectrum for a parallel one), the other parameters Stan-random; with
    ``outliers``, ``sigma_out`` starts high at the frequencies whose ridge
    residual exceeds 3 standard deviations (series) or that the
    Inverter's ``check_outliers`` flags (parallel). ``z_scale`` overrides
    the data-derived per-spectrum scale (for a single parallel planar DDT
    the rule targets the calibrated admittance std Y*).

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
    ``init_from_ridge``, off for ChEES.

    ``timing`` records host-clock phases closed by a device synchronize
    (``diagnostics['phase_s']``: setup, ridge when seeded, then sample and
    summary, or lbfgs and polish, with the L-BFGS part of ``n_iter`` in
    ``diagnostics['n_iter_lbfgs']``), each NUTS, ChEES or generic SHMC
    draw's seconds, closed by a synchronize (``diagnostics['draw_s']``),
    the graph captures' (``diagnostics['capture_s']``) and the escalation
    refit's host seconds (``diagnostics['refit_s']``), and records the
    fit's spans and counters (``profiling``), which add no synchronize:
    ``diagnostics['spans']``, a list of dicts (name, id, parent, fit,
    shard, start_ns and end_ns on ``time.time_ns()``'s clock, device_s
    from a CUDA event pair) under the root ``fit``: the phases above, then
    ``sample/draw`` (each SHMC draw, synchronize excluded) with
    ``sample/draw/traj`` (its trajectory: the K1 launch, or the generic
    sampler's with ``sample/draw/traj/replay``, its graph replay),
    ``summary/constrain``, ``summary/percentiles``, ``summary/ess``,
    ``summary/rank``, ``summary/power_iter``, ``summary/predict``,
    ``summary/to_host``, ``lbfgs/iter``, ``polish/hessian``,
    ``polish/solve``, ``polish/step``, ``polish/check``, ``escalate`` with
    ``escalate/gate`` and ``escalate/refit`` (the refit's own ``fit``
    below it); ``diagnostics['counters']``: ``sample/draws``,
    ``lbfgs/ls_steps``, ``polish/iters``, ``polish/rows`` (Hessian rows
    evaluated) and ``escalate/rows``, summed over the shards and the
    refit.

    ``monitor_thin`` > 0 (sample mode) stores every ``monitor_thin``-th
    draw of each chain's monitors under ``diagnostics['monitor_draws']``
    (B, chains * (samples // monitor_thin), n_mon), chain-major: Rinf and
    induc in impedance units, sigma_res and the three alpha in the scaled
    space, gamma at ``gamma_eval_tau`` in the first distribution's units,
    sigma_out at ``outlier_monitor_indices`` in impedance units (the
    simulation-based calibration's rank statistics, sbc.py).

    ``warm_start`` (sample mode): an earlier sample-mode result for the
    same batch layout (spectra, chains, model). NUTS resumes every chain
    from its last position with its own metric held fixed and its own
    step size seeding the search (the step size re-adapts over
    ``warmup``); SHMC resumes every spectrum with its chains' mean metric
    and mean step size, ChEES also with its trajectory time
    (``state_traj_time``, which a ChEES result carries). A chained refit
    of slowly moving spectra needs a fraction of a cold fit's warmup;
    escalation is off by default.

    ``precondition='pooled'`` (NUTS): a diagonal-metric pilot of
    ``pilot_warmup`` + ``pilot_samples`` draws over the batch, its draws
    centered per (spectrum, chain) and pooled into one dense metric
    (``pooled_metric``) shared by every chain, then NUTS from the pilot's
    last states with that metric fixed and max(20, warmup - pilot_warmup
    - pilot_samples) warmup draws.

    Every captured piece (the NUTS trees, the generic SHMC trajectories,
    the L-BFGS iterations) is a progcache runner kept across calls: a
    later call of the same shapes and settings copies its data into the
    runner's buffers and replays without capturing.

    ``basis`` names the RBF family (construct_L, like the JAX package's,
    builds the penalty's orders 1 and 2 for 'gaussian' only, so other
    bases raise its ValueError).

    ``mesh`` (``make_mesh``): the padded batch splits into contiguous row
    ranges along the mesh's 'spectra' axis, each sampled (or optimized)
    and summarized on its device by the code above, in a host thread of
    its device, and the results gather in row order;
    ``diagnostics['shard_layout']`` records (device index, start, stop)
    of every device. The fit's setup, the inits, ridge seed and warm
    state it draws or reads for the whole batch, the pooled pilot's
    metric and the escalation refit run for the whole batch on the
    mesh's first device; each device builds its own A (K2) and, on the
    single series DRT, launches the trajectory kernel on its own rows.
    The per-draw noise of the shard at row 0 continues the fit's
    generator, every other shard's comes from a generator seeded from
    ``random_seed`` and its start row: a one-device mesh gives the
    meshless fit bit for bit, a larger one a MAP fit with the same
    starts and a sampled fit that agrees statistically. Naming the
    flat-chain arm (``SHMCConfig(pallas_traj=True)`` or
    ``flat_chain=True``) with a mesh raises the JAX package's
    ValueError.

    ``SHMCConfig(traj_store=True)`` takes the generic sampler on every
    model (the trajectory kernel has no store-then-select form) unless
    the flat-chain arm is named too, which ignores it as the JAX
    package's does; ``diagnostics['shmc_route']`` names the SHMC route
    taken ('flat-kernel', 'generic' or 'generic-store') and
    ``diagnostics['precision']`` the products it ran ('high', tf32x3 on
    CUDA, reaches the generic sampler only; the kernel runs fp32). A
    precision='high' generic fit on CUDA records the probe
    ``diagnostics['bf16x3_grad_err']`` and warns outside the screening
    regime (``_tf32x3_guard``).
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
    dists = _normalize_distributions(distributions)
    n_dists = len(dists)
    single_parallel = (n_dists == 1 and next(iter(dists.values()))[
        "dist_type"] == "parallel")
    if init_from_ridge and n_dists > 1:
        raise ValueError("Ridge initialization can only be performed for "
                         "single-distribution fits")
    dev = (resolve_device(device) if mesh is None
           else resolve_mesh_device(mesh, device))
    dt = resolve_dtype(dtype)
    mark, phases = _phase_clock(timing, dev)

    Z_batch = np.asarray(Z_batch)
    order = np.argsort(np.asarray(frequencies, float))[::-1]
    frequencies = np.asarray(frequencies, float)[order]
    Z_batch, b_real = _pad_pow2(Z_batch[:, order])
    b = Z_batch.shape[0]
    setup_kw = dict(basis_freq=basis_freq, epsilon=epsilon, nonneg=nonneg,
                    sigma_min=sigma_min, distributions=distributions,
                    outliers=outliers, basis=basis)
    if mode == "optimize":
        return _fit_map(frequencies, Z_batch, b_real, setup_kw, z_scale, dt,
                        dev, random_seed, init_from_ridge, ridge_kw,
                        n_restarts, max_iter, polish, mark,
                        phases if timing else None, mesh)
    if sampler not in ("nuts", "chees", "shmc"):
        raise ValueError(f"Unknown sampler {sampler!r}; options are "
                         "'nuts', 'chees', 'shmc'")
    if warm_start is not None and precondition is not None:
        raise ValueError("warm_start and precondition are mutually "
                         "exclusive")
    if precondition is not None:
        if precondition != "pooled":
            raise ValueError(f"Unknown precondition {precondition!r}; the "
                             "option is 'pooled'")
        if sampler in ("chees", "shmc"):
            raise ValueError(
                "precondition='pooled' builds a dense metric; "
                "sample_chees/sample_shmc support diagonal metrics only "
                "(their chain-pooled Welford adaptation replaces the pooled "
                "pilot). Use sampler='nuts' or drop precondition.")
    if sampler == "shmc":
        sh_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
        sh_cfg.validate()
        check_precision(mesh, sh_cfg.precision)
        if mesh is not None and (sh_cfg.pallas_traj or sh_cfg.flat_chain):
            raise ValueError(
                "pallas_traj/flat_chain does not shard over a mesh "
                "yet; drop mesh= or use the generic shmc path")
    # the single series DRT's SHMC runs the trajectory kernel (K1), which
    # has no store-then-select form: traj_store takes the generic sampler
    # unless the caller names the flat arm, which ignores it as JAX's does
    flat = (sampler == "shmc" and n_dists == 1 and not single_parallel
            and not outliers and not (
                sh_cfg.traj_store
                and not (sh_cfg.pallas_traj or sh_cfg.flat_chain)))
    if init_from_ridge and flat:
        raise ValueError("init_from_ridge does not support the flat-chain "
                         "SHMC sampler; use sampler='nuts'")
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
    if sampler == "shmc":
        run_cfg = sh_cfg
    elif sampler == "chees":
        run_cfg = chees_cfg if chees_cfg is not None else ChEESConfig()
    else:
        nuts_cfg = run_cfg = NUTSConfig(
            max_depth=max_tree_depth, unroll=unroll, flat_tree=flat_tree,
            tree_scan=tree_scan, scan_unroll=scan_unroll)
        nuts_cfg.validate()
    frequencies, tau, eps, cfg, data, dists_norm = _build_shared(
        frequencies, dtype=dt, ncp=ncp, device=dev, **setup_kw)
    z_scales, targets = _scaled_targets(Z_batch, b_real, z_scale, dt, dev,
                                        dists_norm)

    warm = None
    if warm_start is not None:
        warm = _warm_state(warm_start, cfg, b_real, b, chains)
    D = flat_dim(cfg, data.freq.shape[0])
    gen = torch.Generator(device=dev).manual_seed(int(random_seed))
    if sampler == "shmc" and not flat and (sh_cfg.pallas_traj
                                           or sh_cfg.flat_chain):
        flat_spec_for(cfg, data)           # raises: not the flat family
    mark("setup")
    init_values = None
    if init_from_ridge:
        iv = _ridge_seed(frequencies, Z_batch, b_real, z_scales, cfg, data,
                         targets, ridge_kw, dt, dev, basis_freq, epsilon,
                         outliers, dists_norm, basis, mesh)
        init_values = {k: v[:, None] for k, v in iv.items()}
        mark("ridge")
    q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                       batch_shape=(b, chains),
                                       init_values=init_values))
    q0 = q0.reshape(b * chains, D).contiguous()
    metric, init_eps, form, run_warmup = None, 1.0, "diag", warmup
    init_traj = None
    if warm is not None:
        q0, run_cfg, metric, init_eps = _warm_run(sampler, run_cfg, warm, dt,
                                                  dev)
        if sampler == "chees":
            init_traj = _warm_traj_time(warm_start, b, dt, dev)
        if metric.ndim == 3:
            form = "dense_rows"
    job = _SampleJob(
        tag="fit_spectra_batch", sampler=sampler, cfg=cfg, chains=chains,
        samples=samples, b_real=b_real, timing=timing, flat=flat,
        density=None, monitor_thin=monitor_thin, random_seed=random_seed,
        phi=(tau, eps, gamma_eval_tau, dt))
    shards = _shard_plan(mesh, b, dev)
    built = {str(dev): data}

    def data_on(sh):
        # K2 builds A once on every device of the mesh
        if str(sh.device) not in built:
            built[str(sh.device)] = _build_shared(
                frequencies, dtype=dt, ncp=ncp, device=sh.device,
                **setup_kw)[4]
        return built[str(sh.device)]

    rows = run_shards(lambda sh: _ShardRows(
        job, sh, data_on(sh), targets, q0, gen, metric, init_eps,
        init_traj), shards)
    if precondition == "pooled":
        pilots = run_shards(lambda sh: rows[sh.position].pilot(
            nuts_cfg, pilot_warmup, pilot_samples), shards)
        m_inv, chol = pooled_metric(np.concatenate(
            [_per_spectrum(p, r.b, chains).cpu().numpy()
             for p, r in zip(pilots, rows)]))
        for p, r in zip(pilots, rows):
            r.q0, r.metric = p[-1].contiguous(), (m_inv, chol)
        run_warmup = max(20, warmup - pilot_warmup - pilot_samples)
        run_cfg = nuts_cfg._replace(adapt_mass=False)
        form = "dense"
        mark("pilot")
    budget = ("warm-chees" if warm is not None else "chees", chains,
              run_warmup, samples)
    run_shards(lambda sh: rows[sh.position].sample(
        run_cfg, run_warmup, form, budget), shards)
    mark("sample")
    out, info = _gather_parts(run_shards(
        lambda sh: rows[sh.position].summarize(), shards))
    mark("summary")
    result = _sampled_result(cfg, out, z_scales[:b_real], dists_norm, tau,
                             eps, basis, n_eval=_n_eval(gamma_eval_tau))
    diagnostics = result.diagnostics
    # the model configuration beside the sampler state, so that a warm
    # start refuses a resume across parameterizations
    diagnostics["state_cfg"] = cfg
    if "z_hat_mean" in diagnostics:
        # the training grid (descending), where predict_Z_batch serves the
        # draws' mean prediction
        diagnostics["f_train"] = np.asarray(frequencies, float)
    if mesh is not None:
        diagnostics["shard_layout"] = mesh.layout(b)
    if sampler == "shmc":
        diagnostics["shmc_route"] = _shmc_route(flat, sh_cfg)
        diagnostics["precision"] = ("highest" if flat
                                    else sh_cfg.precision)
    if timing:
        for k in _TIMING_KEYS:
            if k in info:
                diagnostics[k] = np.asarray(info[k])
        diagnostics["phase_s"] = phases
    if (sampler == "shmc" and not flat and sh_cfg.precision == "high"
            and dev.type == "cuda"):
        _tf32x3_guard(diagnostics, cfg, data, targets, b, b_real, sh_cfg,
                      samples)

    # ---- gate-triggered escalation: refit the under-mixed tail ----
    if escalate:
        with span("escalate"):
            gate_kw = dict(n_draws=chains * samples)
            gate_kw.update(escalate_gate or {})
            with span("escalate/gate"):
                esc_mask = escalation_mask(diagnostics, b_real, **gate_kw)
            diagnostics["escalated"] = esc_mask
            count("escalate/rows", int(esc_mask.sum()))
            if esc_mask.any():
                sub_z_scale = None
                if z_scale is not None:
                    sub_z_scale = np.broadcast_to(
                        np.asarray(z_scale, float), (b_real,))[esc_mask]
                warnings.warn(
                    f"{int(esc_mask.sum())}/{b_real} spectra failed the "
                    f"mixing gate; refitting them with "
                    f"{esc_kw.get('sampler', 'nuts')} (escalate=False "
                    "disables)")
                with span("escalate/refit") as refit:
                    sub = fit_spectra_batch(
                        frequencies, Z_batch[:b_real][esc_mask],
                        mode="sample", basis_freq=basis_freq,
                        epsilon=epsilon, nonneg=nonneg, outliers=outliers,
                        chains=chains, warmup=warmup, samples=samples,
                        random_seed=random_seed + 1,
                        distributions=distributions, basis=basis,
                        gamma_eval_tau=gamma_eval_tau,
                        monitor_thin=monitor_thin, z_scale=sub_z_scale,
                        sigma_min=sigma_min, dtype=dtype, escalate=False,
                        timing=timing, device=dev, **esc_kw)
                if timing:
                    diagnostics["refit_s"] = refit.seconds
                result = _splice_results(result, sub, esc_mask)
    return result


def _coef_scale(cfg, i, z_scales):
    """(b, 1) factor from scaled to physical coefficients of distribution
    i: series coefficients multiply by the Z scale, parallel (admittance)
    ones divide."""
    if cfg.dists[i].dist_type == "parallel":
        return 1.0 / z_scales[:, None]
    return z_scales[:, None]


# per-draw timing records of the samplers (and ChEES's per-draw largest
# leapfrog count and graph replays), kept out of the summary
_TIMING_KEYS = ("draw_s", "capture_s", "leaf_max", "replays")


def _n_eval(gamma_eval_tau) -> int:
    return 0 if gamma_eval_tau is None else len(np.atleast_1d(
        np.asarray(gamma_eval_tau, float)))


def _phi_mats(tau, eps, gamma_eval_tau, dtype, device):
    """The first distribution's basis at the 8 monitor points of the
    summary's ESS (phi_mon) and at ``gamma_eval_tau`` (phi_eval, empty
    without it)."""
    k0 = len(tau)
    mon_idx = np.unique(np.linspace(0, k0 - 1, 8).astype(int))
    phi_mon = torch.as_tensor(_gaussian_rbf_np(
        np.log(tau[mon_idx][:, None] / tau[None, :]), eps), device=device)
    if gamma_eval_tau is not None:
        ge_tau = np.asarray(gamma_eval_tau, float)
        phi_eval = torch.as_tensor(_gaussian_rbf_np(
            np.log(ge_tau[:, None] / tau[None, :]), eps), device=device)
    else:
        phi_eval = torch.zeros((0, k0), dtype=torch.float64, device=device)
    return phi_mon.to(dtype), phi_eval.to(dtype)


def _run_sampler(sampler, entry, q0, chains, warmup, samples, cfg, gen,
                 timing, flat_args=None, metric=None, init_step_size=1.0,
                 init_traj_time=None):
    """Sample the (b*chains, D) rows q0: NUTS (``cfg`` a NUTSConfig), the
    flat-chain SHMC sampler (``flat_args`` = (spec, shared, targets)), the
    generic SHMC sampler or ChEES on the runner ``entry`` (a progcache
    ``Bound``: its value and gradient and its graphs' slot). ``metric``
    and ``init_step_size`` are per chain for NUTS ((R, D) or (R, D, D),
    (R,), or a shared dense (m_inv, chol) pair), per spectrum for SHMC
    and ChEES ((b, D), (b,)), as ChEES's ``init_traj_time`` (b,).
    Returns draws (b, C, S, D) and the info dict with a leading b axis,
    the SHMC and ChEES samplers' per-spectrum metric broadcast to every
    chain and a dense NUTS metric as (b, C, D, D)."""
    b = q0.shape[0] // chains
    if sampler in ("shmc", "chees"):
        if sampler == "chees":
            draws, info = sample_chees(entry.fn, q0, warmup, samples, cfg,
                                       chains, generator=gen,
                                       init_step_size=init_step_size,
                                       metric=metric,
                                       init_traj_time=init_traj_time,
                                       time_draws=timing,
                                       graphs=entry.graphs)
        elif flat_args is not None:
            spec, shared, tgt_rows = flat_args
            draws, info = sample_shmc_flat(
                spec, shared, tgt_rows, q0, warmup, samples, cfg, chains,
                generator=gen, metric=metric, init_step_size=init_step_size)
        else:
            draws, info = sample_shmc(entry.fn, q0, warmup, samples, cfg,
                                      chains, generator=gen,
                                      init_step_size=init_step_size,
                                      metric=metric, time_draws=timing,
                                      graphs=entry.graphs)
        info["inv_mass"] = info["inv_mass"][:, None, :].expand(-1, chains, -1)
        return draws, info
    draws, raw = sample_nuts(entry.fn, q0, warmup, samples, cfg,
                             generator=gen, metric=metric,
                             init_step_size=init_step_size,
                             time_draws=timing, graphs=entry.graphs)
    info = {k: _per_spectrum(raw[k], b, chains)
            for k in ("logp", "accept_prob", "diverging", "n_leapfrog",
                      "energy", "warmup_diverging")}
    info["step_size"] = raw["step_size"].reshape(b, chains)
    m_inv = raw["inv_mass"]
    d = q0.shape[1]
    if m_inv.ndim == 2:
        info["inv_mass"] = m_inv.reshape(b, chains, d)
    elif m_inv.shape[0] == 1:
        info["inv_mass"] = m_inv.expand(b * chains, d, d).reshape(
            b, chains, d, d)
    else:
        info["inv_mass"] = m_inv.reshape(b, chains, d, d)
    if timing:
        info["draw_s"] = raw["draw_s"]
        info["capture_s"] = raw["capture_s"]
    return _per_spectrum(draws, b, chains), info


def _add_traj_time(out, info, b_real):
    """A ChEES fit's adapted trajectory times, the state a warm start
    resumes from, beside the summary (``state_traj_time``, (b_real,))."""
    if "traj_time" in info:
        out["state_traj_time"] = info["traj_time"][:b_real].cpu().numpy()


def _summarize_blocks(cfg, data, draws, info, chains, samples, b_real,
                      phi_mon, phi_eval, monitor_thin: int = 0):
    """The posterior summary of the first ``b_real`` spectra, in blocks of
    _SUMMARY_BLOCK spectra (per-spectrum data sliced with the draws), as
    numpy arrays."""
    summarize = _make_summarize(cfg, chains, samples, monitor_thin)
    blocks = []
    for i in range(0, b_real, _SUMMARY_BLOCK):
        sl = slice(i, min(i + _SUMMARY_BLOCK, b_real))
        inf_b = {k: v[sl] for k, v in info.items() if k not in _TIMING_KEYS}
        blocks.append(summarize(group_data(data, sl), draws[sl], inf_b,
                                phi_mon, phi_eval))
    with span("summary/to_host"):
        return {k: torch.cat([blk[k] for blk in blocks]).cpu().numpy()
                for k in blocks[0]}


def _sampled_result(cfg, out, z_scales, dists_norm, tau, eps, basis,
                    n_eval=0):
    """BatchFitResult of a sample-mode summary: coefficients, bands, gamma
    bands, the posterior-predictive impedance and the monitor draws (with
    ``n_eval`` gamma columns) back in physical units."""
    diagnostics = _rescaled_diagnostics(cfg, out, z_scales, dists_norm)
    scale0 = _coef_scale(cfg, 0, z_scales)
    for k_ge in ("gamma_eval_mean", "gamma_eval_lo", "gamma_eval_hi"):
        if k_ge in diagnostics:
            diagnostics[k_ge] = diagnostics[k_ge] * scale0
    for k_z in ("z_hat_mean", "z_hat_std"):
        if k_z in diagnostics:
            diagnostics[k_z] = diagnostics[k_z] * z_scales[:, None]
    if "monitor_draws" in diagnostics:
        # Rinf, induc | sigma_res, alpha_prop, alpha_re, alpha_im (left in
        # the scaled space) | gamma at the eval taus (first distribution's
        # scale) | sigma_out (an impedance-space scale, like Rinf)
        md = diagnostics["monitor_draws"].copy()
        n_s = len(MONITOR_SCALARS)
        md[:, :, :2] *= z_scales[:, None, None]
        md[:, :, n_s:n_s + n_eval] *= scale0[:, None, :]
        md[:, :, n_s + n_eval:] *= z_scales[:, None, None]
        diagnostics["monitor_draws"] = md
    return BatchFitResult(
        coef=out["coef"] * scale0, r_inf=out["r_inf"] * z_scales,
        inductance=out["induc"] * z_scales,
        gamma_lo=out["coef_lo"] * scale0, gamma_hi=out["coef_hi"] * scale0,
        z_scales=z_scales, tau=tau, epsilon=eps, diagnostics=diagnostics,
        basis=basis)


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
             polish, mark, phases, mesh=None):
    """fit_spectra_batch(mode='optimize') on the padded, descending batch:
    L-BFGS from Stan-random restarts or the ridge seed, the Newton polish,
    and the result at the real rows. The starts are drawn for the whole
    batch on ``device``; with a ``mesh`` each shard solves its rows on its
    device (K2 building its A there) and the optima gather in row
    order."""
    b = Z_batch.shape[0]
    frequencies, tau, eps, cfg, data, dists_norm = _build_shared(
        frequencies, mode="optimize", dtype=dtype, device=device,
        **setup_kw)
    z_scales, targets = _scaled_targets(Z_batch, b_real, z_scale, dtype,
                                        device, dists_norm)
    gen = torch.Generator(device=device).manual_seed(int(random_seed))
    mark("setup")
    if init_from_ridge:
        iv = _ridge_seed(frequencies, Z_batch, b_real, z_scales, cfg, data,
                         targets, ridge_kw, dtype, device,
                         setup_kw["basis_freq"], setup_kw["epsilon"],
                         cfg.outliers, dists_norm, setup_kw["basis"], mesh)
        mark("ridge")
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen, batch_shape=(b,),
                                           init_values=iv))
    else:
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                           batch_shape=(b, n_restarts)))
    built = {str(device): data}

    def solve(sh):
        dev = sh.device
        if str(dev) not in built:
            built[str(dev)] = _build_shared(
                frequencies, mode="optimize", dtype=dtype, device=dev,
                **setup_kw)[4]
        dat = built[str(dev)]
        tgt = targets[sh.start:sh.stop].to(dev)
        x0 = q0[sh.start:sh.stop].to(dev)
        if init_from_ridge:
            entry = map_objective("fit_spectra_batch", cfg, dat, tgt,
                                  key=("lbfgs", max_iter))
            obj = entry.fn
            res = run_lbfgs(obj.value_and_grad, x0, max_iter=max_iter,
                            graphs=entry.graphs)
        else:
            entry = map_objective("fit_spectra_batch", cfg, dat,
                                  tgt.repeat_interleave(n_restarts, dim=0),
                                  key=("lbfgs", max_iter))
            res = run_lbfgs_restarts(entry.fn.value_and_grad, x0,
                                     max_iter=max_iter, graphs=entry.graphs)
            obj = MapObjective(cfg, dat, tgt)
        return res, obj

    def polish_rows(sh):
        # the L-BFGS cap binds before Stan-grade convergence on this
        # posterior; a damped Newton pass certifies the optimum
        res, obj = parts[sh.position]
        pol = newton_polish(obj.value_and_grad, obj.hessian, res.params)
        return pol._replace(n_iter=res.n_iter + pol.n_iter)

    def gather(results):
        if len(results) == 1:
            return results[0]
        return MapResult(*(torch.cat([r[i].to(device) for r in results])
                           for i in range(len(results[0]))))

    shards = _shard_plan(mesh, b, device)
    parts = run_shards(solve, shards)
    mark("lbfgs")
    n_lbfgs = gather([p[0] for p in parts]).n_iter
    if polish:
        res = gather(run_shards(polish_rows, shards))
        mark("polish")
    else:
        res = gather([p[0] for p in parts])
    result = _map_result(cfg, data, res, z_scales[:b_real], dists_norm,
                         tau, eps, setup_kw["basis"])
    if mesh is not None:
        result.diagnostics["shard_layout"] = mesh.layout(b)
    if phases is not None:
        result.diagnostics["phase_s"] = phases
        result.diagnostics["n_iter_lbfgs"] = n_lbfgs[:b_real].cpu().numpy(
        ).astype(np.float32)
    return result


def _map_result(cfg, data, res, z_scales, dists_norm, tau, eps, basis):
    """BatchFitResult of a MAP fit's optimum rows (the first len(z_scales)
    of ``res``): the constrained coefficients in physical units and each
    spectrum's objective, iteration count, gradient norm and certificate;
    no bands."""
    b_real = len(z_scales)
    c = constrain(cfg, data, unravel(cfg, res.params[:b_real]))

    def host(t):
        return t[:b_real].cpu().numpy()

    out = {"value": host(res.value),
           "n_iter": host(res.n_iter).astype(np.float32),
           "grad_norm": host(res.grad_norm),
           "converged": host(res.converged)}
    for i in range(1, len(cfg.dists)):
        out[f"coef_{i}"] = c[f"x_{i}"].cpu().numpy()
    return BatchFitResult(
        coef=c["x_0"].cpu().numpy() * _coef_scale(cfg, 0, z_scales),
        r_inf=c["Rinf"].cpu().numpy() * z_scales,
        inductance=c["induc"].cpu().numpy() * z_scales, gamma_lo=None,
        gamma_hi=None, z_scales=z_scales, tau=tau, epsilon=eps,
        diagnostics=_rescaled_diagnostics(cfg, out, z_scales, dists_norm),
        basis=basis)


def _ragged_setup(spectra, mode, basis_freq, epsilon, nonneg, outliers,
                  distributions, basis, sigma_min, ncp, dt, dev):
    """fit_spectra_ragged's batch on the device: the batch padded to a
    power of two (>= 8) with the first spectrum, each grid sorted
    descending and padded to a common multiple of 16 with its last
    frequency (masked out of the likelihood), the default basis, each
    spectrum's MAP-rule Z scale, and the posterior with per-spectrum A
    (b, 2 n_max, K), freq (b, n_max) and lik_mask (b, 2 n_max) over the
    distributions' shared bases and L. Returns (cfg, data, scaled targets
    (b, 2 n_max), z_scales (b,), the normalized distributions, (tau,
    epsilon, basis) of the first distribution)."""
    b_real = len(spectra)
    freqs = [np.sort(np.asarray(f, float))[::-1] for f, _ in spectra]
    zs = [np.asarray(z)[np.argsort(np.asarray(f, float))[::-1]]
          for f, z in spectra]
    b = max(8, 1 << (b_real - 1).bit_length())
    freqs += [freqs[0]] * (b - b_real)
    zs += [zs[0]] * (b - b_real)
    n_max = int(-(-max(len(f) for f in freqs) // 16) * 16)
    dists_norm = _normalize_distributions(distributions)
    f_hi = max(f.max() for f in freqs)
    f_lo = min(f.min() for f in freqs)
    if basis_freq is None:
        tmin = np.log10(1 / (2 * np.pi * f_hi)) - 1
        tmax = np.log10(1 / (2 * np.pi * f_lo)) + 1
        default_tau = np.logspace(tmin, tmax, int(10 * (tmax - tmin) + 1))
    else:
        default_tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
    freq_pad = np.stack([np.concatenate([f, np.full(n_max - len(f), f[-1])])
                         for f in freqs])
    mask = np.stack([np.concatenate([np.ones(len(f)),
                                     np.zeros(n_max - len(f))])
                     for f in freqs])
    z_scales = np.array([float(z_scale_for(dists_norm, z, fit_type="map"))
                         for z in zs])
    z_pad = np.stack([np.concatenate([z / s_, np.zeros(n_max - len(z))])
                      for z, s_ in zip(zs, z_scales)])

    stacks, dist_mats, first = [], {}, None
    for nm in sort_distributions(dists_norm):
        info = dists_norm[nm]
        bf = info.get("basis_freq", None)
        tau_d = (default_tau if bf is None
                 else 1.0 / (2 * np.pi * np.asarray(bf, float)))
        eps_d = info.get("epsilon", epsilon)
        eps_d = default_epsilon(tau_d) if eps_d is None else float(eps_d)
        basis_d = info.get("basis", basis)
        kw = dict(tau=tau_d, epsilon=eps_d, basis=basis_d,
                  dtype=torch.float64, device=dev)
        akw = dict(kernel=info.get("kernel", "DRT"),
                   dist_type=info["dist_type"],
                   symmetry=info.get("symmetry", "planar"),
                   bc=info.get("bc", "transmissive"),
                   ct=info.get("ct", False), k_ct=info.get("k_ct", None))
        # every spectrum's padded grid as one (b * n_max)-row grid
        a_re, a_im = (construct_A(freq_pad.reshape(-1), part, **kw, **akw)
                      .reshape(b, n_max, -1) for part in ("real", "imag"))
        stacks.append(torch.cat([a_re, a_im], dim=1))
        mats = {"A_re": a_re[0], "A_im": a_im[0]}
        f_coll = 1.0 / (2 * np.pi * tau_d)
        for o in (0, 1, 2):
            mats[f"L{o}"] = construct_L(f_coll, order=o, **kw)
        dist_mats[nm] = mats
        info["_tau"], info["_epsilon"] = tau_d, eps_d
        if first is None:
            first = (tau_d, eps_d, basis_d)
    cfg, data0 = build_posterior(
        dists_norm, dist_mats, freq_pad[0], z_pad[0], mode=mode,
        nonneg=nonneg, dtype=dt, ncp=ncp and mode == "sample",
        outliers=outliers, sigma_min=sigma_min, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev).to(dt)

    targets = t(np.concatenate([z_pad.real, z_pad.imag], axis=1))
    data = data0._replace(A=tuple(a.to(dt) for a in stacks),
                          freq=t(freq_pad), lik_mask=t(np.concatenate(
                              [mask, mask], axis=1)))
    return cfg, data, targets, z_scales, dists_norm, first


@recorded
def fit_spectra_ragged(spectra, mode: str = "sample", basis_freq=None,
                       epsilon=None, nonneg: bool = False,
                       outliers: bool = False, chains: int = 4,
                       warmup: int = 500, samples: int = 500,
                       max_iter: int = 2000, n_restarts: int = 2,
                       random_seed: int = 0, mesh=None,
                       max_tree_depth: int = 10, dtype=None,
                       distributions=None, ncp: bool = False,
                       unroll: int = 1, flat_tree: bool = False,
                       tree_scan: bool = False, scan_unroll: int = 1,
                       basis: str = "gaussian", gamma_eval_tau=None,
                       sigma_min: float = 0.002, sampler: str = "nuts",
                       chees_cfg=None, shmc_cfg=None, warm_start=None,
                       timing: bool = False, device=None) -> BatchFitResult:
    """Fit spectra measured on different frequency grids in one batch.

    ``spectra``: a list of (frequencies, Z) pairs. The batch is padded to a
    power of two (>= 8) by repeating the first spectrum; every grid is
    sorted descending and padded to a common multiple of 16 with its last
    frequency, the padding masked out of the likelihood. Every spectrum
    gets its own A matrices over shared per-distribution bases (a DRT's A
    for all spectra in one quadrature kernel launch per part) and the
    shared L matrices; ``basis_freq`` defaults to 10 ppd over the union of
    the measured ranges plus one decade each side. Each spectrum's Z scale
    is the MAP rule (``z_scale_for(fit_type='map')``) in both modes, as in
    the JAX package.

    ``mode='sample'``: NUTS (``sampler='nuts'``, per-chain step size and
    metric) or the generic SHMC sampler (``sampler='shmc'``,
    ``shmc_cfg``; one metric and pooled step size per spectrum) over the
    (B*chains, D) rows, then the summary of ``fit_spectra_batch``
    (``gamma_eval_tau`` bands, ESS, Rhat, the posterior-predictive
    impedance on each padded grid; no ``f_train``, so ``predict_Z_batch``
    recomputes). ``mode='optimize'``: L-BFGS from ``n_restarts`` random
    starts per spectrum, capped at ``max_iter``, no polish and no ridge
    seed, each spectrum keeping its best finite optimum; ``gamma_lo`` and
    ``gamma_hi`` are None. ``warm_start`` (sample mode) resumes from an
    earlier ragged fit of the same batch layout as ``fit_spectra_batch``
    does. The other arguments are ``fit_spectra_batch``'s.
    ``sampler='chees'`` runs ChEES (``chees_cfg``) as ``fit_spectra_batch``
    does, cold and warm. ``mesh`` shards the padded batch as
    ``fit_spectra_batch`` does, each shard's spectra with their own A,
    grids and masks copied to its device."""
    if mode not in ("sample", "optimize"):
        raise ValueError(f"Invalid mode {mode!r}; options are 'sample', "
                         "'optimize'")
    if mode == "sample":
        if sampler not in ("nuts", "chees", "shmc"):
            raise ValueError(f"Unknown sampler {sampler!r}; options are "
                             "'nuts', 'chees', 'shmc'")
        if sampler == "shmc":
            run_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
            run_cfg.validate()
            check_precision(mesh, run_cfg.precision)
        elif sampler == "chees":
            run_cfg = chees_cfg if chees_cfg is not None else ChEESConfig()
        else:
            run_cfg = NUTSConfig(max_depth=max_tree_depth, unroll=unroll,
                                 flat_tree=flat_tree, tree_scan=tree_scan,
                                 scan_unroll=scan_unroll)
            run_cfg.validate()
    dev = (resolve_device(device) if mesh is None
           else resolve_mesh_device(mesh, device))
    dt = resolve_dtype(dtype)
    mark, phases = _phase_clock(timing, dev)

    b_real = len(spectra)
    cfg, data, targets, z_scales, dists_norm, (tau, eps, first_basis) = \
        _ragged_setup(spectra, mode, basis_freq, epsilon, nonneg, outliers,
                      distributions, basis, sigma_min, ncp, dt, dev)
    b, n_max = data.freq.shape
    D = flat_dim(cfg, n_max)
    gen = torch.Generator(device=dev).manual_seed(int(random_seed))
    mark("setup")
    z_scales = z_scales[:b_real]
    shards = _shard_plan(mesh, b, dev)

    if mode == "optimize":
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                           batch_shape=(b, n_restarts)))

        def solve(sh):
            spec = slice(sh.start, sh.stop)
            dat = _to_device(_spectra_rows(data, spec), sh.device)
            entry = cached_value_and_grad(
                "fit_spectra_ragged", cfg, dat,
                targets[spec].to(sh.device).repeat_interleave(
                    n_restarts, dim=0),
                jacobian=False, density=log_density, key=("lbfgs", max_iter))
            vg = entry.fn

            def loss(q):
                lp, g = vg(q)
                return -lp, -g

            return run_lbfgs_restarts(loss, q0[spec].to(sh.device),
                                      max_iter=max_iter,
                                      graphs=entry.graphs)

        parts = run_shards(solve, shards)
        res = parts[0] if len(parts) == 1 else MapResult(*(
            torch.cat([r[i].to(dev) for r in parts])
            for i in range(len(parts[0]))))
        mark("lbfgs")
        result = _map_result(cfg, data, res, z_scales, dists_norm, tau, eps,
                             first_basis)
    else:
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                           batch_shape=(b, chains)))
        q0 = q0.reshape(b * chains, D).contiguous()
        metric, init_eps, form, init_traj = None, 1.0, "diag", None
        if warm_start is not None:
            warm = _warm_state(warm_start, cfg, b_real, b, chains,
                               ragged=True)
            q0, run_cfg, metric, init_eps = _warm_run(sampler, run_cfg, warm,
                                                      dt, dev)
            if sampler == "chees":
                init_traj = _warm_traj_time(warm_start, b, dt, dev,
                                            ragged=True)
            if metric.ndim == 3:
                form = "dense_rows"
        budget = ("warm-chees" if warm_start is not None else "chees",
                  chains, warmup, samples)
        job = _SampleJob(
            tag="fit_spectra_ragged", sampler=sampler, cfg=cfg,
            chains=chains, samples=samples, b_real=b_real, timing=timing,
            flat=False, density=log_density, monitor_thin=0,
            random_seed=random_seed, phi=(tau, eps, gamma_eval_tau, dt))
        rows = run_shards(lambda sh: _ShardRows(
            job, sh, data, targets, q0, gen, metric, init_eps, init_traj),
            shards)
        run_shards(lambda sh: rows[sh.position].sample(
            run_cfg, warmup, form, budget), shards)
        mark("sample")
        out, info = _gather_parts(run_shards(
            lambda sh: rows[sh.position].summarize(), shards))
        mark("summary")
        result = _sampled_result(cfg, out, z_scales, dists_norm, tau, eps,
                                 first_basis)
        result.diagnostics["state_cfg"] = cfg
        if sampler == "shmc":
            result.diagnostics["shmc_route"] = _shmc_route(False, run_cfg)
            result.diagnostics["precision"] = run_cfg.precision
        if timing:
            for k in _TIMING_KEYS:
                if k in info:
                    result.diagnostics[k] = np.asarray(info[k])
    if mesh is not None:
        result.diagnostics["shard_layout"] = mesh.layout(b)
    if timing:
        result.diagnostics["phase_s"] = phases
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

# reduced-precision ('high') matmul gradient-discrepancy probe: relative
# L2 error of the log-density gradient under the reduced products (bf16x3
# on a TPU in the JAX package, tf32x3 on CUDA here) vs true-f32 ones,
# evaluated at the chains' final positions; recorded under the JAX
# package's key diagnostics['bf16x3_grad_err'] for every precision='high'
# generic SHMC fit on a CUDA device. The JAX package measured across the full committed-reference sweep
# (paper_batch_hmc_full_shmc.csv): the raw endpoint discrepancy is
# CONFOUNDED by posterior sharpness (healthy noiseless cells reach 0.27
# while the 2RC bf16x3-regression cells sit at 0.013-0.036), so it is NOT
# a default escalation gate (tol=inf = opt-in via
# escalate_gate=dict(bf16x3_tol=...)); the ENFORCED guard is the
# deterministic regime warning below (long trajectories / strict budgets
# — exactly where the 2RC n128-bf16x3 regression appeared,
# paper_batch_hmc_2rc_n128.csv: 8/10 vs f32 10/10).
BF16X3_GRAD_TOL = np.inf
BF16X3_WARN_STEPS = 64            # n_steps above which 'high' warns
BF16X3_WARN_SAMPLES = 400         # samples above which 'high' warns


def tf32x3_grad_err(cfg, data, targets, q_state, density=None):
    """The reduced-precision probe: per spectrum, the relative L2
    discrepancy of grad(log density) under tf32x3 ('high') against true
    fp32 ('highest') products, the max over the probe points (every
    chain's final state, ``q_state`` (b, C, D)); autograd of ``density``
    (default log_density) with the Jacobian, as the JAX package's probe
    takes jax.grad. On the CPU both precisions are one product and the
    probe reads 0. Returns (b,) numpy."""
    b, chains, dim = q_state.shape
    vg = posterior_value_and_grad(cfg, data,
                                  targets.repeat_interleave(chains, dim=0),
                                  jacobian=True, density=density)
    q = q_state.reshape(b * chains, dim)
    with precise_matmuls("high"):
        _, g_hi = vg(q)
    with precise_matmuls("highest"):
        _, g_f = vg(q)
    err = (torch.linalg.norm(g_hi - g_f, dim=1)
           / (torch.linalg.norm(g_f, dim=1) + 1e-30))
    return err.reshape(b, chains).max(dim=1).values.cpu().numpy()


def _tf32x3_guard(diagnostics, cfg, data, targets, b, b_real, sh_cfg,
                  samples):
    """The JAX package's reduced-precision guard for a precision='high'
    generic SHMC fit: ``diagnostics['bf16x3_grad_err']`` from the probe
    at the chains' final states (an escalation gate only through
    ``escalate_gate=dict(bf16x3_tol=...)``) and, outside the verified
    screening regime (more than BF16X3_WARN_STEPS leapfrogs a draw or
    BF16X3_WARN_SAMPLES draws), a warning. On CUDA the reduced form is
    tf32x3."""
    qp = torch.as_tensor(_pad_rows(np.asarray(diagnostics["state_q"]), b),
                         device=targets.device).to(targets.dtype)
    err = tf32x3_grad_err(cfg, data, targets, qp)[:b_real]
    diagnostics["bf16x3_grad_err"] = err
    if sh_cfg.n_steps > BF16X3_WARN_STEPS or samples > BF16X3_WARN_SAMPLES:
        warnings.warn(
            f"precision='high' (tf32x3 matmuls on CUDA) at n_steps="
            f"{sh_cfg.n_steps}/samples={samples} is outside the verified "
            "screening regime: on sharp posteriors the reduced-precision "
            "arm cost the JAX package 0.01-0.02*Rp at long trajectories "
            "(the 2RC n128 regression, 8/10 vs f32 10/10); use "
            "SHMCConfig(precision='highest') for final runs (measured grad "
            f"discrepancy p50 {float(np.median(err)):.1e}, max "
            f"{float(err.max()):.1e})")


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


# (spectrum, lambda) rows of one Re-Im cross-validation block: bounds the
# block's replicated design (rows, N, K) and QP matrices (rows, K, K), ~6
# GB at the main path's 1024 spectra x 31 lambdas in float32 (one block:
# a block's QPs wait for its slowest row, so fewer blocks wait less)
_CV_ROWS = 32768


def ridge_fit_spectra_batch(frequencies, Z_batch, basis_freq=None,
                            epsilon=None, penalty: str = "integral",
                            hyper_lambda: bool = True,
                            hl_beta: float = 2.5, lambda_0: float = 1e-2,
                            reg_ord=2, nonneg: bool = True,
                            weights="modulus", max_iter: int = 20,
                            xtol: float = 1e-3, mesh=None,
                            basis: str = "gaussian", dtype=None,
                            cv_lambdas=None, hyper_weights: bool = False,
                            hw_beta: float = 2.0, hw_wbar=1.0,
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

    ``cv_lambdas``: an (L,) grid of lambda_0 values selected per spectrum
    by Re-Im cross-validation (``lambda_0`` is then ignored): at every
    grid value a real-part fit predicts the imaginary part and an
    imaginary-part fit the real part, each after its part-specific offset
    recovery (the imaginary fit cannot see R_inf, the real fit the
    inductance); the spectrum takes the grid index of the least summed
    squared prediction error and its both-part fit there. The real and
    the imaginary fits of every (spectrum, lambda) pair run as one batch
    of rows each, in blocks of at most ``_CV_ROWS`` rows. Diagnostics gain
    ``cv_lambda`` (B,) and ``cv_recv`` / ``cv_imcv`` / ``cv_totcv`` (B, L);
    a warning names the spectra that selected a grid boundary.

    ``hyper_weights=True`` (with ``hyper_lambda=False``): the
    Effat-Ciucci outlier-robust ridge, whose point weights iterate from
    the prior means ``hw_wbar`` (the weights vocabulary; ``weights`` is
    unused) with strength ``hw_beta``; the fitted weights land in
    ``diagnostics['weights_re'/'weights_im']`` (B, N) in the caller's
    point order (small values mark outliers).

    ``mesh``: every shard fits its contiguous range of spectra on its
    device (its own A from the quadrature kernel; a per-spectrum weights
    array goes with its spectra) and the results join in order, with
    ``diagnostics['shard_layout']``."""
    if hyper_weights and hyper_lambda:
        raise ValueError("hyper_lambda and hyper_weights fits cannot be "
                         "combined; pass hyper_lambda=False")
    if hyper_weights and cv_lambdas is not None:
        raise ValueError("cv_lambdas is not supported with hyper_weights")
    kw = dict(basis_freq=basis_freq, epsilon=epsilon, penalty=penalty,
              hyper_lambda=hyper_lambda, hl_beta=hl_beta, lambda_0=lambda_0,
              reg_ord=reg_ord, nonneg=nonneg, max_iter=max_iter, xtol=xtol,
              basis=basis, dtype=dtype, cv_lambdas=cv_lambdas,
              hyper_weights=hyper_weights, hw_beta=hw_beta)
    Z_batch = np.asarray(Z_batch)
    b = Z_batch.shape[0]
    if mesh is None:
        result, n_boundary = _ridge_rows(frequencies, Z_batch, weights,
                                         hw_wbar, resolve_device(device),
                                         **kw)
    else:
        dev = resolve_mesh_device(mesh, device)

        def rows(w, sh):
            # a per-spectrum (B, N) weights array goes with its spectra
            if np.ndim(w) == 2:
                return np.asarray(w)[sh.start:sh.stop]
            return w

        shards = [sh for sh in mesh.shards(b) if sh.stop > sh.start]
        parts = run_shards(lambda sh: _ridge_rows(
            frequencies, Z_batch[sh.start:sh.stop], rows(weights, sh),
            rows(hw_wbar, sh), sh.device, **kw), shards)
        result = _join_results([r for r, _ in parts])
        n_boundary = sum(n for _, n in parts)
        result.diagnostics["shard_layout"] = mesh.layout(b)
    if n_boundary:
        warnings.warn(
            f"Re-Im CV selected a boundary lambda for {n_boundary} "
            "spectra; re-run with an expanded cv_lambdas range for an "
            "accurate estimate.")
    return result


def _join_results(parts):
    """The BatchFitResults of consecutive row ranges as one: the
    per-spectrum fields and diagnostics joined in order, everything else
    the first's."""
    first = parts[0]
    if len(parts) == 1:
        return first

    def cat(name):
        vals = [getattr(p, name) for p in parts]
        return None if vals[0] is None else np.concatenate(vals)

    diag = {}
    for k, v in first.diagnostics.items():
        vals = [p.diagnostics[k] for p in parts]
        if all(isinstance(x, np.ndarray) and x.ndim >= 1
               and x.shape[0] == p.coef.shape[0]
               for x, p in zip(vals, parts)):
            diag[k] = np.concatenate(vals)
        else:
            diag[k] = v
    return first._replace(coef=cat("coef"), r_inf=cat("r_inf"),
                          inductance=cat("inductance"),
                          gamma_lo=cat("gamma_lo"), gamma_hi=cat("gamma_hi"),
                          z_scales=cat("z_scales"), diagnostics=diag)


def _ridge_rows(frequencies, Z_batch, weights, hw_wbar, dev, basis_freq,
                epsilon, penalty, hyper_lambda, hl_beta, lambda_0, reg_ord,
                nonneg, max_iter, xtol, basis, dtype, cv_lambdas,
                hyper_weights, hw_beta):
    """ridge_fit_spectra_batch on the spectra ``Z_batch`` on ``dev``:
    (result, the number of spectra whose CV chose a grid boundary)."""
    n_boundary = 0
    dt = resolve_dtype(dtype)
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
    # with hyper_weights the point weights evolve from the prior means
    # hw_wbar and the likelihood weights are unused
    w_re, w_im = _format_weights_batch(Zs, hw_wbar if hyper_weights
                                       else weights)
    lb = np.zeros(k) if nonneg else np.concatenate([np.zeros(2),
                                                    np.full(kb, -10.0)])
    ub = np.full(k, np.inf)
    cfg = HyperLambdaConfig(part="both", penalty=penalty, n_fixed=2,
                            max_iter=max_iter)

    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.ascontiguousarray(a, float), device=dev)
        return a.to(dt)

    A_re_t, A_im_t, T_re, T_im = t(A_re), t(A_im), t(Zs.real), t(Zs.imag)
    wr, wi = t(w_re), t(w_im)
    data = RidgeData(WA_re=wr[:, :, None] * A_re_t,
                     WA_im=wi[:, :, None] * A_im_t, WT_re=wr * T_re,
                     WT_im=wi * T_im, L2_base=t(torch.stack(L2_base)),
                     L_ops=t(torch.stack(L_ops)),
                     L1_vec=torch.zeros(k, dtype=dt, device=dev),
                     reg_frac=t(frac), lb=t(lb), ub=t(ub))

    def solve_at(scfg, dat, lam):
        if hyper_lambda:
            return run_hyper_lambda(
                scfg, dat, torch.full((k,), 1e-6, dtype=dt, device=dev),
                torch.full((3,), float(hl_beta), dtype=dt, device=dev), lam,
                xtol=xtol)
        return run_ordinary_ridge(scfg.part, dat, lam)

    diagnostics = {}
    if hyper_weights:
        res = run_hyper_weights("both", data, A_re_t, A_im_t, T_re, T_im,
                                lambda_0, hw_beta, wr, wi,
                                max_iter=max_iter, xtol=xtol)
        # the caller's point order
        inv_order = np.argsort(f_order)
        diagnostics["weights_re"] = res.weights_re.cpu().numpy()[
            :, inv_order]
        diagnostics["weights_im"] = res.weights_im.cpu().numpy()[
            :, inv_order]
    elif cv_lambdas is None:
        res = solve_at(cfg, data, lambda_0)
    else:
        grid = t(np.asarray(cv_lambdas, float))
        recv, imcv = _cv_errors(cfg, data, grid, A_re_t, A_im_t, T_re, T_im,
                                solve_at)
        idx = torch.argmin(recv + imcv, dim=1)
        res = solve_at(cfg, data, grid[idx])
        idx = idx.cpu().numpy()
        recv, imcv = recv.cpu().numpy(), imcv.cpu().numpy()
        # the caller's grid value (not its rounding to the fit's dtype)
        diagnostics.update(cv_lambda=np.asarray(cv_lambdas, float)[idx],
                           cv_recv=recv, cv_imcv=imcv, cv_totcv=recv + imcv)
        n_boundary = int(np.sum((idx == 0) | (idx == len(grid) - 1)))
    coefs = res.coef.cpu().numpy() * z_scales[:, None]
    diagnostics.update(n_iter=res.n_iter.cpu().numpy(),
                       converged=res.converged.cpu().numpy())
    return BatchFitResult(
        coef=coefs[:, 2:], r_inf=coefs[:, 0], inductance=coefs[:, 1] * 1e-4,
        gamma_lo=None, gamma_hi=None, z_scales=z_scales, tau=tau, epsilon=eps,
        diagnostics=diagnostics, basis=basis), n_boundary


def _cv_errors(cfg, data, grid, A_re, A_im, T_re, T_im, solve_at):
    """Held-out prediction errors of every spectrum at every grid lambda,
    (B, L) each: the real-part fit's squared error on the imaginary part
    (imcv) and the imaginary-part fit's on the real part (recv),
    unweighted, after the part-specific offset recovery. Rows are
    (spectrum, lambda) pairs, spectrum-major, in blocks of _CV_ROWS."""
    b, n_lam = T_re.shape[0], grid.shape[0]
    per_block = max(1, _CV_ROWS // n_lam)
    cfg_re, cfg_im = cfg._replace(part="real"), cfg._replace(part="imag")
    bvec = A_im[:, 1]
    recv, imcv = [], []
    for i in range(0, b, per_block):
        sl = torch.arange(i, min(i + per_block, b),
                          device=T_re.device).repeat_interleave(n_lam)
        rows = ridge_rows(data, sl)
        lam = grid.repeat(len(sl) // n_lam)
        coef_r = solve_at(cfg_re, rows, lam).coef
        coef_i = solve_at(cfg_im, rows, lam).coef
        t_re, t_im = T_re[sl], T_im[sl]
        coef_i[:, 0] = (t_re - coef_i[:, 2:] @ A_re[:, 2:].T).mean(dim=1)
        zi_resid = t_im - coef_r[:, 2:] @ A_im[:, 2:].T
        coef_r[:, 1] = (zi_resid @ bvec) / (bvec @ bvec)
        imcv.append(((t_im - coef_r @ A_im.T) ** 2).sum(dim=1))
        recv.append(((t_re - coef_i @ A_re.T) ** 2).sum(dim=1))
    return (torch.cat(recv).reshape(b, n_lam),
            torch.cat(imcv).reshape(b, n_lam))


def drift_pick(values):
    """Each problem's winning row of (P, 1 + n) L-BFGS values: column 0 is
    the seeded start, columns 1.. the random restarts. The best finite
    restart (the first on ties) against the seeded row, which wins ties;
    a NaN value never beats a finite one. Returns (P,) column indices."""
    v = torch.where(torch.isfinite(values), values, math.inf)
    if v.shape[1] == 1:
        return torch.zeros(v.shape[0], dtype=torch.long, device=v.device)
    ib = 1 + torch.argmin(v[:, 1:], dim=1)
    rv = torch.gather(v, 1, ib[:, None])[:, 0]
    return torch.where(v[:, 0] <= rv, torch.zeros_like(ib), ib)


def _median_last(x):
    """Median over the last axis, averaging the two middle values of an
    even count (jnp.median's rule; torch.median returns the lower)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def drift_data(frequencies, times, A_re, A_im, L, targets, tau,
               sigma_min, inductance_scale, min_tau_drift, max_tau_drift,
               dtype, device):
    """DriftData on ``device`` in ``dtype`` from the matrices (tensors or
    numpy) and the per-row (or one) scaled targets."""
    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.array(a, dtype=float), device=device)
        return a.to(device=device, dtype=dtype)

    times = np.asarray(times, float)
    return DriftData(
        A_re=t(A_re), A_im=t(A_im), L=t(L), Z=t(targets),
        freq=t(frequencies), times=t(times), sigma_min=t(sigma_min),
        ups_alpha=t(0.05), ups_beta=t(0.1), induc_scale=t(inductance_scale),
        tau_bounds=t([min_tau_drift, max_tau_drift]),
        tau2_bounds=t([max(min_tau_drift, 500.0), max_tau_drift]),
        rq_tau_bounds=t([tau.min(), tau.max()]), k_bounds=t([1e-4, 1.0]),
        t_max=t(times.max()), t_min=t(times.min()))


@recorded
def drift_fit_spectra_batch(frequencies, times, Z_batch, drift_model="x1",
                            basis_freq=None, epsilon=None,
                            nonneg: bool = False, sigma_min: float = 0.002,
                            max_iter: int = 2000, random_seed: int = 0,
                            inductance_scale: float = 1.0,
                            init_from_ridge: bool = True, n_restarts: int = 2,
                            min_tau_drift: float = 200.0,
                            max_tau_drift: float = 10000.0, mesh=None,
                            basis: str = "gaussian", dtype=None,
                            distributions=None, timing: bool = False,
                            device=None) -> BatchFitResult:
    """Batched MAP fits of time-evolving spectra: B cells measured on the
    same frequency sweep schedule (shared per-point measurement times),
    the fleet form of ``Inverter.drift_map_fit``.

    ``times``: measurement time of each frequency point (len ==
    len(frequencies), seconds), shared by the batch. Measurement order is
    kept (not sorted to descending frequency), so times stay aligned.
    ``distributions``: an optional single-entry mini-DSL dict (drift fits
    take one distribution).

    Each cell's start is seeded from one batched hyper-lambda ridge pass
    (x0/x1, R_inf, inductance; a series DRT only: any other distribution
    warns and starts from neutral values) with the other parameters drawn
    at random, plus ``n_restarts`` random starts; all B x (1 +
    n_restarts) rows run as one batch through the L-BFGS of
    infer/map.py (no polish), and each cell keeps its best finite row,
    the seeded one on ties. A DRT's A comes from the quadrature kernel on
    a CUDA device, in measurement order.

    Returns a BatchFitResult whose ``coef``/``r_inf``/``inductance`` are
    the time-zero (or final, for *-from-final models) values;
    ``diagnostics['drift']`` carries every rescaled drift parameter,
    ``['value']``/``['n_iter']`` each cell's optimizer state and
    ``['median_rel_resid']`` the median relative impedance residual of
    its fitted trajectory; with ``timing``, ``['phase_s']`` (setup /
    ridge / lbfgs / result seconds, closed by a device synchronize),
    ``['n_iter_rows']`` every row's iterations and, as
    ``fit_spectra_batch`` records them, ``['spans']`` and
    ``['counters']``. ``mesh``: the ridge seed
    runs sharded, the starts are drawn for the whole batch, and every
    shard runs its cells' rows through L-BFGS on its device (its own A),
    with ``diagnostics['shard_layout']``."""
    if drift_model not in DRIFT_MODELS:
        raise ValueError(f"Invalid drift_model {drift_model!r}. Options "
                         f"are {DRIFT_MODELS}")
    frequencies = np.asarray(frequencies, float)
    times = np.asarray(times, float)
    if len(times) != len(frequencies):
        raise ValueError("times must have same length as frequencies")
    Z_batch = np.asarray(Z_batch)
    if Z_batch.ndim != 2 or Z_batch.shape[1] != len(frequencies):
        raise ValueError(f"Z_batch must be (B, {len(frequencies)})")
    if distributions is None:
        distributions = {"DRT": {"kernel": "DRT", "dist_type": "series"}}
    if len(distributions) != 1:
        raise ValueError("drift fits support a single distribution")
    dev = (resolve_device(device) if mesh is None
           else resolve_mesh_device(mesh, device))
    dt = resolve_dtype(dtype)
    mark, phases = _phase_clock(timing, dev)
    Z_batch, b_real = _pad_pow2(Z_batch)
    b, n = Z_batch.shape

    dist_name, info = next(iter(distributions.items()))
    info = dict(info)
    if info.get("kernel", "DRT") == "DRT":
        info.setdefault("dist_type", "series")
    else:
        info.setdefault("dist_type", "parallel")
        info.setdefault("symmetry", "planar")
        info.setdefault("bc", "blocking")
    info.setdefault("ct", False)
    dist_type = info["dist_type"]

    if basis_freq is None:
        tau = get_tau_basis(np.sort(frequencies)[::-1])
    else:
        tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
    eps = default_epsilon(tau) if epsilon is None else float(epsilon)
    f_coll = 1.0 / (2 * np.pi * tau)
    f64 = dict(dtype=torch.float64, device=dev)
    kw = dict(tau=tau, basis=basis, epsilon=eps,
              kernel=info.get("kernel", "DRT"), dist_type=dist_type,
              symmetry=info.get("symmetry", "planar"),
              bc=info.get("bc", "transmissive"), ct=info["ct"],
              k_ct=info.get("k_ct", None), **f64)

    def matrices(device):
        # A from the quadrature kernel on each device of a mesh; the
        # mode-scaled L stack of the single-spectrum drift fit
        dkw = dict(kw, device=device)
        L = torch.stack([1.5 * s * construct_L(
            f_coll, tau=tau, basis=basis, epsilon=eps, order=o,
            dtype=torch.float64, device=device)
            for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])
        return (construct_A(frequencies, "real", **dkw),
                construct_A(frequencies, "imag", **dkw), L)

    A_re, A_im, L = matrices(dev)

    # scale with the normalized distribution so an under-specified DDT
    # gets the 'blocking' default the Inverter applies
    z_scales = np.asarray(z_scale_for({dist_name: info}, Z_batch, "map"))
    Zs = Z_batch / z_scales[:, None]
    targets = np.concatenate([Zs.real, Zs.imag], axis=1)     # (B, 2N)
    cfg = DriftConfig(drift_model=drift_model, dist_type=dist_type,
                      nonneg=nonneg, K=len(tau))
    data = drift_data(frequencies, times, A_re, A_im, L, targets, tau,
                      sigma_min, inductance_scale, min_tau_drift,
                      max_tau_drift, dt, dev)
    mark("setup")

    pos_x = nonneg or dist_type == "parallel"
    if init_from_ridge and (info.get("kernel", "DRT") != "DRT"
                            or dist_type != "series"):
        # the batched ridge fits a series DRT, whose coefficients live in
        # another space than this distribution's
        warnings.warn(
            "init_from_ridge seeds from a series-DRT ridge fit, which does "
            "not match this distribution's coefficient space; using neutral "
            "inits instead — consider raising n_restarts.")
        init_from_ridge = False
    if init_from_ridge:
        rr = ridge_fit_spectra_batch(
            frequencies, Z_batch, basis_freq=f_coll, penalty="integral",
            hyper_lambda=True, lambda_0=1.0, hl_beta=5.0, weights="modulus",
            basis=basis, dtype=dt, device=dev, mesh=mesh)
        x_r = rr.coef / z_scales[:, None]
        rinf_r = np.clip(rr.r_inf / z_scales, 1e-6, None)
        induc_r = np.clip(rr.inductance / z_scales, 1e-10, None)
        iv_x = np.log(np.clip(x_r, 1e-10, None)) if pos_x else x_r
        iv_rinf = np.log(rinf_r / 100.0)
        iv_induc = np.log(induc_r)
        mark("ridge")
    else:
        iv_x = np.zeros((b, len(tau)))
        iv_rinf = np.full(b, np.log(1e-2))
        iv_induc = np.full(b, np.log(1e-10))
    iv = {"Rinf0_raw": iv_rinf, "induc_raw": iv_induc, "dRinf_raw": 0.0,
          "x0": iv_x, "x1": iv_x, "dx": np.full_like(iv_x, 1e-3),
          "x2": np.full_like(iv_x, 1e-3)}

    gen = torch.Generator(device=dev).manual_seed(int(random_seed))
    q0 = ravel_drift(cfg, init_drift_params(cfg, data, gen, batch_shape=(b,),
                                            init_values=iv))[:, None]
    if n_restarts > 0:
        q0 = torch.cat([q0, ravel_drift(cfg, init_drift_params(
            cfg, data, gen, batch_shape=(b, n_restarts)))], dim=1)
    rows = q0.shape[1]

    def solve(sh):
        # each shard's rows of (cell, start) through L-BFGS on its device,
        # the cells' winning rows, their drift trajectories and residuals
        d = sh.device
        dat = data
        if d != dev:
            dat = drift_data(frequencies, times, *matrices(d), targets, tau,
                             sigma_min, inductance_scale, min_tau_drift,
                             max_tau_drift, dt, d)
        dat = dat._replace(Z=dat.Z[sh.start:sh.stop])
        bs = sh.stop - sh.start
        entry = _drift_loss("drift_fit_spectra_batch", cfg, dat._replace(
            Z=dat.Z.repeat_interleave(rows, dim=0)), key=("lbfgs", max_iter))
        res = run_lbfgs(entry.fn, q0[sh.start:sh.stop].to(d).reshape(
            bs * rows, -1), max_iter=max_iter, graphs=entry.graphs)
        pick = (torch.arange(bs, device=d) * rows
                + drift_pick(res.value.reshape(bs, rows)))
        c = constrain_drift(cfg, dat, unravel_drift(cfg, res.params[pick]))
        # reconstruction quality of the fitted drift trajectory (the
        # single-spectrum drift test's gate)
        pred = predict_drift_target(cfg, dat, c)
        zmod = torch.sqrt(dat.Z[:, :n] ** 2 + dat.Z[:, n:] ** 2)
        resid = torch.sqrt((pred[:, :n] - dat.Z[:, :n]) ** 2
                           + (pred[:, n:] - dat.Z[:, n:]) ** 2)
        med = _median_last(resid / torch.clamp_min(zmod, 1e-30))
        return ({k: v.cpu() for k, v in c.items()}, res.value[pick].cpu(),
                res.n_iter[pick].cpu(), med.cpu(),
                res.n_iter.reshape(bs, rows).cpu())

    parts = run_shards(solve, _shard_plan(mesh, b, dev))
    mark("lbfgs")

    def cat(i):
        return torch.cat([p[i] for p in parts])

    c = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    value, n_it_all, med_resid, n_iter_rows = cat(1), cat(2), cat(3), cat(4)

    def host(t):
        return t[:b_real].cpu().numpy()

    c = {k: host(v) for k, v in c.items()}
    value = host(value)
    n_it = host(n_it_all).astype(np.float32)
    med_resid = host(med_resid)
    z_scales = z_scales[:b_real]
    mark("result")

    # rescale to impedance units: offsets series-scaled, coefficient
    # vectors by the distribution type (Inverter._rescale_coef)
    def rescale_vec(v):
        if dist_type == "parallel":
            return v / z_scales[:, None]
        return v * z_scales[:, None]

    drift = {}
    for k, v in c.items():
        if k in ("x0", "x1", "dx", "x2"):
            drift[k] = rescale_vec(v)
        elif k in ("Rinf_0", "delta_Rinf", "induc", "sigma_res", "R_rq"):
            drift[k] = v * z_scales
        elif not k.startswith(("ups_", "d_strength_")):
            drift[k] = v          # time constants, exponents, error alphas
    static_key = "x1" if drift_model.endswith("from-final") else "x0"
    diagnostics = {"value": value, "n_iter": n_it,
                   "median_rel_resid": med_resid,
                   "drift_model": drift_model, "drift": drift}
    if mesh is not None:
        diagnostics["shard_layout"] = mesh.layout(b)
    if timing:
        diagnostics["phase_s"] = phases
        diagnostics["n_iter_rows"] = host(n_iter_rows)
    return BatchFitResult(
        coef=drift.get(static_key, drift.get("x0")),
        r_inf=drift["Rinf_0"], inductance=drift["induc"],
        gamma_lo=None, gamma_hi=None, z_scales=z_scales, tau=tau,
        epsilon=eps, diagnostics=diagnostics, basis=basis)


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
