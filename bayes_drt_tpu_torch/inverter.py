"""Inverter: the single-spectrum user surface (port of
bayes_drt_tpu/inverter.py, the reference's ``Inverter``).

Host code (numpy) orchestrates; the numerics run in torch on the
Inverter's device: matrix construction (ops/, a DRT's A through the
hand-written quadrature kernel on a CUDA device), the box-QP ridge
(infer/ridge.py), MAP by L-BFGS and the Newton polish (infer/map.py) and
NUTS, SHMC or ChEES sampling (infer/nuts.py, infer/chees.py), each
replayed as CUDA graphs on a CUDA device. The fit state (coefficients,
matrices, error structure, the Stan-style results and diagnostics) holds
numpy arrays and Python scalars only, so ``save_fit_data`` of either
package loads into the other.

Drift fits (models/drift.py) and HN peak fits (peaks.py, the LM of
infer/lsq.py) run on the Inverter's device too. The plotting wrappers
draw through viz/plotting.py (matplotlib, imported when called).
"""

from __future__ import annotations

import warnings
from copy import deepcopy

import numpy as np
import torch

from . import peaks
from ._numerics import resolve_device, resolve_dtype
from .convert import inverter_state_from_numpy
from .infer import diagnostics as mcmc_diagnostics
from .infer.chees import ChEESConfig, SHMCConfig, sample_chees, sample_shmc
from .infer.map import MapResult, newton_polish, run_lbfgs, run_lbfgs_restarts
from .infer.nuts import NUTSConfig, sample_nuts
from .infer.ridge import (HyperLambdaConfig, RidgeData, run_hyper_lambda,
                          run_hyper_weights, run_ordinary_ridge)
from .models.build import build_posterior, sort_distributions, z_scale_for
from .models.drift import (DRIFT_MODELS, DriftConfig, constrain_drift,
                           drift_log_density, drift_value_and_grad,
                           init_drift_params, predict_drift_target,
                           ravel_drift, unravel_drift)
from .models.posterior import (PosteriorData, constrain, init_unconstrained,
                               predict_target, ravel, sigma_tot, unravel)
from .ops.basis import get_basis_func
from .ops.matrices import (construct_A, construct_L, construct_M,
                           default_epsilon, get_tau_basis)
from .parallel.batch import (MapObjective, _drift_loss,
                             _format_weights_batch, _sampler_entry,
                             drift_data, drift_pick, map_objective)
from .profiling import StageTimer
from .utils import check_equality, get_outlier_thresh, r2_score, rel_round

class Inverter:
    """EIS -> DRT/DDT inversion engine (the reference's ``Inverter``).

    ``device`` and ``dtype`` (keyword-only) place its numerics: CUDA and
    float32 unless the caller names others (``device='cpu'``)."""

    def __init__(self, basis_freq=None, basis="gaussian", epsilon=None,
                 fit_inductance=True, distributions=None, *, device=None,
                 dtype=None):
        if distributions is None:
            distributions = {"DRT": {"kernel": "DRT"}}
        self._device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self._recalc_mat = True
        self.distribution_matrices = {}
        self.set_basis_freq(basis_freq)
        self.set_basis(basis)
        self.set_epsilon(epsilon)
        self.set_fit_inductance(fit_inductance)
        self.set_distributions(distributions)
        self._cached_distributions = deepcopy(self.distributions)
        self.f_train = np.array([0.0])
        self.Z_train = None
        self.t_train = None
        self.f_pred = None
        self.prediction_matrices = {}
        self._Z_scale = 1.0
        self._init_params = {}
        self.distribution_fits = {}
        self.error_fit = {}
        self._iter_history = None
        self.fit_type = None
        self.cv_result = None
        self._sample_result = None
        self._opt_result = None
        self.sample_diagnostics = None

    # --- configuration properties -----------------------------------------

    def set_basis_freq(self, basis_freq):
        self._basis_freq = (None if basis_freq is None
                            else np.asarray(basis_freq, float))
        self._recalc_mat = True
        self.f_pred = None

    def get_basis_freq(self):
        return self._basis_freq

    basis_freq = property(get_basis_freq, set_basis_freq)

    def set_basis(self, basis):
        get_basis_func(basis)  # validate
        self._basis = basis
        self._recalc_mat = True
        self.f_pred = None

    def get_basis(self):
        return self._basis

    basis = property(get_basis, set_basis)

    def set_epsilon(self, epsilon):
        self._epsilon = epsilon
        self._recalc_mat = True
        self.f_pred = None

    def get_epsilon(self):
        return self._epsilon

    epsilon = property(get_epsilon, set_epsilon)

    def set_fit_inductance(self, fit_inductance):
        self._fit_inductance = bool(fit_inductance)

    def get_fit_inductance(self):
        return self._fit_inductance

    fit_inductance = property(get_fit_inductance, set_fit_inductance)

    def set_distributions(self, distributions):
        """Validate and normalize the distributions mini-DSL (DRT: series
        only; DDT: dist_type, symmetry, bc, ct with k_ct, and the
        defaults parallel, planar, blocking, no ct)."""
        distributions = deepcopy(distributions)
        for name, info in distributions.items():
            if info.get("kernel") not in ("DRT", "DDT"):
                raise ValueError(f"Invalid kernel {info.get('kernel')!r} "
                                 f"for distribution '{name}'. Options are "
                                 "DRT, DDT")
            if info["kernel"] == "DRT":
                if info.get("dist_type", "series") != "series":
                    warnings.warn(
                        "dist_type for DRT kernel must be series. Overwriting "
                        f"supplied dist_type {info['dist_type']!r} for "
                        f"distribution '{name}' with 'series'")
                info["dist_type"] = "series"
                invalid = set(info) & {"symmetry", "bc", "ct", "k_ct"}
                if invalid:
                    warnings.warn(f"The following keys are invalid for "
                                  f"distribution '{name}': {sorted(invalid)}. "
                                  f"These keys will be ignored")
            else:
                if info.get("dist_type", "parallel") not in ("series",
                                                             "parallel"):
                    raise ValueError(f"Invalid dist_type "
                                     f"{info.get('dist_type')!r} for "
                                     f"distribution '{name}'")
                if info.get("symmetry", "planar") not in ("planar",
                                                          "spherical"):
                    raise ValueError(f"Invalid symmetry "
                                     f"{info.get('symmetry')!r} for "
                                     f"distribution '{name}'")
                if info.get("bc", "transmissive") not in ("transmissive",
                                                          "blocking"):
                    raise ValueError(f"Invalid bc {info.get('bc')!r} for "
                                     f"distribution '{name}'")
                if info.get("ct", False) not in (True, False):
                    raise ValueError(f"Invalid ct {info.get('ct')!r} for "
                                     f"distribution '{name}'")
                if info.get("ct", False) and "k_ct" not in info:
                    raise ValueError(f"k_ct must be supplied for distribution "
                                     f"'{name}' if ct==True")
                defaults = {"dist_type": "parallel", "symmetry": "planar",
                            "bc": "blocking", "ct": False}
                defaults.update(info)
                distributions[name] = defaults
            self.distribution_matrices.setdefault(name, {})
        self._distributions = distributions
        self._recalc_mat = True
        self.f_pred = None

    def get_distributions(self):
        return self._distributions

    distributions = property(get_distributions, set_distributions)

    # --- device helpers ----------------------------------------------------

    def _tensor(self, a, dtype=None):
        """numpy -> tensor on the Inverter's device (its dtype unless
        named)."""
        return torch.as_tensor(np.array(a, dtype=float),
                               device=self._device).to(
            self._dtype if dtype is None else dtype)

    def _matrix(self, fn, *args, **kw):
        """A matrix from ops/ built on the Inverter's device in float64,
        as numpy."""
        return fn(*args, dtype=torch.float64, device=self._device,
                  **kw).cpu().numpy()

    def _dist_A(self, frequencies, info, tau, eps):
        """(A', A'') of one distribution at ``frequencies``, numpy."""
        kw = dict(tau=tau, basis=self.basis, epsilon=eps,
                  kernel=info["kernel"], dist_type=info["dist_type"],
                  symmetry=info.get("symmetry", "planar"),
                  bc=info.get("bc", "transmissive"),
                  ct=info.get("ct", False), k_ct=info.get("k_ct", None))
        return (self._matrix(construct_A, frequencies, "real", **kw),
                self._matrix(construct_A, frequencies, "imag", **kw))

    # --- scaling ------------------------------------------------------------

    def _scale_Z(self, Z, fit_type):
        self._Z_scale = float(z_scale_for(self.distributions, Z, fit_type))
        return Z / self._Z_scale

    def _rescale_coef(self, coef, dist_type):
        if dist_type == "parallel":
            return coef / self._Z_scale
        return coef * self._Z_scale

    # --- weights ------------------------------------------------------------

    def _format_weights(self, frequencies, Z, weights, part):
        """The batched fits' weights vocabulary for one spectrum, then the
        adjustment for a fit of one part: a real weights array weighs both
        parts alike, and the part not fit gets unit weights."""
        real_array = not (weights is None or isinstance(
            weights, (str, float, int, complex))) and np.isreal(
                weights).all()
        if real_array:
            weights = np.real(weights)
            if len(weights) != len(frequencies):
                raise ValueError("Weights array must match length of data")
        w_re, w_im = _format_weights_batch(np.asarray(Z)[None], weights)
        w_re, w_im = w_re[0], w_im[0]
        if part == "real":
            w_im = np.ones(len(frequencies))
        elif part == "imag" and real_array:
            w_re = np.ones(len(frequencies))
        elif part not in ("both", "imag"):
            raise ValueError(f"Invalid part {part!r}. Options are 'both', "
                             "'real', or 'imag'")
        return w_re + 1j * w_im

    # --- matrix preparation -------------------------------------------------

    def _dist_tau_epsilon(self, name, frequencies):
        info = self.distributions[name]
        basis_freq = info.get("basis_freq", self.basis_freq)
        if basis_freq is None:
            tau = get_tau_basis(frequencies)
        else:
            tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
        eps = info.get("epsilon", self.epsilon)
        if eps is None:
            eps = default_epsilon(tau)
        return tau, eps

    def _prep_matrices(self, frequencies, Z, part, weights, scale_Z, penalty,
                       fit_type, dZ=False):
        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        if len(frequencies) != len(Z):
            raise ValueError("Length of frequencies and Z must be equal")

        sort_idx = np.argsort(frequencies)[::-1]
        frequencies = frequencies[sort_idx]
        Z = Z[sort_idx]
        self.Z_train = Z
        self.t_train = None

        if not check_equality(self.distributions, self._cached_distributions):
            self._recalc_mat = True
            self.f_pred = None

        if not np.array_equal(rel_round(self.f_train, 10),
                              rel_round(frequencies, 10)):
            self.f_train = frequencies
            self._recalc_mat = True

        if scale_Z:
            Z_scaled = self._scale_Z(Z, fit_type)
            if isinstance(weights, (list, np.ndarray)):
                weights = np.asarray(weights) / self._Z_scale
        else:
            self._Z_scale = 1.0
            Z_scaled = Z

        w = self._format_weights(frequencies, Z_scaled, weights, part)

        dist_mat = {}
        for name, info in self.distributions.items():
            tau, eps = self._dist_tau_epsilon(name, frequencies)
            self.distributions[name]["tau"] = tau
            self.distributions[name]["epsilon"] = eps
            mats = self.distribution_matrices[name]

            if self._recalc_mat or "A_re" not in mats:
                mats["A_re"], mats["A_im"] = self._dist_A(frequencies, info,
                                                          tau, eps)

            f_coll = 1.0 / (2 * np.pi * tau)
            if penalty == "integral":
                for order in (0, 1, 2):
                    mats[f"M{order}"] = self._matrix(
                        construct_M, f_coll, basis=self.basis, order=order,
                        epsilon=eps)
            else:
                for order in (0, 1, 2):
                    mats[f"L{order}"] = self._matrix(
                        construct_L, f_coll, tau=tau, basis=self.basis,
                        epsilon=eps, order=order)
            if penalty == "cholesky":
                import scipy.linalg
                for order in (0, 1, 2):
                    M = self._matrix(construct_M, f_coll, basis=self.basis,
                                     order=order, epsilon=eps)
                    mats[f"M{order}"] = M
                    mats[f"L{order}"] = scipy.linalg.cholesky(M)

            if dZ and info["kernel"] == "DRT" and "B" not in mats:
                # dZ'/dlntau differentiation matrix
                dlnt = np.mean(np.diff(np.log(tau)))
                b_tau = np.logspace(
                    np.log10(np.exp(np.log(tau[0]) - dlnt / 2)),
                    np.log10(np.exp(np.log(tau[-1]) + dlnt / 2)),
                    len(tau) + 1)
                B_pre, _ = self._dist_A(1.0 / (2 * np.pi * b_tau), info, tau,
                                        eps)
                mats["B"] = B_pre[1:, :] - B_pre[:-1, :]

            dist_mat[name] = dict(mats)

        self._recalc_mat = False
        self._cached_distributions = deepcopy(self.distributions)
        return frequencies, Z_scaled, w, dist_mat

    # =====================================================================
    # Ridge fits
    # =====================================================================

    def ridge_fit(self, frequencies, Z, part="both", penalty="discrete",
                  reg_ord=2, L1_penalty=0, scale_Z=True, nonneg=True,
                  weights=None, preset=None,
                  hyper_lambda=True, hl_solution="analytic", hl_beta=2.5,
                  hl_fbeta=None, lambda_0=1e-2,
                  cv_lambdas=np.logspace(-10, 5, 31),
                  hyper_weights=False, hw_beta=2, hw_wbar=1,
                  xtol=1e-3, max_iter=20,
                  hyper_a=False, alpha_a=2, hl_beta_a=2, hyper_b=False, sb=1,
                  correct_phase_offset=False, IERange=None, lambda_phz=1,
                  init_phase_offset=False,
                  x0=None, dZ=False, dZ_power=0.5):
        """Ridge / hierarchical-ridge fit of a single distribution: the
        hyper-lambda ridge (analytic or ``hl_solution='lm'`` lambdas,
        ``hl_fbeta``, ``hyper_a`` / ``hyper_b``, ``dZ`` reweighting), the
        outlier-robust ``hyper_weights`` ridge or an ordinary ridge, with
        the presets 'Ciucci' (lambda_0 by Re-Im cross-validation) and
        'Huang', ``part`` 'real' / 'imag' fits, an L1 penalty, ``x0`` and
        the hardware phase-offset correction. A single parallel
        distribution fits the admittance."""
        if correct_phase_offset:
            if IERange is None:
                raise ValueError("IERange must be provided if "
                                 "correct_phase_offset==True")
            return self._ridge_fit_phase_offset(
                frequencies, Z, IERange, lambda_phz, init_phase_offset,
                part=part, penalty=penalty, reg_ord=reg_ord,
                L1_penalty=L1_penalty, scale_Z=scale_Z, nonneg=nonneg,
                weights=weights, preset=preset, hyper_lambda=hyper_lambda,
                hl_beta=hl_beta, hl_fbeta=hl_fbeta, lambda_0=lambda_0,
                xtol=xtol, max_iter=max_iter, x0=x0)
        if preset is not None:
            if preset == "Ciucci":
                penalty, lambda_0, hl_fbeta = "discrete", "cv", 0.1
            elif preset == "Huang":
                penalty, hl_beta, lambda_0, weights = ("integral", 2.5, 1e-2,
                                                       "modulus")
            else:
                raise ValueError(f"Invalid preset {preset!r}. Options are "
                                 "['Ciucci', 'Huang']")
        kw = dict(penalty=penalty, reg_ord=reg_ord, L1_penalty=L1_penalty,
                  scale_Z=scale_Z, nonneg=nonneg, weights=weights,
                  hyper_lambda=hyper_lambda, hl_solution=hl_solution,
                  hl_beta=hl_beta, hl_fbeta=hl_fbeta,
                  hyper_weights=hyper_weights, hw_beta=hw_beta,
                  hw_wbar=hw_wbar, xtol=xtol, max_iter=max_iter,
                  hyper_a=hyper_a, alpha_a=alpha_a, hl_beta_a=hl_beta_a,
                  hyper_b=hyper_b, sb=sb, x0=x0, dZ=dZ, dZ_power=dZ_power)
        _validate_ridge(self, **kw)
        if isinstance(lambda_0, str) and lambda_0 == "cv":
            cv_kw = dict(kw, hl_solution="analytic")
            lambda_0 = self.ridge_ReImCV(frequencies, Z, lambdas=cv_lambdas,
                                         **cv_kw)
        prob = self._ridge_problem(frequencies, Z, part, **kw)
        self._set_ridge_fit(prob, self._ridge_solve(prob, [lambda_0]), 0)

    def _ridge_problem(self, frequencies, Z, part="both",
                       penalty="discrete", reg_ord=2, L1_penalty=0,
                       scale_Z=True, nonneg=True, weights=None,
                       hyper_lambda=True, hl_solution="analytic",
                       hl_beta=2.5, hl_fbeta=None, hyper_weights=False,
                       hw_beta=2, hw_wbar=1, xtol=1e-3, max_iter=20,
                       hyper_a=False, alpha_a=2, hl_beta_a=2, hyper_b=False,
                       sb=1, x0=None, dZ=False, dZ_power=0.5):
        """Everything of a ridge fit but lambda_0: the sorted, scaled
        target, the augmented design (R_inf and a 1e-4-scaled inductance
        column for a series distribution), the penalty and bounds as
        RidgeData on the device (one row), and the solver's settings."""
        dist_name = list(self.distributions.keys())[0]
        dist_info = self.distributions[dist_name]
        if dist_info["kernel"] != "DRT" and dZ:
            warnings.warn("dZ should only be set to True for DRT recovery. "
                          "Proceeding with dZ=False")
            dZ = False

        target = (np.asarray(Z) if dist_info["dist_type"] == "series"
                  else 1.0 / np.asarray(Z))
        frequencies, target_scaled, w, dist_mat = self._prep_matrices(
            frequencies, target, part, weights, scale_Z, penalty, "ridge",
            dZ=dZ)
        dist_info = self.distributions[dist_name]

        if dist_info["dist_type"] == "parallel" and scale_Z:
            # rescale so that Z (not Y) is the scaled variable: tiny
            # admittances are not ignored in fitting (Z_train holds 1/Z)
            Z_scaled2 = self._scale_Z(1.0 / np.asarray(self.Z_train),
                                      "ridge")
            target_scaled = 1.0 / Z_scaled2

        mats = dist_mat[dist_name]
        tau = dist_info["tau"]
        eps = dist_info["epsilon"]
        series = dist_info["dist_type"] == "series"
        n_fixed = 2 if series else 0
        kb = mats["A_re"].shape[1]
        k = kb + n_fixed

        A_re = np.zeros((len(frequencies), k))
        A_im = np.zeros((len(frequencies), k))
        if series:
            A_re[:, 0] = 1.0
            if self.fit_inductance:
                # inductance column scaled by 1e-4
                A_im[:, 1] = 2 * np.pi * frequencies * 1e-4
        A_re[:, n_fixed:] = mats["A_re"]
        A_im[:, n_fixed:] = mats["A_im"]

        if penalty in ("integral", "cholesky"):
            L2_base = []
            for order in (0, 1, 2):
                M = np.zeros((k, k))
                M[n_fixed:, n_fixed:] = mats[f"M{order}"]
                L2_base.append(M)
            if penalty == "cholesky":
                # the discrete-form lambda updates take the Cholesky
                # factors of M as L
                L_ops = np.array([
                    np.concatenate([np.zeros((kb, n_fixed)),
                                    mats[f"L{order}"]], axis=1)
                    for order in (0, 1, 2)])
            else:
                L_ops = np.zeros((3, kb, k))
        else:
            L_ops = []
            L2_base = []
            for order in (0, 1, 2):
                L = np.concatenate([np.zeros((kb, n_fixed)),
                                    mats[f"L{order}"]], axis=1)
                L_ops.append(L)
                L2_base.append(L.T @ L)
            L_ops = np.array(L_ops)
        L2_base = np.array(L2_base)

        if isinstance(reg_ord, (int, np.integer)):
            frac = np.zeros(3)
            frac[reg_ord] = 1.0
        else:
            frac = np.asarray(reg_ord, float)

        L1_vec = np.ones(k) * np.sqrt(np.pi) / eps * L1_penalty
        L1_vec[:n_fixed] = 0.0

        if nonneg:
            lb = np.zeros(k)
        else:
            # the reference's bounds: free coefficients at -10 (scaled
            # units), the first two coordinates (R_inf, inductance) >= 0
            lb = np.full(k, -10.0)
            lb[:2] = 0.0
        ub = np.full(k, np.inf)

        w_re, w_im = np.real(w), np.imag(w)
        t = self._tensor
        data = RidgeData(
            WA_re=t(w_re[:, None] * A_re)[None],
            WA_im=t(w_im[:, None] * A_im)[None],
            WT_re=t(w_re * target_scaled.real)[None],
            WT_im=t(w_im * target_scaled.imag)[None],
            L2_base=t(L2_base), L_ops=t(L_ops), L1_vec=t(L1_vec),
            reg_frac=t(frac), lb=t(lb), ub=t(ub))

        delta_mask = np.ones(k)
        if series and (not self.fit_inductance or part == "real"):
            delta_mask[1] = 0.0

        prob = dict(dist_name=dist_name, dist_type=dist_info["dist_type"],
                    series=series, part=part, scale_Z=scale_Z,
                    frequencies=frequencies, target_scaled=target_scaled,
                    A_re=A_re, A_im=A_im, data=data,
                    delta_mask=t(delta_mask), max_iter=max_iter, xtol=xtol,
                    hyper_lambda=hyper_lambda, hyper_weights=hyper_weights)
        if hyper_lambda:
            prob["cfg"] = HyperLambdaConfig(
                part=part,
                penalty="integral" if penalty == "integral" else "discrete",
                use_fbeta=hl_fbeta is not None,
                use_lm=(hl_solution == "lm" and penalty != "integral"),
                n_fixed=n_fixed, max_iter=max_iter, use_dZ=bool(dZ),
                use_hyper_a=hyper_a, use_hyper_b=hyper_b)
            B, dZ_scale = None, 1.0
            if dZ:
                dlnt = np.mean(np.diff(np.log(tau)))
                B = t(np.concatenate([np.zeros((kb, n_fixed)), mats["B"]],
                                     axis=1))
                dZ_scale = dlnt / 0.23026

            def vec3(v):
                return t(np.broadcast_to(np.asarray(v, float), (3,)))

            prob["hl_kw"] = dict(
                hl_fbeta=float(hl_fbeta) if hl_fbeta is not None else 0.1,
                sb=vec3(sb), alpha_a=vec3(alpha_a), beta_a=vec3(hl_beta_a),
                B=B, dZ_scale=dZ_scale, dZ_power=dZ_power)
            prob["hl_beta"] = vec3(hl_beta)
            prob["x_init"] = t(np.full(k, 1e-6) if x0 is None
                               else np.asarray(x0, float))
        elif hyper_weights:
            wbar = self._format_weights(frequencies, target_scaled, hw_wbar,
                                        part)
            prob.update(hw_beta=float(hw_beta), wbar=wbar)
        return prob

    def _ridge_solve(self, prob, lambdas):
        """The ridge fits of ``prob`` at each of ``lambdas`` as one batch of
        rows. Returns numpy rows: coef (R, K), converged, and per mode the
        lambda vectors or the weights, and the cost."""
        R = len(lambdas)
        lam = self._tensor([float(v) for v in lambdas])
        d1 = prob["data"]
        data = d1._replace(**{f: getattr(d1, f).expand(
            (R,) + getattr(d1, f).shape[1:]) for f in ("WA_re", "WA_im",
                                                       "WT_re", "WT_im")})
        if prob["hyper_lambda"]:
            res = run_hyper_lambda(prob["cfg"], data, prob["x_init"],
                                   prob["hl_beta"], lam, xtol=prob["xtol"],
                                   delta_mask=prob["delta_mask"],
                                   **prob["hl_kw"])
        elif prob["hyper_weights"]:
            ts = prob["target_scaled"]
            t = self._tensor

            def rows(v):
                return t(v)[None].expand(R, -1)

            res = run_hyper_weights(
                prob["part"], data, t(prob["A_re"]), t(prob["A_im"]),
                rows(ts.real), rows(ts.imag), lam, prob["hw_beta"],
                rows(np.real(prob["wbar"])), rows(np.imag(prob["wbar"])),
                max_iter=prob["max_iter"], xtol=prob["xtol"],
                delta_mask=prob["delta_mask"])
        else:
            res = run_ordinary_ridge(prob["part"], data, lam)
        out = {"coef": res.coef.double().cpu().numpy(),
               "converged": res.converged.cpu().numpy(),
               "cost": res.cost.double().cpu().numpy()}
        if prob["hyper_lambda"]:
            out["lambda_vectors"] = res.lam_vectors.double().cpu().numpy()
        if prob["hyper_weights"]:
            out["weights"] = (res.weights_re.double().cpu().numpy()
                              + 1j * res.weights_im.double().cpu().numpy())
        return out

    def _ridge_coef(self, prob, coef):
        """The part-specific offset recovery and the rescaling of one row of
        scaled coefficients: (the distribution's coefficients, R_inf,
        inductance, the scaled coefficients after recovery)."""
        coef = np.array(coef, dtype=float)
        A_re, A_im, ts = prob["A_re"], prob["A_im"], prob["target_scaled"]
        series = prob["series"]
        # an imaginary-part fit cannot see R_inf, a real-part fit the
        # inductance
        if series and prob["part"] == "imag":
            coef[0] = np.mean(ts.real - A_re[:, 2:] @ coef[2:])
        elif series and prob["part"] == "real" and self.fit_inductance:
            zi_pred = A_im[:, 2:] @ coef[2:]
            basis_vec = 2 * np.pi * prob["frequencies"] * 1e-4
            coef[1] = ((basis_vec @ (ts.imag - zi_pred))
                       / (basis_vec @ basis_vec))
        scaled = coef.copy()
        if prob["scale_Z"]:
            coef = self._rescale_coef(coef, prob["dist_type"])
        if not series:
            return coef, 0.0, 0.0, scaled
        induc = coef[1] * 1e-4
        if not self.fit_inductance:
            induc = 0.0
        return coef[2:], coef[0], induc, scaled

    def _set_ridge_fit(self, prob, sol, i):
        """Make row ``i`` of a ``_ridge_solve`` result the Inverter's fit."""
        if not bool(sol["converged"][i]) and (prob["hyper_lambda"]
                                              or prob["hyper_weights"]):
            warnings.warn(f"Hyperparametric solution did not converge within "
                          f"{prob['max_iter']} iterations")
        coef, r_inf, induc, scaled = self._ridge_coef(prob, sol["coef"][i])
        fit_info = {"coef": np.asarray(coef, dtype=float)}
        if prob["hyper_lambda"]:
            fit_info["lambda_vectors"] = sol["lambda_vectors"][i]
        elif prob["hyper_weights"]:
            fit_info["weights"] = sol["weights"][i]
        fit_info["cost"] = float(sol["cost"][i])
        fit_info["scaled_coef"] = scaled
        self.R_inf = r_inf
        self.inductance = induc
        self.distribution_fits = {prob["dist_name"]: fit_info}
        self.f_pred = None
        self.fit_type = "ridge"

    def _ridge_fit_phase_offset(self, frequencies, Z, IERange, lambda_phz,
                                init_phase_offset, max_iter=20, xtol=1e-3,
                                **ridge_kw):
        """Hyper-lambda ridge with hardware phase-offset correction:
        alternates a ridge fit of the phase-adjusted data with an
        L1-regularized optimization (scipy, on the host) of the
        per-current-range phase offsets against the fitted phase."""
        from scipy.optimize import minimize

        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        IERange = np.asarray(IERange)
        if len(IERange) != len(frequencies):
            raise ValueError("IERange must have same length as frequencies")

        # steps in the current range, processed low -> high frequency
        step_indices = np.where(np.diff(IERange[::-1]) != 0)[0] + 1
        step_indices = np.append(step_indices, len(frequencies))
        zphz_exp = np.angle(Z, deg=True)
        zmod = np.abs(Z)

        phase_offsets = np.zeros(len(step_indices))
        offset_vec = np.zeros(len(Z))

        if init_phase_offset:
            zphz_adj = zphz_exp.copy()[::-1]
            for i, idx in enumerate(step_indices[:-1]):
                zdiff = np.diff(zphz_adj)
                interp = (zdiff[idx - 2] + zdiff[idx]) / 2
                target = zphz_adj[idx - 1] + interp
                phase_offsets[i] = target - zphz_adj[idx]
                offset_vec[::-1][idx:step_indices[i + 1]] += phase_offsets[i]
                zphz_adj[idx:step_indices[i + 1]] += phase_offsets[i]
            zphz_cur = zphz_adj[::-1]
        else:
            zphz_cur = zphz_exp.copy()

        def apply_phase(zphz):
            return (zmod * np.cos(np.radians(zphz))
                    + 1j * zmod * np.sin(np.radians(zphz)))

        z_adj = apply_phase(zphz_cur)
        prev_offsets = phase_offsets.copy()
        for _ in range(max_iter):
            self.ridge_fit(frequencies, z_adj, max_iter=max_iter,
                           xtol=xtol, **ridge_kw)
            z_pred = self.predict_Z(frequencies)
            # frequencies were sorted descending inside ridge_fit; align
            order = np.argsort(frequencies)[::-1]
            zphz_pred = np.empty(len(frequencies))
            zphz_pred[order] = np.angle(z_pred, deg=True)
            zphz_var = max(np.var(zphz_cur - zphz_pred), 1e-12)

            def cost(offsets):
                zadj = zphz_exp.copy()[::-1]
                for i, idx in enumerate(step_indices[:-1]):
                    zadj[idx:step_indices[i + 1]] += offsets[i]
                c = 0.5 * np.sum((zadj - zphz_pred[::-1]) ** 2) / zphz_var
                return c + lambda_phz * np.sum(np.abs(offsets))

            result = minimize(cost, x0=phase_offsets)
            phase_offsets = result["x"]
            zphz_new = zphz_exp.copy()[::-1]
            offset_vec = np.zeros(len(Z))
            for i, idx in enumerate(step_indices[:-1]):
                zphz_new[idx:step_indices[i + 1]] += phase_offsets[i]
                offset_vec[idx:step_indices[i + 1]] = phase_offsets[i]
            zphz_cur = zphz_new[::-1]
            offset_vec = offset_vec[::-1]
            z_adj = apply_phase(zphz_cur)
            if np.max(np.abs(phase_offsets - prev_offsets)) < xtol:
                break
            prev_offsets = phase_offsets.copy()

        # final fit on the converged adjusted data
        self.ridge_fit(frequencies, z_adj, max_iter=max_iter, xtol=xtol,
                       **ridge_kw)
        self.phase_offsets = phase_offsets
        self.phase_offset_vec = offset_vec
        self.Z_adjusted = z_adj

    def ridge_ReImCV(self, frequencies, Z, lambdas=np.logspace(-10, 5, 31),
                     **kw):
        """Re-Im cross-validation for lambda_0: at every grid value a
        real-part ridge fit predicts the imaginary part and an
        imaginary-part fit the real part; returns the grid value with the
        least summed squared prediction error (warning at a grid
        boundary). Each part's fits at all grid values run as one batch
        of rows. ``cv_result`` holds the grid and the errors as a dict of
        arrays ('lambda', 'recv', 'imcv', 'totcv'); the Inverter is left
        holding the last imaginary-part fit, as a loop of single fits
        would leave it."""
        _validate_ridge(self, **kw)
        lambdas = np.asarray(lambdas, float)
        Z = np.asarray(Z)
        freq = np.asarray(frequencies, float)
        err = {}
        for part in ("real", "imag"):
            prob = self._ridge_problem(frequencies, Z, part, **kw)
            sol = self._ridge_solve(prob, lambdas)
            A = self.distribution_matrices[prob["dist_name"]]
            A = A["A_re"] + 1j * A["A_im"]
            z_pred = np.empty((len(lambdas), len(freq)), dtype=complex)
            for i in range(len(lambdas)):
                coef, r_inf, induc, _ = self._ridge_coef(prob,
                                                         sol["coef"][i])
                z = A @ coef
                if prob["dist_type"] == "parallel":
                    z = 1.0 / z
                z_pred[i] = (z + r_inf + 1j * 2 * np.pi * prob["frequencies"]
                             * induc)
            # back to the caller's point order
            z_pred = z_pred[:, np.argsort(np.argsort(freq)[::-1])]
            if part == "real":
                err["imcv"] = np.sum((Z.imag - z_pred.imag) ** 2, axis=1)
            else:
                err["recv"] = np.sum((Z.real - z_pred.real) ** 2, axis=1)
                self._set_ridge_fit(prob, sol, len(lambdas) - 1)
        recv, imcv = err["recv"], err["imcv"]
        totcv = recv + imcv
        min_lam = float(lambdas[np.argmin(totcv)])
        if min_lam in (np.min(lambdas), np.max(lambdas)):
            warnings.warn(
                f"Optimal lambda_0 {min_lam} determined by Re-Im CV is at the "
                "boundary of the evaluated range. Re-run with an expanded "
                "lambda_0 range to obtain an accurate estimate.")
        self.cv_result = {"lambda": lambdas, "recv": recv, "imcv": imcv,
                          "totcv": totcv}
        return min_lam

    # =====================================================================
    # Hierarchical Bayesian fits
    # =====================================================================

    def fit(self, frequencies, Z, part="both", scale_Z=True, nonneg=False,
            outliers=False, check_outliers=True, init_from_ridge=False,
            ridge_kw=None, sigma_min=0.002, inductance_scale=1.0,
            outlier_lambda=None, mode="optimize", random_seed=1234,
            max_iter=4000, warmup=200, samples=200, chains=2,
            fitY=False, SA=False, SASY=False, n_restarts=2,
            max_tree_depth=10, adapt_delta=0.9, ncp=False,
            sampler="nuts", chees_cfg=None, shmc_cfg=None,
            add_model_data=None, log_density_fn=None, polish=True):
        """MAP (mode='optimize') or full HMC (mode='sample') fit of the
        calibrated hierarchical Bayesian model.

        MAP runs L-BFGS from ``n_restarts`` Stan-random starts (or from
        the ridge seed, ``init_from_ridge``) capped at ``max_iter``
        iterations, then the damped Newton polish (``polish``; in float32
        it never certifies and runs its 100 iterations). Sampling runs
        ``chains`` chains of ``sampler`` 'nuts' (one chain per row, each
        with its own adaptation), 'shmc' or 'chees' (the chains of the
        spectrum pool their adaptation; ``shmc_cfg``, or ``chees_cfg``,
        by default ``ChEESConfig(delta=adapt_delta)``), ``ncp`` sampling the
        coefficients non-centered; ``random_seed`` seeds a torch.Generator
        on the device. ``outliers='auto'`` picks the outlier error model
        when a ridge fit flags outliers. ``fitY`` / ``SA`` / ``SASY`` are
        the reference's admittance variants of a parallel model.

        Escape hatches: ``add_model_data`` overrides PosteriorData fields
        after assembly; ``log_density_fn`` replaces the log density by a
        torch function ``(cfg, data, params, jacobian) -> logp`` of the
        port's signature (broadcasting over leading parameter rows), whose
        gradient autograd supplies."""
        if ridge_kw is None:
            ridge_kw = {}
        self.timings = StageTimer(self._device)

        init_values = None
        if init_from_ridge:
            if len(self.distributions) > 1:
                raise ValueError("Ridge initialization can only be performed "
                                 "for single-distribution fits")
            with self.timings.stage("ridge_init"):
                init_values = self._get_init_from_ridge(
                    frequencies, Z, nonneg, outliers, inductance_scale,
                    ridge_kw)
            self._init_params = init_values

        fit_kind = "map" if mode == "optimize" else "bayes"
        frequencies, Z_scaled, _, dist_mat = self._prep_matrices(
            frequencies, Z, part, None, scale_Z, "discrete", fit_kind)
        Z = self.Z_train

        if outliers == "auto":
            outlier_idx = self.check_outliers(frequencies, Z, threshold=4,
                                              use_existing_fit=init_from_ridge,
                                              **ridge_kw)
            if len(outlier_idx) > 0:
                outliers = True
                warnings.warn(
                    f"Identified likely outliers at indices "
                    f"{outlier_idx.ravel()}, "
                    f"f={frequencies[outlier_idx.ravel()]} Hz. An "
                    "outlier-robust error model will be used. To disable "
                    "this behavior, pass outliers=False.")
            else:
                outliers = False
            # the internal ridge fit replaced the matrices; rebuild
            frequencies, Z_scaled, _, dist_mat = self._prep_matrices(
                frequencies, Z, part, None, scale_Z, "discrete", fit_kind)

        cfg, data = build_posterior(
            self.distributions, dist_mat, frequencies, Z_scaled, mode=mode,
            part=part, nonneg=nonneg, outliers=bool(outliers), fitY=fitY,
            sigma_min=sigma_min, inductance_scale=inductance_scale,
            outlier_lambda=outlier_lambda, ncp=ncp and mode == "sample",
            SA=SA, SASY=SASY, dtype=self._dtype, device=self._device)
        if add_model_data:
            data = _replace_model_data(data, add_model_data)
        self.stan_model_name = cfg.model_name()
        self._posterior = (cfg, data)
        if cfg.model_name().startswith("Series-Parallel") and not nonneg:
            warnings.warn("For mixed series-parallel models, it is highly "
                          "recommended to set nonneg=True")

        names = sort_distributions(self.distributions)
        gen = torch.Generator(device=self._device).manual_seed(
            int(random_seed))
        iv = (None if init_values is None
              else {k: self._tensor(v) for k, v in init_values.items()})

        if mode == "optimize":
            self._fit_map(cfg, data, gen, iv, log_density_fn, n_restarts,
                          max_iter, polish, names)
        elif mode == "sample":
            if sampler not in ("nuts", "chees", "shmc"):
                raise ValueError(f"Unknown sampler {sampler!r}; options are "
                                 "'nuts', 'chees', 'shmc'")
            self._fit_sample(cfg, data, gen, iv, log_density_fn, sampler,
                             chains, warmup, samples, max_tree_depth,
                             adapt_delta, shmc_cfg, chees_cfg, names)
        else:
            raise ValueError(f"Invalid mode {mode!r}. Options are 'optimize', "
                             "'sample'")

        # coefficients and error structure
        self.distribution_fits = {}
        for nm in names:
            dist_type = self.distributions[nm]["dist_type"]
            stan_key = self._get_stan_coef_name(nm)
            self.distribution_fits[nm] = {
                "coef": self._extract_parameter(stan_key, dist_type, mode)}
        if not fitY:
            self.R_inf = float(self._extract_parameter("Rinf", "series",
                                                       mode))
            self.inductance = float(self._extract_parameter("induc",
                                                            "series", mode))
        else:
            self.R_inf = 0.0
            self.inductance = 0.0

        self.error_fit = {"sigma_min": self._rescale_coef(sigma_min,
                                                          "series")}
        for pkey in ("sigma_tot", "sigma_res"):
            self.error_fit[pkey] = self._extract_parameter(pkey, "series",
                                                           mode)
        for pkey in ("alpha_prop", "alpha_re", "alpha_im"):
            self.error_fit[pkey] = self._extract_parameter(pkey, None, mode)
        if outliers:
            self.error_fit["sigma_out"] = self._extract_parameter(
                "sigma_out", "series", mode)

        self.f_pred = None

        if outliers is False and check_outliers:
            outlier_idx = self.check_outliers(frequencies, Z, threshold=3.5,
                                              use_existing_fit=True)
            if len(outlier_idx) > 0:
                warnings.warn(
                    f"Possible outliers were identified at indices "
                    f"{outlier_idx.ravel()}, "
                    f"f={frequencies[outlier_idx.ravel()]} Hz. Check the "
                    "residuals and consider re-running with outliers=True")

    def _fit_map(self, cfg, data, gen, iv, density, n_restarts, max_iter,
                 polish, names):
        """MAP: L-BFGS (from the ridge seed or best of ``n_restarts``
        starts; its objective and graphs a progcache runner) and the
        Newton polish of the best row."""
        one = MapObjective(cfg, data, data.target[None], density=density)
        with self.timings.stage("lbfgs"):
            if iv is not None:
                q0 = ravel(cfg, init_unconstrained(
                    cfg, data, gen, batch_shape=(1,), init_values=iv))
                targets = data.target[None]
            else:
                q0 = ravel(cfg, init_unconstrained(
                    cfg, data, gen, batch_shape=(1, n_restarts)))
                targets = data.target.expand(n_restarts, -1).contiguous()
            entry = map_objective("Inverter.fit", cfg, data, targets,
                                  density=density, key=("lbfgs", max_iter))
            if iv is not None:
                res = run_lbfgs(entry.fn.value_and_grad, q0,
                                max_iter=max_iter, graphs=entry.graphs)
            else:
                res = run_lbfgs_restarts(entry.fn.value_and_grad, q0,
                                         max_iter=max_iter,
                                         graphs=entry.graphs)
        n_lbfgs = int(res.n_iter[0])
        if polish:
            # the L-BFGS cap binds before Stan-grade convergence on this
            # posterior; a damped Newton pass certifies the optimum
            with self.timings.stage("polish"):
                pol = newton_polish(one.value_and_grad, one.hessian,
                                    res.params)
            res = pol._replace(n_iter=res.n_iter + pol.n_iter)
        c = constrain(cfg, data, unravel(cfg, res.params))
        pred = predict_target(cfg, data, c)
        st = sigma_tot(cfg, data, c, pred)
        c = {k: v[0].double().cpu().numpy() for k, v in c.items()}
        self._opt_result = self._stan_style_result(
            cfg, names, c, pred[0].double().cpu().numpy(),
            st[0].double().cpu().numpy())
        self._opt_result["lp__"] = -float(res.value[0])
        self._map_result = MapResult(*(np.asarray(a[0].cpu().numpy())
                                       for a in res))
        self._map_n_iter_lbfgs = n_lbfgs
        self.fit_type = "map"

    def _fit_sample(self, cfg, data, gen, iv, density, sampler, chains,
                    warmup, samples, max_tree_depth, adapt_delta, shmc_cfg,
                    chees_cfg, names):
        """NUTS (one chain per row), SHMC or ChEES (the chains pooled as
        one spectrum), then the Stan-style per-draw results and the host
        diagnostics. The value and gradient over the chains' rows (the
        hand-written form for the single series DRT under NUTS and SHMC,
        autograd of ``density`` otherwise) and the sampler's graphs are a
        progcache runner, so a later same-shape fit captures nothing."""
        if sampler == "shmc":
            run_cfg = (shmc_cfg if shmc_cfg is not None
                       else SHMCConfig(delta=adapt_delta))
        elif sampler == "chees":
            run_cfg = (chees_cfg if chees_cfg is not None
                       else ChEESConfig(delta=adapt_delta))
        else:
            run_cfg = NUTSConfig(max_depth=max_tree_depth, delta=adapt_delta)
        entry = _sampler_entry("Inverter.fit", cfg, data,
                               data.target.expand(chains, -1).contiguous(),
                               run_cfg, density=density,
                               budget=("chees", chains, warmup, samples))
        q0 = ravel(cfg, init_unconstrained(cfg, data, gen,
                                           batch_shape=(chains,),
                                           init_values=iv)).contiguous()
        with self.timings.stage("sample"):
            if sampler in ("shmc", "chees"):
                run = sample_chees if sampler == "chees" else sample_shmc
                draws, info = run(entry.fn, q0, warmup, samples, run_cfg,
                                  chains, generator=gen, time_draws=True,
                                  graphs=entry.graphs)
                draws = draws[0]
                info = {k: (v[0] if isinstance(v, torch.Tensor) else v)
                        for k, v in info.items()}
            else:
                draws, info = sample_nuts(
                    entry.fn, q0, warmup, samples, run_cfg, generator=gen,
                    time_draws=True, graphs=entry.graphs)
                draws = draws.transpose(0, 1)
                info = {k: (v.transpose(0, 1) if isinstance(v, torch.Tensor)
                            and v.ndim == 2 and k != "inv_mass" else v)
                        for k, v in info.items()}
            draws_np = draws.double().cpu().numpy()   # (chains, samples, D)
        wall = self.timings.stages["sample"]
        self._raw_draws = draws_np

        flat = draws.reshape(-1, draws.shape[-1])
        c = constrain(cfg, data, unravel(cfg, flat))
        pred = predict_target(cfg, data, c)
        st = sigma_tot(cfg, data, c, pred)
        cons = {k: v.double().cpu().numpy() for k, v in c.items()}
        self._sample_result = self._stan_style_result(
            cfg, names, cons, pred.double().cpu().numpy(),
            st.double().cpu().numpy())

        def host(k):
            return info[k].double().cpu().numpy()

        div = host("diverging")
        ess = mcmc_diagnostics.ess(draws_np)
        rhat_rank = mcmc_diagnostics.rhat_rank(draws_np)
        ess_bulk = mcmc_diagnostics.ess_bulk(draws_np)
        ess_tail = mcmc_diagnostics.ess_tail(draws_np)
        self.sample_diagnostics = {
            "divergence_rate": float(div.mean()),
            "accept_prob": float(host("accept_prob").mean()),
            "step_size": host("step_size"),
            "rhat_max": float(np.max(mcmc_diagnostics.rhat(draws_np))),
            "rhat_rank": rhat_rank,
            "rank_rhat_max": float(np.max(rhat_rank)),
            "ess_bulk": ess_bulk,
            "ess_bulk_min": float(np.min(ess_bulk)),
            "ess_tail": ess_tail,
            "ess_tail_min": float(np.min(ess_tail)),
            "ess_min": float(np.min(ess)),
            "ess_mean": float(np.mean(ess)),
            "n_leapfrog": float(host("n_leapfrog").mean()),
            "wall_time_s": float(wall),
            "ess_per_sec": float(np.mean(ess) / max(wall, 1e-9)),
            "e_bfmi": mcmc_diagnostics.e_bfmi(host("energy")),
            # each draw's seconds (NUTS's first holds its CUDA-graph
            # captures, also under capture_s; none on a cache hit)
            "draw_s": np.asarray(info["draw_s"]),
            "capture_s": float(np.sum(info.get("capture_s", 0.0))),
        }
        if self.sample_diagnostics["divergence_rate"] > 0.1:
            warnings.warn(
                f"{100 * self.sample_diagnostics['divergence_rate']:.1f}% "
                "of post-warmup draws diverged; posterior estimates may be "
                "biased. Consider increasing adapt_delta.")
        self.fit_type = "bayes"

    # =====================================================================
    # Drift fits
    # =====================================================================

    def drift_map_fit(self, frequencies, Z, times, drift_model="x1",
                      part="both", scale_Z=True, nonneg=False,
                      sigma_min=0.002, max_iter=4000, random_seed=1234,
                      inductance_scale=1.0, n_restarts=2,
                      min_tau_drift=200.0, max_tau_drift=10000.0,
                      polish=True):
        """MAP fit of a time-evolving spectrum (the reference's drift
        models x1/x2/dx/dx-lin/RQ/RQ-lin/RQ-from-final/RQ-lin-from-final,
        models/drift.py). ``times``: measurement time of each frequency
        point (same length as frequencies, seconds); measurement order is
        kept.

        The static coefficients, R_inf and the inductance are seeded from
        a hyper-lambda ridge fit of the whole spectrum (a ridge that fails
        numerically warns and leaves the seeded start at random values;
        no other error is caught). The seeded start and ``n_restarts``
        random starts run as one batch of rows through L-BFGS; the best
        finite row (the seeded one on ties) is polished by the damped
        Newton pass (``polish``). ``part`` is accepted and unused, as in
        the JAX package."""
        if drift_model not in DRIFT_MODELS:
            raise ValueError(f"Invalid drift_model {drift_model!r}. Options "
                             f"are {DRIFT_MODELS}")
        if len(self.distributions) > 1:
            raise ValueError("drift_map_fit supports a single distribution")
        times = np.asarray(times, float)
        if len(times) != len(frequencies):
            raise ValueError("times must have same length as frequencies")
        self.timings = StageTimer(self._device)

        # keep measurement order aligned with times
        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        self.f_train = frequencies
        self.Z_train = Z
        self.t_train = times
        if scale_Z:
            Z_scaled = self._scale_Z(Z, "map")
        else:
            self._Z_scale = 1.0
            Z_scaled = Z

        dist_name = list(self.distributions.keys())[0]
        info = self.distributions[dist_name]
        dist_type = info["dist_type"]
        tau, eps = self._dist_tau_epsilon(dist_name, frequencies)
        self.distributions[dist_name]["tau"] = tau
        self.distributions[dist_name]["epsilon"] = eps
        A_re, A_im = self._dist_A(frequencies, info, tau, eps)
        self.distribution_matrices[dist_name].update(A_re=A_re, A_im=A_im)
        f_coll = 1.0 / (2 * np.pi * tau)
        L = np.stack([1.5 * s * self._matrix(construct_L, f_coll, tau=tau,
                                             basis=self.basis, epsilon=eps,
                                             order=o)
                      for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])
        cfg = DriftConfig(drift_model=drift_model, dist_type=dist_type,
                          nonneg=nonneg, K=len(tau))
        data = drift_data(frequencies, times, A_re, A_im, L,
                          np.concatenate([Z_scaled.real, Z_scaled.imag]),
                          tau, sigma_min, inductance_scale, min_tau_drift,
                          max_tau_drift, self._dtype, self._device)

        with self.timings.stage("ridge_init"):
            ridge_init = self._drift_ridge_init(frequencies, Z, nonneg,
                                                dist_name)
        # restore the state the internal ridge fit replaced (it sorts the
        # frequencies and rebuilds the cached matrices)
        self.f_train = frequencies
        self.Z_train = Z
        self.t_train = times
        self.distribution_matrices[dist_name].update(A_re=A_re, A_im=A_im)
        self.f_pred = None

        gen = torch.Generator(device=self._device).manual_seed(
            int(random_seed))
        q0 = ravel_drift(cfg, init_drift_params(
            cfg, data, gen, batch_shape=(1,), init_values=ridge_init))
        if n_restarts > 0:
            q0 = torch.cat([q0, ravel_drift(cfg, init_drift_params(
                cfg, data, gen, batch_shape=(1, n_restarts)))[0]])
        vg = drift_value_and_grad(cfg, data)

        def value_and_grad(q, rows=None):
            lp, g = vg(q)
            return -lp, -g

        entry = _drift_loss("Inverter.drift_map_fit", cfg, data,
                            key=("lbfgs", max_iter))

        def loss_row(q_row):
            return -drift_log_density(cfg, data, unravel_drift(cfg, q_row))

        def hessian(q, rows=None):
            return torch.func.vmap(torch.func.jacrev(torch.func.jacrev(
                loss_row)))(q)

        with self.timings.stage("lbfgs"):
            res = run_lbfgs(entry.fn, q0, max_iter=max_iter,
                            graphs=entry.graphs)
            pick = drift_pick(res.value[None])
            res = MapResult(*(a[pick] for a in res))
        n_lbfgs = int(res.n_iter[0])
        if polish:
            # certify the winning basin's optimum
            with self.timings.stage("polish"):
                pol = newton_polish(value_and_grad, hessian, res.params)
            res = pol._replace(n_iter=res.n_iter + pol.n_iter)
        self._map_result = MapResult(*(np.asarray(a[0].cpu().numpy())
                                       for a in res))
        self._map_n_iter_lbfgs = n_lbfgs
        c_t = constrain_drift(cfg, data, unravel_drift(cfg, res.params))
        pred = predict_drift_target(cfg, data, c_t)[0].double().cpu().numpy()
        c = {k: v[0].double().cpu().numpy() for k, v in c_t.items()}
        self._drift_result = c
        self._drift_cfg = cfg
        self.stan_model_name = (f"Series_drift-{drift_model}"
                                if dist_type == "series"
                                else f"Parallel_drift-{drift_model}")

        fits = {}
        if drift_model in ("x1", "x2"):
            fits["x0"] = self._rescale_coef(c["x0"], dist_type)
            fits["x1"] = self._rescale_coef(c["x1"], dist_type)
            fits["tau_x1"] = float(c["tau_1"])
            if drift_model == "x2":
                fits["x2"] = self._rescale_coef(c["x2"], dist_type)
                fits["tau_x2"] = float(c["tau_2"])
        elif drift_model in ("dx", "dx-lin"):
            fits["x0"] = self._rescale_coef(c["x0"], dist_type)
            fits["dx"] = self._rescale_coef(c["dx"], dist_type)
            if drift_model == "dx":
                fits["tau_dx"] = float(c["tau_1"])
            else:
                fits["m_Ft"] = 1.0 / times.max()
        else:
            key = "x1" if drift_model.endswith("from-final") else "x0"
            fits[key] = self._rescale_coef(c[key], dist_type)
            fits["R_rq"] = float(self._rescale_coef(c["R_rq"], dist_type))
            fits["tau_rq"] = float(c["tau_rq"])
            fits["phi_rq"] = float(c["phi_rq"])
            if drift_model in ("RQ", "RQ-from-final"):
                fits["k_d"] = float(c["k_d"])
            elif drift_model == "RQ-lin":
                fits["m_Ft"] = 1.0 / times.max()
            else:
                fits["t_i"] = float(times.min())
                fits["t_f"] = float(times.max())
        # alias: 'coef' = the static coefficient vector, so that
        # predict_distribution and the peak fits see the time-zero (or
        # final) distribution
        fits["coef"] = fits.get("x0", fits.get("x1"))
        self.distribution_fits = {dist_name: fits}

        self.drift_offsets = {
            "Rinf_0": float(self._rescale_coef(c["Rinf_0"], "series")),
            "delta_Rinf": float(self._rescale_coef(c["delta_Rinf"],
                                                   "series")),
        }
        if drift_model in ("x1", "x2", "dx"):
            self.drift_offsets["tau_Rinf"] = float(c["tau_Rinf"])
        if drift_model.endswith("from-final"):
            self.drift_offsets["Rinf_1"] = self.drift_offsets.pop("Rinf_0")
        self.R_inf = self.drift_offsets.get("Rinf_0",
                                            self.drift_offsets.get("Rinf_1"))
        self.inductance = float(self._rescale_coef(c["induc"], "series"))
        n = len(frequencies)
        st = np.sqrt(sigma_min ** 2 + c["sigma_res"] ** 2
                     + (c["alpha_prop"] * pred) ** 2
                     + (c["alpha_re"] * np.tile(pred[:n], 2)) ** 2
                     + (c["alpha_im"] * np.tile(pred[n:], 2)) ** 2)
        self.error_fit = {
            "sigma_min": self._rescale_coef(sigma_min, "series"),
            "sigma_res": float(self._rescale_coef(c["sigma_res"], "series")),
            "sigma_tot": self._rescale_coef(st, "series"),
            "alpha_prop": float(c["alpha_prop"]),
            "alpha_re": float(c["alpha_re"]),
            "alpha_im": float(c["alpha_im"]),
        }
        self.fit_type = "map-drift"
        self.f_pred = None

    def _drift_ridge_init(self, frequencies, Z, nonneg, dist_name):
        """The drift fit's seed: init values of x0/x1, R_inf and the
        inductance from a quick static hyper-lambda ridge of the whole
        spectrum, in the drift model's scaled, unconstrained coordinates;
        the fit state the ridge replaces is restored. A numerical failure
        of the ridge warns and returns {} (the seeded start then stays
        random); any other error, a device's or a kernel build's among
        them, propagates."""
        saved = (self.distribution_fits, self.fit_type, self._Z_scale)
        try:
            self.ridge_fit(frequencies, Z, penalty="integral",
                           hyper_lambda=True, lambda_0=1, hl_beta=5,
                           weights="modulus")
            x_r = self.distribution_fits[dist_name]["coef"] / saved[2]
            rinf_r = max(self.R_inf / saved[2], 1e-6)
            induc_r = max(self.inductance / saved[2], 1e-10)
        except (ValueError, ArithmeticError, np.linalg.LinAlgError,
                torch.linalg.LinAlgError) as exc:
            warnings.warn(f"Ridge initialization for drift fit failed: "
                          f"{exc}")
            return {}
        finally:
            self.distribution_fits, self.fit_type, self._Z_scale = saved
        pos_x = (nonneg
                 or self.distributions[dist_name]["dist_type"] == "parallel")
        u_x = np.log(np.clip(x_r, 1e-10, None)) if pos_x else np.asarray(x_r)
        return {"Rinf0_raw": np.log(rinf_r / 100.0),
                "induc_raw": np.log(induc_r), "dRinf_raw": 0.0,
                "x0": u_x, "x1": u_x, "dx": np.full_like(x_r, 1e-3),
                "x2": np.full_like(x_r, 1e-3)}

    def predict_Z_drift(self, frequencies, times, distributions=None,
                        include_offsets=True):
        """Impedance of a drift fit at per-point ``times`` (numpy, from the
        fit's numpy state; the A matrices on the device)."""
        if self.fit_type != "map-drift":
            raise ValueError("predict_Z_drift requires a drift_map_fit result")
        frequencies = np.asarray(frequencies, float)
        times = np.asarray(times, float)
        if len(times) != len(frequencies):
            raise ValueError("times must have same length as frequencies")
        name = list(self.distributions.keys())[0]
        dist_type = self.distributions[name]["dist_type"]
        model = self.stan_model_name.split("drift-")[1]
        fits = self.distribution_fits[name]
        offs = self.drift_offsets
        pred_mat = self._get_prediction_matrices(frequencies, [name])[name]
        A_re, A_im = pred_mat["A_re"], pred_mat["A_im"]
        omega = 2 * np.pi * frequencies

        if model in ("x1", "x2", "dx", "dx-lin"):
            if model in ("x1", "x2"):
                decay = 1 - np.exp(-times / fits["tau_x1"])
                X = (fits["x0"][None, :]
                     + (fits["x1"] - fits["x0"])[None, :] * decay[:, None])
                if model == "x2":
                    decay2 = 1 - np.exp(-times / fits["tau_x2"])
                    X = X + fits["x2"][None, :] * decay2[:, None]
            elif model == "dx":
                decay = 1 - np.exp(-times / fits["tau_dx"])
                X = fits["x0"][None, :] + fits["dx"][None, :] * decay[:, None]
            else:
                f_t = times * fits["m_Ft"]
                X = fits["x0"][None, :] + fits["dx"][None, :] * f_t[:, None]
            zr = np.sum(A_re * X, axis=1)
            zi = np.sum(A_im * X, axis=1)
            z = zr + 1j * zi
            if dist_type == "parallel":
                z = 1.0 / z
            if model == "dx-lin":
                rinf = (offs["Rinf_0"]
                        + offs["delta_Rinf"] * times * fits["m_Ft"])
            else:
                rinf = (offs["Rinf_0"] + offs["delta_Rinf"]
                        * (1 - np.exp(-times / offs["tau_Rinf"])))
        else:
            x_static = fits.get("x0", fits.get("x1"))
            zr = A_re @ x_static
            zi = A_im @ x_static
            z = zr + 1j * zi
            if dist_type == "parallel":
                z = 1.0 / z
            f_t = _drift_rq_ft(model, fits, times)
            z = z + f_t * (fits["R_rq"]
                           / (1 + (1j * omega * fits["tau_rq"])
                              ** fits["phi_rq"]))
            rinf = (offs.get("Rinf_0", offs.get("Rinf_1"))
                    + offs["delta_Rinf"] * f_t)
        if include_offsets:
            z = z + rinf + 1j * omega * self.inductance
        return z

    def predict_distribution_drift(self, time, name=None, eval_tau=None):
        """gamma(tau, t) of a drift fit at time ``time``."""
        if self.fit_type != "map-drift":
            raise ValueError("requires a drift_map_fit result")
        if name is None:
            name = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self.distributions[name]["tau"]
        eval_tau = np.asarray(eval_tau, float)
        bases = self._basis_matrix(name, eval_tau)
        model = self.stan_model_name.split("drift-")[1]
        fits = self.distribution_fits[name]
        if model in ("x1", "x2"):
            decay = 1 - np.exp(-time / fits["tau_x1"])
            x = fits["x0"] + (fits["x1"] - fits["x0"]) * decay
            if model == "x2":
                x = x + fits["x2"] * (1 - np.exp(-time / fits["tau_x2"]))
            return bases @ x
        if model in ("dx", "dx-lin"):
            f_t = (1 - np.exp(-time / fits["tau_dx"]) if model == "dx"
                   else time * fits["m_Ft"])
            return bases @ (fits["x0"] + fits["dx"] * f_t)
        # RQ family: the static distribution plus the time-dependent ZARC
        F0 = bases @ fits.get("x0", fits.get("x1"))
        f_t = _drift_rq_ft(model, fits, time)
        phi_rq = fits["phi_rq"]
        f_rq = ((1 / (2 * np.pi)) * np.sin((1 - phi_rq) * np.pi)
                / (np.cosh(phi_rq * np.log(eval_tau / fits["tau_rq"]))
                   - np.cos((1 - phi_rq) * np.pi)))
        return F0 + f_t * fits["R_rq"] * f_rq

    def _stan_style_result(self, cfg, names, cons, pred, st):
        """Constrained draws or values under Stan-style keys (x/xs/xp/
        xp1/xp2, Rinf, induc, error parameters, Z_hat, sigma_tot)."""
        out = {}
        for i, nm in enumerate(names):
            out[self._get_stan_coef_name(nm)] = cons[f"x_{i}"]
        for k in ("Rinf", "induc", "sigma_res", "alpha_prop", "alpha_re",
                  "alpha_im"):
            out[k] = cons[k]
        if "sigma_out" in cons:
            out["sigma_out"] = cons["sigma_out"]
        out["Z_hat"] = pred
        out["sigma_tot"] = st
        return out

    def _get_stan_coef_name(self, distribution_name):
        """Stan-result key of a distribution's coefficients: the named
        model families' keys, and a positional key for MultiDist."""
        names = sort_distributions(self.distributions)
        dist_type = self.distributions[distribution_name]["dist_type"]
        n_series = sum(1 for nm in names
                       if self.distributions[nm]["dist_type"] == "series")
        n_par = len(names) - n_series
        if len(names) == 1:
            return "x"
        if n_series == 1 and n_par in (1, 2):
            if dist_type == "series":
                return "xs"
            if n_par == 1:
                return "xp"
            par_names = [nm for nm in names
                         if self.distributions[nm]["dist_type"] == "parallel"]
            return f"xp{par_names.index(distribution_name) + 1}"
        return f"x_{names.index(distribution_name)}"

    def _extract_parameter(self, stan_key, dist_type, mode):
        source = (self._opt_result if mode == "optimize"
                  else self._sample_result)
        val = source[stan_key]
        if mode == "sample":
            val = np.mean(val, axis=0)
        if stan_key in ("alpha_prop", "alpha_re", "alpha_im"):
            return val
        return self._rescale_coef(val, dist_type)

    def coef_percentile(self, distribution_name, percentile):
        if self.fit_type != "bayes":
            raise ValueError("Percentile prediction is only available for "
                             "bayes_fit")
        dist_type = self.distributions[distribution_name]["dist_type"]
        coef_name = self._get_stan_coef_name(distribution_name)
        coef = np.percentile(self._sample_result[coef_name], percentile,
                             axis=0)
        return self._rescale_coef(coef, dist_type)

    def _get_init_from_ridge(self, frequencies, Z, nonneg, outliers,
                             inductance_scale, ridge_kw):
        """Underfitted integral-penalty ridge initialization: init values
        in the posterior's scaled coordinates."""
        dist_name = list(self.distributions.keys())[0]
        dist_type = self.distributions[dist_name]["dist_type"]
        defaults = dict(penalty="integral", hyper_lambda=True, lambda_0=1,
                        hl_beta=5, weights="modulus")
        defaults.update(ridge_kw)
        self.ridge_fit(frequencies, Z, **defaults)

        coef = self.distribution_fits[dist_name]["coef"]
        if dist_type == "series":
            x_star = coef / self._Z_scale
        else:
            x_star = coef * self._Z_scale
        iv = {"x_0": x_star}
        iv["Rinf_raw"] = max(self.R_inf / self._Z_scale, 1e-10) / 100.0
        induc = self.inductance / self._Z_scale
        if induc <= 0:
            induc = 1e-10
        iv["induc_raw"] = induc / inductance_scale
        if outliers:
            outlier_idx = self.check_outliers(frequencies, Z, threshold=3,
                                              use_existing_fit=True)
            sigma_out_raw = np.zeros(len(Z)) + 0.1
            sigma_out_raw[outlier_idx.ravel()] = 1.0
            iv["sigma_out_raw"] = sigma_out_raw
        return iv

    # =====================================================================
    # Prediction
    # =====================================================================

    def _get_prediction_matrices(self, frequencies, distributions):
        """A matrices at prediction frequencies: the training grid's (or a
        subset of its rows) or the last prediction grid's when they match,
        else built anew and cached."""
        frequencies = np.asarray(frequencies, float)
        cached_f = self.f_pred if self.f_pred is not None else self.f_train
        cached_src = (self.prediction_matrices if self.f_pred is not None
                      else self.distribution_matrices)
        pred_mat = {}
        have_cache = all(
            len(cached_src.get(nm, {})) > 0 and "A_re" in cached_src.get(nm,
                                                                         {})
            for nm in distributions)
        if have_cache and np.array_equal(rel_round(cached_f, 10),
                                         rel_round(frequencies, 10)):
            for nm in distributions:
                pred_mat[nm] = {"A_re": cached_src[nm]["A_re"],
                                "A_im": cached_src[nm]["A_im"]}
            return pred_mat

        rounded_cache = rel_round(cached_f, 10) if have_cache else np.array(
            [])
        idx = []
        subset = have_cache
        if have_cache:
            for f in rel_round(frequencies, 10):
                match = np.where(rounded_cache == f)[0]
                if len(match) == 0:
                    subset = False
                    break
                idx.append(match[0])
        if subset:
            idx = np.asarray(idx)
            for nm in distributions:
                pred_mat[nm] = {"A_re": cached_src[nm]["A_re"][idx],
                                "A_im": cached_src[nm]["A_im"][idx]}
            return pred_mat

        for nm in distributions:
            info = self.distributions[nm]
            a_re, a_im = self._dist_A(frequencies, info, info["tau"],
                                      info["epsilon"])
            pred_mat[nm] = {"A_re": a_re, "A_im": a_im}
        self.f_pred = frequencies
        self.prediction_matrices = pred_mat
        return pred_mat

    def predict_Z(self, frequencies, distributions=None, include_offsets=True,
                  percentile=None, times=None):
        """Impedance of the fit at ``frequencies`` (a percentile of the
        posterior's for a sampled fit); a drift fit needs ``times``, the
        measurement time of each point."""
        frequencies = np.asarray(frequencies, float)
        if self.fit_type == "map-drift":
            if times is None:
                raise ValueError(
                    "This is a drift fit (fit_type='map-drift'): predict_Z "
                    "requires times (one per frequency point)")
            if percentile is not None:
                raise ValueError("Percentile prediction is not available for "
                                 "drift (MAP-only) fits")
            return self.predict_Z_drift(frequencies, times,
                                        distributions=distributions,
                                        include_offsets=include_offsets)
        if times is not None:
            raise ValueError("times is only valid for drift_map_fit results "
                             f"(fit_type={self.fit_type!r})")
        if distributions is None:
            distributions = list(self.distribution_fits.keys())
        elif isinstance(distributions, str):
            distributions = [distributions]

        if percentile is not None:
            if self.fit_type != "bayes":
                raise ValueError("Percentile prediction is only available "
                                 "for bayes_fit results")
            z_mat = self.predict_Z_distribution(
                frequencies, distributions=distributions,
                include_offsets=include_offsets)
            return (np.percentile(z_mat.real, percentile, axis=0)
                    + 1j * np.percentile(z_mat.imag, percentile, axis=0))

        pred_mat = self._get_prediction_matrices(frequencies, distributions)
        z_pred = np.zeros(len(frequencies), dtype=complex)
        for nm in distributions:
            mat = pred_mat[nm]
            dist_type = self.distributions[nm]["dist_type"]
            coef = self.distribution_fits[nm]["coef"]
            if dist_type == "series":
                z_pred += mat["A_re"] @ coef + 1j * (mat["A_im"] @ coef)
            else:
                y = mat["A_re"] @ coef + 1j * (mat["A_im"] @ coef)
                z_pred += 1.0 / y
        if include_offsets:
            z_pred = z_pred + self.R_inf
            z_pred = z_pred + 1j * 2 * np.pi * frequencies * self.inductance
        return z_pred

    def predict_Z_distribution(self, frequencies, distributions=None,
                               include_offsets=True):
        """Posterior impedance sample matrix (draws, frequencies)."""
        if self.fit_type != "bayes":
            raise ValueError("predict_Z_distribution is only available for "
                             "bayes_fit results")
        frequencies = np.asarray(frequencies, float)
        if distributions is None:
            distributions = list(self.distribution_fits.keys())
        elif isinstance(distributions, str):
            distributions = [distributions]
        if (len(distributions) != len(self.distributions)
                or not include_offsets):
            warnings.warn("All distributions and offsets should be included "
                          "for meaningful results")

        if (np.array_equal(rel_round(self.f_train, 10),
                           rel_round(frequencies, 10))
                and len(distributions) == len(self.distributions)
                and include_offsets):
            z_split = self._sample_result["Z_hat"] * self._Z_scale
            n = len(frequencies)
            return z_split[:, :n] + 1j * z_split[:, n:]

        pred_mat = self._get_prediction_matrices(frequencies, distributions)
        n_samples = len(self._sample_result["Rinf"])
        z_mat = np.zeros((n_samples, len(frequencies)), dtype=complex)
        for nm in distributions:
            mat = pred_mat[nm]
            dist_type = self.distributions[nm]["dist_type"]
            coef_matrix = self._rescale_coef(
                self._sample_result[self._get_stan_coef_name(nm)], dist_type)
            zr = coef_matrix @ mat["A_re"].T
            zi = coef_matrix @ mat["A_im"].T
            if dist_type == "series":
                z_mat += zr + 1j * zi
            else:
                z_mat += 1.0 / (zr + 1j * zi)
        if include_offsets:
            z_mat += self._rescale_coef(self._sample_result["Rinf"],
                                        "series")[:, None]
            z_mat += 1j * 2 * np.pi * frequencies * self._rescale_coef(
                self._sample_result["induc"], "series")[:, None]
        return z_mat

    def predict_Rp(self, distributions=None, percentile=None, time=None):
        """Polarization resistance of the fit (or of ``distributions``).
        ``time`` is accepted and, as in the JAX package, unused: a drift
        fit's Rp is its static (time-zero, or final) distribution's."""
        if distributions is None:
            distributions = list(self.distribution_fits.keys())
        elif isinstance(distributions, str):
            distributions = [distributions]

        if len(distributions) > 1:
            z_range = self.predict_Z(np.array([1e20, 1e-20]),
                                     distributions=distributions,
                                     percentile=percentile)
            return float(np.real(z_range[1] - z_range[0]))

        nm = distributions[0]
        info = self.distributions[nm]
        if info["kernel"] == "DRT" and "coef" in self.distribution_fits[nm]:
            if percentile is None:
                return float(np.sum(self.distribution_fits[nm]["coef"])
                             * np.sqrt(np.pi) / info["epsilon"])
            if self.fit_type != "bayes":
                raise ValueError("Percentile prediction is only available "
                                 "for bayes_fit results")
            coef_matrix = self._rescale_coef(
                self._sample_result[self._get_stan_coef_name(nm)], "series")
            rp = (np.sum(coef_matrix, axis=1) * np.sqrt(np.pi)
                  / info["epsilon"])
            return float(np.percentile(rp, percentile))
        if percentile is None:
            z_range = self.predict_Z(np.array([1e20, 1e-20]),
                                     distributions=distributions)
            return float(np.real(z_range[1] - z_range[0]))
        z_mat = self.predict_Z_distribution(np.array([1e20, 1e-20]),
                                            distributions=distributions)
        rp = np.real(z_mat[:, 1] - z_mat[:, 0])
        return float(np.percentile(rp, percentile))

    def predict_sigma(self, frequencies, percentile=None, times=None):
        """The fit's error scale (sigma_re, sigma_im) at ``frequencies``."""
        if percentile is not None and self.fit_type != "bayes":
            raise ValueError("Percentile prediction is only available for "
                             "bayes_fit")
        if times is not None and self.fit_type != "map-drift":
            raise ValueError("times is only valid for drift_map_fit results "
                             f"(fit_type={self.fit_type!r})")
        frequencies = np.asarray(frequencies, float)
        n_train = len(self.f_train)
        times_match = (self.fit_type != "map-drift"
                       or (times is not None and self.t_train is not None
                           and np.array_equal(np.asarray(times, float),
                                              self.t_train)))
        if times_match and np.array_equal(rel_round(self.f_train, 10),
                                          rel_round(frequencies, 10)):
            if self.fit_type == "bayes" and percentile is not None:
                st = np.percentile(self._sample_result["sigma_tot"],
                                   percentile, axis=0) * self._Z_scale
            elif (self.fit_type in ("bayes",)
                  or (self.fit_type or "").startswith("map")):
                st = self.error_fit["sigma_tot"]
            else:
                raise ValueError("Error scale prediction only available for "
                                 "bayes_fit and map_fit")
            return st[:n_train].copy(), st[n_train:].copy()

        if self.fit_type == "bayes" and percentile is not None:
            sigma_res = np.percentile(self._sample_result["sigma_res"],
                                      percentile) * self._Z_scale
            alpha_prop = np.percentile(self._sample_result["alpha_prop"],
                                       percentile)
            alpha_re = np.percentile(self._sample_result["alpha_re"],
                                     percentile)
            alpha_im = np.percentile(self._sample_result["alpha_im"],
                                     percentile)
            if "sigma_out" in self._sample_result:
                sigma_out = np.percentile(self._sample_result["sigma_out"],
                                          percentile, axis=0) * self._Z_scale
            else:
                sigma_out = np.zeros(2 * n_train)
        elif (self.fit_type in ("bayes",)
              or (self.fit_type or "").startswith("map")):
            sigma_res = self.error_fit["sigma_res"]
            alpha_prop = self.error_fit["alpha_prop"]
            alpha_re = self.error_fit["alpha_re"]
            alpha_im = self.error_fit["alpha_im"]
            sigma_out = self.error_fit.get("sigma_out",
                                           np.zeros(2 * n_train))
        else:
            raise ValueError("Error scale prediction only available for "
                             "bayes_fit and map_fit")
        sigma_min = self.error_fit["sigma_min"]
        z_pred = self.predict_Z(frequencies, percentile=percentile,
                                times=times)
        sigma_base = np.sqrt(sigma_res ** 2 + np.min(sigma_out) ** 2
                             + sigma_min ** 2)
        sigma_re = np.sqrt(sigma_base ** 2 + (alpha_prop * z_pred.real) ** 2
                           + (alpha_re * z_pred.real) ** 2
                           + (alpha_im * z_pred.imag) ** 2)
        sigma_im = np.sqrt(sigma_base ** 2 + (alpha_prop * z_pred.imag) ** 2
                           + (alpha_re * z_pred.real) ** 2
                           + (alpha_im * z_pred.imag) ** 2)
        return sigma_re, sigma_im

    def score(self, frequencies, Z, metric="chi_sq", weights=None,
              part="both", times=None):
        """chi^2 per point or R^2 of the fit's impedance against ``Z``."""
        Z = np.asarray(Z)
        w = self._format_weights(frequencies, Z, weights, part)
        z_pred = self.predict_Z(frequencies, times=times)
        if part == "both":
            z_pred = np.concatenate([z_pred.real, z_pred.imag])
            z_data = np.concatenate([Z.real, Z.imag])
            w = np.concatenate([w.real, w.imag])
        else:
            z_pred = getattr(z_pred, part)
            z_data = getattr(Z, part)
            w = getattr(w, part)
        if metric == "chi_sq":
            return float(np.sum(((z_pred - z_data) * w) ** 2)
                         / len(frequencies))
        if metric == "r2":
            return float(r2_score(z_data, z_pred, weights=w))
        raise ValueError(f"Invalid metric {metric}. Options are 'chi_sq', "
                         "'r2'")

    def predict_distribution(self, name=None, eval_tau=None, percentile=None,
                             time=None):
        """gamma(tau) of distribution ``name`` on ``eval_tau`` (the basis
        grid by default; a posterior percentile for a sampled fit; at
        ``time`` for a drift fit, whose static distribution is the
        time-zero, or final, one)."""
        if time is not None:
            if self.fit_type != "map-drift":
                raise ValueError("time is only valid for drift_map_fit "
                                 f"results (fit_type={self.fit_type!r})")
            if percentile is not None:
                raise ValueError("Percentile prediction is not available for "
                                 "drift (MAP-only) fits")
            return self.predict_distribution_drift(time, name=name,
                                                   eval_tau=eval_tau)
        if name is None:
            name = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self.distributions[name]["tau"]
        eval_tau = np.asarray(eval_tau, float)
        if percentile is not None:
            coef = self.coef_percentile(name, percentile)
        else:
            coef = self.distribution_fits[name]["coef"]
        return self._basis_matrix(name, eval_tau) @ coef

    def _basis_matrix(self, name, eval_tau):
        """The basis functions of distribution ``name`` at ``eval_tau``
        (rows) and its basis time constants (columns), float64 numpy."""
        eps = self.distributions[name]["epsilon"]
        basis_tau = self.distributions[name]["tau"]
        phi = get_basis_func(self.basis)
        y = self._tensor(np.log(eval_tau[:, None] / basis_tau[None, :]),
                         torch.float64)
        return phi(y, eps).cpu().numpy()

    def check_outliers(self, frequencies, Z, threshold=3.5,
                       use_existing_fit=False, **ridge_kw):
        """Indices (into the descending-frequency order) of likely
        outliers: the IQR rule on a ridge fit's relative residuals, or
        the error model's z-scores for a MAP or sampled fit. Refits with
        the 'Huang' ridge unless ``use_existing_fit`` and the fit is of
        this spectrum."""
        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        fit_exists = (check_equality(rel_round(frequencies, 10),
                                     rel_round(self.f_train, 10))
                      and self.Z_train is not None
                      and len(Z) == len(self.Z_train)
                      and check_equality(np.sort(Z), np.sort(self.Z_train))
                      and bool(self.distribution_fits))
        if not (use_existing_fit and fit_exists):
            self.ridge_fit(frequencies, Z, preset="Huang", **ridge_kw)

        sort_idx = np.argsort(frequencies)[::-1]
        frequencies = frequencies[sort_idx]
        Z = Z[sort_idx]
        z_err = self.predict_Z(frequencies) - Z
        if self.fit_type == "ridge":
            zmod = np.abs(Z)
            re_thresh = get_outlier_thresh(np.abs(z_err.real / zmod),
                                           iqr_factor=threshold)
            im_thresh = get_outlier_thresh(np.abs(z_err.imag / zmod),
                                           iqr_factor=threshold)
            outlier_idx = np.argwhere(
                (z_err.real / zmod) ** 2 + (z_err.imag / zmod) ** 2
                >= re_thresh ** 2 + im_thresh ** 2)
        else:
            sigma_re, sigma_im = self.predict_sigma(frequencies)
            zs_tot = np.sqrt(((z_err.real / sigma_re) ** 2
                              + (z_err.imag / sigma_im) ** 2) / 2)
            outlier_idx = np.argwhere(zs_tot > threshold)
        return outlier_idx

    # =====================================================================
    # Peak fits (peaks.py: HN decomposition, the LM on the device)
    # =====================================================================

    def _peak_eval_tau(self, distribution):
        basis_tau = self.distributions[distribution]["tau"]
        tmin = np.log10(np.min(basis_tau)) - 1
        tmax = np.log10(np.max(basis_tau)) + 1
        return np.logspace(tmin, tmax, int(10 * (tmax - tmin) + 1))

    def _peak_place(self):
        return dict(device=self._device, dtype=self._dtype)

    def fit_peaks(self, distribution=None, eval_tau=None, percentile=None,
                  time=None, check_shoulders=True, weights=None,
                  prom_rthresh=0.001, R_rthresh=0.005, l1_penalty=0,
                  l2_penalty=0.01, check_chi_sq=False, chi_sq_thresh=0.5,
                  chi_sq_delta=0.3, fit_data=False, frequencies=None, Z=None,
                  Z_weights=None, lambda_x=10):
        """HN peak decomposition of a recovered distribution (at ``time``
        for a drift fit); with ``fit_data`` the peaks are then refit
        against the impedance ``Z``. The result, sorted by time constant,
        lands in ``distribution_fits[distribution]['peak_params']`` with
        its ``peak_chi_sq``."""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self._peak_eval_tau(distribution)
        F = self.predict_distribution(distribution, eval_tau, percentile, time)
        nonneg = bool(np.min(F) >= 0)
        rp = self.predict_Rp()
        x = peaks.fit_peaks(eval_tau, F, rp, weights=weights, nonneg=nonneg,
                            check_shoulders=check_shoulders,
                            prom_rthresh=prom_rthresh, R_rthresh=R_rthresh,
                            check_chi_sq=check_chi_sq,
                            chi_sq_thresh=chi_sq_thresh,
                            chi_sq_delta=chi_sq_delta, l1_penalty=l1_penalty,
                            l2_penalty=l2_penalty, **self._peak_place())
        if fit_data:
            if frequencies is None or Z is None:
                raise ValueError("frequencies and Z must be provided if "
                                 "fit_data==True")
            x = peaks.fit_data(x, frequencies, Z, R_inf=self.R_inf,
                               inductance=self.inductance, weights=Z_weights,
                               lambda_x=lambda_x, **self._peak_place())["x"]
        # sort by time constant
        x = np.asarray(x)
        if len(x):
            order = np.argsort(np.exp(x[1::4]))
            x = x.reshape(-1, 4)[order].ravel()
        self.distribution_fits[distribution]["peak_params"] = x
        self.distribution_fits[distribution]["peak_chi_sq"] = \
            self.score_peak_fit(eval_tau=eval_tau, distribution=distribution,
                                weights=weights, percentile=percentile,
                                time=time)

    def fit_peaks_constrained(self, tau0_guess, distribution=None,
                              eval_tau=None, percentile=None, time=None,
                              sigma_lntau=5, lntau_uncertainty=3, weights=None,
                              l2_penalty=0.01):
        """HN peaks at the time constants ``tau0_guess``, each tied to its
        guess by a ln-tau prior."""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self._peak_eval_tau(distribution)
        F = self.predict_distribution(distribution, eval_tau, percentile, time)
        nonneg = bool(np.min(F) >= 0)
        rp = self.predict_Rp()
        result = peaks.constrained_peak_fit(
            eval_tau, F, tau0_guess, rp, nonneg, lntau_uncertainty,
            sigma_lntau, weights, l2_penalty, **self._peak_place())
        self.distribution_fits[distribution]["peak_params"] = result["x"]
        self.distribution_fits[distribution]["peak_chi_sq"] = \
            self.score_peak_fit(eval_tau=eval_tau, distribution=distribution,
                                weights=weights, percentile=percentile,
                                time=time)

    def predict_peak_distribution(self, eval_tau=None, distribution=None,
                                  peak_index=None):
        """gamma(tau) of the fitted peaks (or of peak ``peak_index``)."""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self._peak_eval_tau(distribution)
        params = self.distribution_fits[distribution]["peak_params"]
        if peak_index is not None:
            params = params[4 * peak_index:4 * peak_index + 4]
        return peaks.evaluate_fit_distribution(
            params, eval_tau, **self._peak_place()).double().cpu().numpy()

    def predict_peak_Z(self, frequencies, distribution=None):
        """Impedance of the fitted peaks plus R_inf and the inductance."""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        return peaks.evaluate_fit_impedance(
            self.distribution_fits[distribution]["peak_params"], frequencies,
            self.R_inf, self.inductance,
            **self._peak_place()).cpu().numpy().astype(complex)

    def extract_peak_info(self, distribution=None, sort=True):
        """The fitted peaks' R, tau_0, alpha and beta (by tau_0 when
        ``sort``), their count and chi-square."""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        params = np.asarray(
            self.distribution_fits[distribution]["peak_params"])
        R = params[::4]
        t0 = np.exp(params[1::4])
        alpha = params[2::4]
        beta = params[3::4]
        if sort:
            order = np.argsort(t0)
            R, t0, alpha, beta = R[order], t0[order], alpha[order], beta[order]
        return {"num_peaks": len(params) // 4,
                "chi_sq": self.distribution_fits[distribution]["peak_chi_sq"],
                "R": R, "tau_0": t0, "alpha": alpha, "beta": beta}

    def score_peak_fit(self, eval_tau=None, distribution=None, weights=None,
                       percentile=None, time=None):
        """Weighted chi-square of the peak fit against the distribution
        (the weights' 80th percentile on the host, numpy)."""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self.distributions[distribution]["tau"]
        F = self.predict_distribution(distribution, eval_tau, percentile, time)
        F_fit = self.predict_peak_distribution(eval_tau=eval_tau,
                                               distribution=distribution)
        if weights is None:
            weights = 1.0 / (F + np.percentile(F, 80))
        return float(np.sum(((F_fit - F) * weights) ** 2))

    # =====================================================================
    # Persistence
    # =====================================================================

    def get_fit_attributes(self, which="all"):
        fit_attributes = {
            "common": {
                "core": ["_distributions", "distribution_fits", "f_train",
                         "Z_train", "_Z_scale", "fit_type", "R_inf",
                         "inductance"],
                "detail": ["distribution_matrices"],
            },
            "ridge": {"core": [], "detail": ["_iter_history"]},
            "map": {"core": ["stan_model_name", "error_fit"],
                    "detail": ["_init_params", "_opt_result"]},
            "bayes": {"core": ["stan_model_name", "_sample_result",
                               "error_fit", "sample_diagnostics"],
                      "detail": ["_init_params", "_raw_draws"]},
            "map-drift": {"core": ["stan_model_name", "error_fit",
                                   "drift_offsets"],
                          "detail": ["_drift_result"]},
        }
        if which == "all":
            return (sum(fit_attributes["common"].values(), [])
                    + sum(fit_attributes[self.fit_type].values(), []))
        return (fit_attributes["common"][which]
                + fit_attributes[self.fit_type][which])

    def save_fit_data(self, filename=None, which="all"):
        """Save fit state to a pickle (or return it as a dict if
        filename=None): numpy arrays and Python scalars only."""
        import pickle
        fit_data = {att: getattr(self, att)
                    for att in self.get_fit_attributes(which)}
        if filename is None:
            return fit_data
        with open(filename, "wb") as f:
            pickle.dump(fit_data, f)

    def load_fit_data(self, data):
        """Restore fit state from a pickle path or a dict (this package's
        or the JAX package's ``save_fit_data``)."""
        import pickle
        if isinstance(data, str):
            with open(data, "rb") as f:
                fit_data = pickle.load(f)
        else:
            fit_data = data
        fit_data = inverter_state_from_numpy(fit_data)
        f_pred_old = deepcopy(self.f_pred)
        for k, v in fit_data.items():
            setattr(self, k, v)
        self._cached_distributions = deepcopy(self._distributions)
        if "distribution_matrices" not in fit_data:
            self.f_pred = f_pred_old
            self._recalc_mat = True

    # --- plotting wrappers (reference: inversion.py:3685-3975) -----------

    def _train_df(self):
        from .io.file_load import construct_eis_df
        return construct_eis_df(self.f_train, self.Z_train)

    def plot_distribution(self, ax=None, distribution=None, tau_plot=None,
                          plot_bounds=True, plot_ci=True, **kw):
        from .viz.plotting import plot_distribution as _plot
        return _plot(self._train_df(), self, ax=ax, distribution=distribution,
                     tau_plot=tau_plot, plot_bounds=plot_bounds,
                     plot_ci=plot_ci, **kw)

    def plot_fit(self, axes=None, plot_type="all", bode_cols=None,
                 plot_data=True, color="k", **kw):
        from .viz.plotting import plot_fit as _plot
        return _plot(self._train_df(), self, axes=axes, plot_type=plot_type,
                     bode_cols=bode_cols, plot_data=plot_data, color=color,
                     **kw)

    def plot_residuals(self, axes=None, unit_scale="auto", plot_ci=True,
                       **kw):
        from .viz.plotting import plot_residuals as _plot
        return _plot(self._train_df(), self, axes=axes, unit_scale=unit_scale,
                     plot_ci=plot_ci, **kw)

    def plot_full_results(self, axes=None, bode_cols=None, plot_data=True,
                          color="k", **kw):
        from .viz.plotting import plot_full_results as _plot
        return _plot(self._train_df(), self, axes=axes, bode_cols=bode_cols,
                     plot_data=plot_data, color=color, **kw)

    def plot_peak_fit(self, ax=None, distribution=None, tau_plot=None,
                      plot_bounds=False, plot_ci=False,
                      plot_individual_peaks=True, **kw):
        """Recovered distribution with the HN peak decomposition overlaid
        (reference: inversion.py:3866-3975)."""
        import matplotlib.pyplot as plt
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if ax is None:
            _, ax = plt.subplots(figsize=(4.5, 3.2))
        if tau_plot is None:
            basis_tau = self.distributions[distribution]["tau"]
            tau_plot = np.logspace(np.log10(basis_tau.min()),
                                   np.log10(basis_tau.max()), 200)
        gamma = self.predict_distribution(distribution, eval_tau=tau_plot)
        ax.plot(tau_plot, gamma, label="distribution", **kw)
        if plot_ci and self.fit_type == "bayes":
            lo = self.predict_distribution(distribution, eval_tau=tau_plot,
                                           percentile=2.5)
            hi = self.predict_distribution(distribution, eval_tau=tau_plot,
                                           percentile=97.5)
            ax.fill_between(tau_plot, lo, hi, alpha=0.25)
        if plot_bounds:
            for fb in (np.max(self.f_train), np.min(self.f_train)):
                ax.axvline(1.0 / (2 * np.pi * fb), ls=":", c="gray", lw=1)
        g_fit = self.predict_peak_distribution(eval_tau=tau_plot,
                                               distribution=distribution)
        ax.plot(tau_plot, g_fit, ls="--", label="peak fit")
        if plot_individual_peaks:
            params = self.distribution_fits[distribution]["peak_params"]
            for i in range(len(params) // 4):
                g_i = self.predict_peak_distribution(
                    eval_tau=tau_plot, distribution=distribution, peak_index=i)
                ax.plot(tau_plot, g_i, ls=":", lw=1)
        ax.set_xscale("log")
        ax.set_xlabel(r"$\tau$ / s")
        ax.set_ylabel(r"$\gamma$ / $\Omega$")
        ax.legend()
        return ax


def _drift_rq_ft(model, fits, t):
    """F(t) of an RQ-family drift fit from its (rescaled) fits."""
    if model == "RQ":
        return 1 - np.exp(-fits["k_d"] * t)
    if model == "RQ-lin":
        return t * fits["m_Ft"]
    if model == "RQ-from-final":
        return -np.exp(-fits["k_d"] * t)
    return (t - fits["t_f"]) / (fits["t_f"] - fits["t_i"])


def _validate_ridge(inv, penalty="discrete", hl_beta=2.5, hyper_lambda=True,
                    hyper_weights=False, hl_solution="analytic", **_):
    """ridge_fit's argument checks (its defaults for those not given)."""
    if penalty in ("discrete", "cholesky"):
        if np.min(hl_beta) <= 1:
            raise ValueError("hl_beta must be greater than 1 for penalty "
                             "'cholesky' and 'discrete'")
    elif penalty == "integral":
        if np.min(hl_beta) <= 2:
            raise ValueError("hl_beta must be greater than 2 for penalty "
                             "'integral'")
    else:
        raise ValueError(f"Invalid penalty argument {penalty!r}. Options "
                         "are 'integral', 'discrete', and 'cholesky'")
    if hyper_lambda and hyper_weights:
        raise ValueError("hyper_lambda and hyper_weights fits cannot be "
                         "performed simultaneously")
    if len(inv.distributions) > 1:
        raise ValueError("ridge_fit cannot be used to fit multiple "
                         "distributions")
    if hl_solution not in ("analytic", "lm"):
        raise ValueError(f"Invalid hl_solution {hl_solution!r}")


def _replace_model_data(data, add_model_data):
    """PosteriorData with the fields of ``add_model_data`` replaced (one
    value per distribution for the tuple fields), in data's dtype and on
    its device."""
    unknown = set(add_model_data) - set(PosteriorData._fields)
    if unknown:
        raise ValueError(
            f"Unknown PosteriorData fields in add_model_data: "
            f"{sorted(unknown)}. Valid fields: "
            f"{list(PosteriorData._fields)}")
    dt, dev = data.target.dtype, data.target.device

    def t(v):
        return torch.as_tensor(np.array(v, dtype=float), device=dev).to(dt)

    updates = {}
    for k, v in add_model_data.items():
        cur = getattr(data, k)
        if isinstance(cur, tuple):
            if len(v) != len(cur):
                raise ValueError(
                    f"add_model_data[{k!r}] must have {len(cur)} entries "
                    "(one per distribution)")
            updates[k] = tuple(t(vi) for vi in v)
        else:
            updates[k] = t(v)
    return data._replace(**updates)
