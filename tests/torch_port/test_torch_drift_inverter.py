"""The port's Inverter drift surface (drift_map_fit, the drift
predictions, the time routing of the generic predictors, save/load)
against the JAX package's, float64 on the CPU (the JAX side with x64 on,
as its own tests run it), on a thinned cell of the drift bench's fleet
(benchmarks/bench_drift.py:make_fleet)."""

import warnings

import numpy as np
import pytest
import torch

from bayes_drt_tpu import Inverter as JaxInverter
from bayes_drt_tpu_torch import Inverter
from bayes_drt_tpu_torch import inverter as inverter_module
from bayes_drt_tpu_torch.models import drift
from jax_drift_reference import inverter_starts, port_init_from
from test_torch_drift import BASIS, PARALLEL, _fleet

torch.set_num_threads(1)

# after 25 L-BFGS iterations from the JAX package's starts and the Newton
# polish: the objective within 1e-8 (relative) and the coefficient vectors
# within 1e-6 of each one's largest entry (measured: 5e-8 for x1, whose
# polish runs its 100 iterations uncertified in either package; 1e-14
# where it certifies); the scalar drift, offset and error parameters
# within 1e-4 of each one (x1's flat directions leave delta_Rinf and
# alpha_prop 5.3e-6 apart)
POLISH_TOL = 1e-6
SCALAR_TOL = 1e-4
VALUE_TOL = 1e-8
COEF_KEYS = ("x0", "x1", "x2", "dx", "coef")
# the port's ridge seed against the JAX package's, and predictions
SEED_TOL = 1e-8
PRED_RTOL = 1e-10

# x1 (the bench's model; its polish runs uncertified) and a parallel x1
# (certified; dx, certified too, agreed within 1e-14 when measured and is
# left out for time); RQ-family polishes from a 25-iteration start wander
# uncertified through a non-convex region and part by ~1e-3 (their
# densities are held in test_torch_drift.py, their fleets in
# test_torch_drift_fleet.py)
CASES = {"x1": ("x1", None, 2), "x1-parallel": ("x1", PARALLEL, 1)}


def _jax_ridge_init(freq, Z, dists, nonneg=False):
    """The JAX Inverter.drift_map_fit's ridge init values, by its calls."""
    r = JaxInverter(basis_freq=BASIS, **({} if dists is None
                                         else {"distributions": dists}))
    r._scale_Z(Z, "map")
    s = r._Z_scale
    r.ridge_fit(freq, Z, penalty="integral", hyper_lambda=True, lambda_0=1,
                hl_beta=5, weights="modulus")
    name = list(r.distributions)[0]
    x_r = r.distribution_fits[name]["coef"] / s
    pos_x = nonneg or r.distributions[name]["dist_type"] == "parallel"
    u_x = np.log(np.clip(x_r, 1e-10, None)) if pos_x else x_r
    return {"Rinf0_raw": np.log(max(r.R_inf / s, 1e-6) / 100.0),
            "induc_raw": np.log(max(r.inductance / s, 1e-10)),
            "dRinf_raw": 0.0, "x0": u_x, "x1": u_x,
            "dx": np.full_like(x_r, 1e-3), "x2": np.full_like(x_r, 1e-3)}


def _logit(p):
    return np.log(p) - np.log1p(-p)


def _unconstrain(cfg, data, c):
    """Unconstrained drift parameters (numpy) from constrain_drift's
    values: the inverse of each transform."""
    lo, hi = (float(v) for v in data.tau_bounds)
    p = {}
    pos_x = cfg.nonneg or cfg.dist_type == "parallel"
    for nm in drift._coef_vector_names(cfg):
        p[nm] = np.log(c[nm]) if nm in ("x0", "x1") and pos_x else c[nm]
        p[f"ups_raw_{nm}"] = np.log(c[f"ups_{nm}"] / 0.15)
        p[f"d_strength_{nm}"] = np.log(c[f"d_strength_{nm}"])
    p["Rinf0_raw"] = np.log(c["Rinf_0"] / 100.0)
    p["dRinf_raw"] = c["delta_Rinf"] / 100.0
    p["induc_raw"] = np.log(c["induc"] / float(data.induc_scale))
    for nm in ("sigma_res", "alpha_prop", "alpha_re", "alpha_im"):
        p[f"{nm}_raw"] = np.log(c[nm] / 0.05)
    if "tau_1" in c:
        key = "u_tau_dx" if cfg.drift_model == "dx" else "u_tau_x1"
        p[key] = _logit((c["tau_1"] - lo) / (hi - lo))
        p["u_tau_Rinf"] = _logit((c["tau_Rinf"] - lo) / (hi - lo))
    if "R_rq" in c:
        lr = np.log([float(v) for v in data.rq_tau_bounds])
        p["R_rq_raw"] = np.log(c["R_rq"])
        p["u_tau_rq"] = _logit((np.log(c["tau_rq"]) - lr[0])
                               / (lr[1] - lr[0]))
        p["u_phi_rq"] = _logit(c["phi_rq"])
        if "k_d" in c:
            lk = np.log([float(v) for v in data.k_bounds])
            p["u_k"] = _logit((np.log(c["k_d"]) - lk[0]) / (lk[1] - lk[0]))
    return {k: torch.as_tensor(np.asarray(v, float)) for k, v in p.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def drift_fits(request):
    model, dists, n_restarts = CASES[request.param]
    freq, times, Zb = _fleet(1)
    Z = Zb[0]
    kw = dict(drift_model=model, n_restarts=n_restarts, min_tau_drift=100.0,
              max_iter=25, random_seed=0)
    dkw = {} if dists is None else {"distributions": dists}
    a = JaxInverter(basis_freq=BASIS, **dkw)
    a.drift_map_fit(freq, Z, times, **kw)
    iv = _jax_ridge_init(freq, Z, dists)
    seeded, rand = inverter_starts(a._drift_cfg, None, 0, n_restarts, iv)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inverter_module, "init_drift_params",
                   port_init_from(seeded[None], rand[None], seen))
        b = Inverter(basis_freq=BASIS, device="cpu", dtype=torch.float64,
                     **dkw)
        b.drift_map_fit(freq, Z, times, **kw)
    return a, b, iv, seen[0], (freq, times, Z)


def _close(got, want, tol, what):
    want = np.asarray(want, float)
    np.testing.assert_allclose(np.asarray(got, float), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def test_drift_map_fit_matches_jax(drift_fits):
    a, b, iv, seen, (freq, times, Z) = drift_fits
    # the port's own ridge seed is the JAX package's
    for k, v in iv.items():
        _close(seen[k], v, SEED_TOL, k)
    assert b.fit_type == "map-drift"
    assert b.stan_model_name == a.stan_model_name
    name = list(a.distributions)[0]
    fa, fb = a.distribution_fits[name], b.distribution_fits[name]
    assert set(fa) == set(fb)
    for k in fa:
        _close(fb[k], fa[k], POLISH_TOL if k in COEF_KEYS else SCALAR_TOL,
               k)
    assert set(a.drift_offsets) == set(b.drift_offsets)
    for k in a.drift_offsets:
        _close(b.drift_offsets[k], a.drift_offsets[k], SCALAR_TOL, k)
    _close(b.R_inf, a.R_inf, SCALAR_TOL, "R_inf")
    # the inductance sits at its prior's floor here (JAX 1.5e-30 H in x1)
    np.testing.assert_allclose(b.inductance, a.inductance, rtol=SCALAR_TOL,
                               atol=1e-12)
    # the error structure against its largest term (sigma_res sits near
    # zero, ~1e-10, in x1)
    s_max = np.abs(a.error_fit["sigma_tot"]).max()
    for k, v in a.error_fit.items():
        np.testing.assert_allclose(b.error_fit[k], v, rtol=0, atol=SCALAR_TOL
                                   * (s_max if "sigma" in k else 1.0),
                                   err_msg=k)
    # the objective: the JAX optimum's, by the port's density (held to the
    # JAX package's at 1e-10 in test_torch_drift.py)
    cfg, data = b._drift_cfg, _port_data(b, freq, times, Z)
    want = -drift.drift_log_density(cfg, data, _unconstrain(
        cfg, data, {k: np.asarray(v) for k, v in a._drift_result.items()}))
    np.testing.assert_allclose(b._map_result.value, float(want),
                               rtol=VALUE_TOL)
    assert b._map_n_iter_lbfgs == 25
    assert 25 < int(b._map_result.n_iter) <= 25 + 100
    assert set(b.timings.summary()) == {"ridge_init", "lbfgs", "polish"}
    np.testing.assert_allclose(b.predict_Z_drift(freq, times),
                               a.predict_Z_drift(freq, times),
                               rtol=SCALAR_TOL)


def _port_data(inv, freq, times, Z):
    name = list(inv.distributions)[0]
    mats = inv.distribution_matrices[name]
    tau = inv.distributions[name]["tau"]
    f_coll = 1.0 / (2 * np.pi * tau)
    eps = inv.distributions[name]["epsilon"]
    L = np.stack([1.5 * s * inv._matrix(inverter_module.construct_L, f_coll,
                                        tau=tau, basis=inv.basis,
                                        epsilon=eps, order=o)
                  for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])
    zs = Z / inv._Z_scale
    return inverter_module.drift_data(
        freq, times, mats["A_re"], mats["A_im"], L,
        np.concatenate([zs.real, zs.imag]), tau, 0.002, 1.0, 100.0, 1e4,
        torch.float64, torch.device("cpu"))


def test_drift_routing_and_save_load(drift_fits):
    a, b, _, _, (freq, times, Z) = drift_fits
    np.testing.assert_array_equal(b.predict_Z(freq, times=times),
                                  b.predict_Z_drift(freq, times))
    tau = np.logspace(-6, 1, 50)
    np.testing.assert_array_equal(
        b.predict_distribution(eval_tau=tau, time=1800.0),
        b.predict_distribution_drift(1800.0, eval_tau=tau))
    for got, want in zip(b.predict_sigma(freq, times=times),
                         a.predict_sigma(freq, times=times)):
        np.testing.assert_allclose(got, want, rtol=SCALAR_TOL)
    np.testing.assert_allclose(b.score(freq, Z, times=times),
                               a.score(freq, Z, times=times), rtol=1e-4)
    with pytest.raises(ValueError, match="requires times"):
        b.predict_Z(freq)
    with pytest.raises(ValueError, match="not available for drift"):
        b.predict_distribution(eval_tau=tau, time=0.0, percentile=50)
    # peaks of the time-t distribution route through predict_distribution
    # (a DDT's Rp needs predict_Z without times, which raises in both
    # packages)
    if "DRT" in b.distributions:
        assert b.predict_Rp(time=1800.0) == pytest.approx(b.predict_Rp())
        b.fit_peaks(time=1800.0)
        assert b.distribution_fits["DRT"]["peak_params"].size % 4 == 0
    # a port map-drift state round trip predicts bit for bit
    c = Inverter(device="cpu", dtype=torch.float64)
    c.load_fit_data(b.save_fit_data())
    np.testing.assert_array_equal(c.predict_Z(freq, times=times),
                                  b.predict_Z(freq, times=times))


def test_drift_ridge_init_catches_only_numerical_failures(monkeypatch):
    """A numerical failure of the drift fit's ridge seed warns and the fit
    goes on from a random seeded start (the JAX package's behaviour); a
    device or kernel-build error propagates."""
    freq, times, Zb = _fleet(1)

    def failing(exc):
        def ridge_fit(self, *args, **kwargs):
            raise exc
        return ridge_fit

    inv = Inverter(basis_freq=BASIS, device="cpu", dtype=torch.float64)
    monkeypatch.setattr(Inverter, "ridge_fit",
                        failing(np.linalg.LinAlgError("singular")))
    with pytest.warns(UserWarning, match="Ridge initialization"):
        inv.drift_map_fit(freq, Zb[0], times, max_iter=3, n_restarts=1,
                          polish=False)
    assert inv.fit_type == "map-drift"
    for exc in (RuntimeError("CUDA error: an illegal memory access"),
                RuntimeError("nvcc failed for csrc/quad.cu")):
        monkeypatch.setattr(Inverter, "ridge_fit", failing(exc))
        with pytest.raises(RuntimeError, match=str(exc)[:10]):
            inv.drift_map_fit(freq, Zb[0], times, max_iter=3, polish=False)


def test_drift_validation_errors():
    freq, times, Zb = _fleet(1)
    inv = Inverter(basis_freq=BASIS, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="Invalid drift_model"):
        inv.drift_map_fit(freq, Zb[0], times, drift_model="bogus")
    with pytest.raises(ValueError, match="times must have same length"):
        inv.drift_map_fit(freq, Zb[0], times[:-2])
    with pytest.raises(ValueError, match="requires a drift_map_fit"):
        inv.predict_Z_drift(freq, times)
    with pytest.raises(ValueError, match="requires a drift_map_fit"):
        inv.predict_distribution_drift(0.0)
    multi = Inverter(distributions={"a": {"kernel": "DRT"},
                                    "b": {"kernel": "DDT"}}, device="cpu")
    with pytest.raises(ValueError, match="single distribution"):
        multi.drift_map_fit(freq, Zb[0], times)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inv.ridge_fit(freq, Zb[0])
    for call in (lambda: inv.predict_Z(freq, times=times),
                 lambda: inv.predict_distribution(time=0.0),
                 lambda: inv.predict_sigma(freq, times=times)):
        with pytest.raises(ValueError, match="only valid for drift"):
            call()
