"""The port's Inverter.fit (MAP and sampling), check_outliers, its
validation errors, the methods that wait for later items, and save/load
across the two packages (float64 on the CPU; the JAX side as the JAX
package's tests run it, with x64 on)."""

import warnings

import jax
import numpy as np
import pytest
import torch

from bayes_drt_tpu import Inverter as JaxInverter
from bayes_drt_tpu.infer import diagnostics as jax_diag
from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu_torch import Inverter, sim
from bayes_drt_tpu_torch import inverter as inverter_module
from bayes_drt_tpu_torch.models.posterior import log_density
from jax_noise_reference import (jax_chees_stream, jax_nuts_stream,
                                 jax_shmc_stream)
from test_torch_viz import plotted_data, plt

torch.set_num_threads(1)

# MAP against the JAX package's certified float64 optimum: coefficients
# within 1e-5 of the largest
MAP_TOL = 1e-5
# predictions from one saved state in both packages
PRED_RTOL = 1e-10
# sampled fits replaying the JAX package's starts and random numbers: the
# two packages' last-bit differences grow ~1e3-fold every 10 draws on this
# posterior (warmup's large step sizes), so the budgets are short and the
# draws, coefficient means, R_inf, inductance (relative; the coefficients
# of the largest) and the host diagnostics are held within 1e-6; the
# gamma RMSE below 8% of Rp (the JAX package's test_inverter.py bar)
REPLAY_RTOL = 1e-6
GATE_RMSE = 0.08

FREQ = np.logspace(4, 0, 21)
BASIS = np.logspace(4.5, -0.5, 26)
Z = sim.add_simple_noise(sim.reference_circuit("ZARC", FREQ), 5, 0.0025)[0]
TAU_GT = np.logspace(-8, 3, 500)
RP = np.trapezoid(sim.zarc_drt(TAU_GT, 1e-3, 0.8), np.log(TAU_GT))


def _port(**kw):
    return Inverter(basis_freq=BASIS, device="cpu", dtype=torch.float64,
                    **kw)


def _rmse_over_rp(inv):
    tau = inv.distributions["DRT"]["tau"]
    g = inv.predict_distribution(eval_tau=tau)
    return np.sqrt(np.mean((g - sim.zarc_drt(tau, 1e-3, 0.8)) ** 2)) / RP


# the MAP parity spectrum: the JAX package's MAP test's noise model
# (Macdonald) and seed; its posterior has two optima, each reached from
# some of the random starts in either package, and 4000 L-BFGS
# iterations amplify last-bit differences, so the port starts from the
# JAX package's own start
MAP_FREQ = np.logspace(4, 0, 25)
MAP_Z = sim.add_model_noise(sim.reference_circuit("ZARC", MAP_FREQ), 3,
                            0.005, 0.005, "Macdonald")[0]


@pytest.fixture(scope="module")
def jax_map():
    inv = JaxInverter()
    inv.fit(MAP_FREQ, MAP_Z, init_from_ridge=True, random_seed=0)
    assert bool(inv._map_result.converged)
    return inv


@pytest.fixture(scope="module")
def port_map(jax_map):
    cfg, data = jax_map._posterior
    start = {k: np.array(v) for k, v in jax_init(
        cfg, data, jax.random.PRNGKey(0),
        init_values=jax_map._init_params).items()}

    def jax_start(cfg, data, gen, batch_shape=(), init_values=None):
        return {k: torch.as_tensor(v, dtype=data.freq.dtype).expand(
            tuple(batch_shape) + v.shape).clone() for k, v in start.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inverter_module, "init_unconstrained", jax_start)
        inv = Inverter(device="cpu", dtype=torch.float64)
        inv.fit(MAP_FREQ, MAP_Z, init_from_ridge=True, random_seed=0)
    return inv


def test_map_from_ridge_matches_jax(jax_map, port_map):
    a, b = jax_map, port_map
    assert b.fit_type == "map" and b.stan_model_name == "Series"
    assert bool(b._map_result.converged)
    x0 = a._init_params["x_0"]
    np.testing.assert_allclose(b._init_params["x_0"], x0, rtol=1e-8,
                               atol=1e-8 * np.abs(x0).max())
    ca = a.distribution_fits["DRT"]["coef"]
    scale = np.abs(ca).max()
    np.testing.assert_allclose(b.distribution_fits["DRT"]["coef"], ca,
                               rtol=0, atol=MAP_TOL * scale)
    np.testing.assert_allclose(b.R_inf, a.R_inf, rtol=0,
                               atol=MAP_TOL * scale)
    np.testing.assert_allclose(b._opt_result["lp__"], a._opt_result["lp__"],
                               rtol=MAP_TOL)
    # the error structure: sigma_tot and sigma_res within 1e-5 of the
    # largest sigma_tot, the (dimensionless, near-zero) alphas within 1e-5
    s_max = np.abs(a.error_fit["sigma_tot"]).max()
    for k, atol in (("sigma_tot", MAP_TOL * s_max),
                    ("sigma_res", MAP_TOL * s_max), ("alpha_prop", MAP_TOL),
                    ("alpha_re", MAP_TOL), ("alpha_im", MAP_TOL)):
        np.testing.assert_allclose(b.error_fit[k], a.error_fit[k], rtol=0,
                                   atol=atol, err_msg=k)
    assert set(b.timings.summary()) == {"ridge_init", "lbfgs", "polish"}
    # the JAX package's MAP quick-start figures
    tau = b.distributions["DRT"]["tau"]
    g = b.predict_distribution()
    assert np.sqrt(np.mean((g - sim.zarc_drt(tau, 1e-3, 0.8)) ** 2)) \
        < 0.08 * RP
    assert abs(b.R_inf - 1.0) < 0.05
    s_re, _ = b.predict_sigma(MAP_FREQ)
    assert s_re.shape == (len(MAP_FREQ),)
    s_re2, _ = b.predict_sigma(MAP_FREQ[:10])
    assert s_re2.shape == (10,)


def test_map_restarts_density_fn_and_model_data():
    """MAP from 2 restarts (cap cut to 1000) meets the gates; a
    log_density_fn (autograd instead of the hand-written gradient) is
    the one called and follows the default's L-BFGS iterates;
    add_model_data replaces posterior fields."""
    b = _port()
    b.fit(FREQ, Z, random_seed=1, nonneg=True, max_iter=1000)
    assert _rmse_over_rp(b) < 0.08 and abs(b.R_inf - 1.0) < 0.05
    assert b.predict_distribution().min() > -1e-10
    calls = []

    def density(*args, **kw):
        calls.append(1)
        return log_density(*args, **kw)

    short = dict(random_seed=1, max_iter=20, polish=False)
    c, d = _port(), _port()
    c.fit(FREQ, Z, **short)
    d.fit(FREQ, Z, log_density_fn=density, **short)
    assert calls
    cc = c.distribution_fits["DRT"]["coef"]
    np.testing.assert_allclose(d.distribution_fits["DRT"]["coef"], cc,
                               rtol=0, atol=1e-8 * np.abs(cc).max())
    e = _port()
    e.fit(FREQ, Z, add_model_data={"ups_alpha": 0.5, "x_scales": [2.0]},
          **short)
    assert float(e._posterior[1].ups_alpha) == 0.5
    assert float(e._posterior[1].x_scales[0]) == 2.0
    assert np.isfinite(e.distribution_fits["DRT"]["coef"]).all()


@pytest.mark.parametrize("sampler,budget", [
    ("nuts", dict(warmup=20, samples=10, max_tree_depth=5)),
    ("shmc", dict(warmup=30, samples=10)),
    ("chees", dict(warmup=30, samples=10))])
def test_sample_matches_jax(sampler, budget):
    """Tiny sampled fits (ridge-seeded, non-centered, 2 chains): the port's
    Inverter, started from the JAX package's chain starts and replaying
    the random numbers of its key schedule, reproduces the JAX package's
    fit: the draws in their (chains, samples) layout, every coefficient's
    posterior mean and the host diagnostics. Then the gamma RMSE gate, the
    diagnostics' keys and the percentile predictions' order."""
    kw = dict(mode="sample", sampler=sampler, chains=2, random_seed=1,
              init_from_ridge=True, ncp=True, **budget)
    a = JaxInverter(basis_freq=BASIS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.fit(FREQ, Z, **kw)
    # the JAX Inverter's key schedule (inverter.py:895, :870-887)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    k_inits, k_runs = zip(*(jax.random.split(k) for k in keys))
    cfg_j, data_j = a._posterior
    starts = [jax_init(cfg_j, data_j, k, init_values=a._init_params)
              for k in k_inits]
    start = {n: np.stack([np.asarray(s[n]) for s in starts])
             for n in starts[0]}
    dim = a._raw_draws.shape[-1]
    n_draws = budget["warmup"] + budget["samples"]
    if sampler == "nuts":
        noise = jax_nuts_stream(k_runs, dim, budget["max_tree_depth"],
                                n_draws)
        name, run = "sample_nuts", inverter_module.sample_nuts
    else:
        # pooled chains draw from the first chain key, n_steps 32 a draw
        noise = jax_shmc_stream(keys[:1], dim, 2, [32] * n_draws)
        name, run = "sample_shmc", inverter_module.sample_shmc
    if sampler == "chees":
        # pooled chains draw from the first chain key, leaf uniforms to
        # the default max_steps
        noise = jax_chees_stream(keys[:1], dim, 2, 128, n_draws)
        name, run = "sample_chees", inverter_module.sample_chees

    def jax_start(cfg, data, gen, batch_shape=(), init_values=None):
        return {k: torch.as_tensor(v, dtype=data.freq.dtype)
                for k, v in start.items()}

    def replay(*args, generator=None, **kwargs):
        return run(*args, noise=lambda: iter(noise), **kwargs)

    b = _port()
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(inverter_module, "init_unconstrained", jax_start)
        mp.setattr(inverter_module, name, replay)
        b.fit(FREQ, Z, **kw)
    np.testing.assert_allclose(b._raw_draws, a._raw_draws, rtol=REPLAY_RTOL,
                               atol=REPLAY_RTOL)
    ca = a.distribution_fits["DRT"]["coef"]
    np.testing.assert_allclose(b.distribution_fits["DRT"]["coef"], ca,
                               rtol=0, atol=REPLAY_RTOL * np.abs(ca).max())
    for k in ("R_inf", "inductance"):
        np.testing.assert_allclose(getattr(b, k), getattr(a, k),
                                   rtol=REPLAY_RTOL, err_msg=k)
    # the rank-normalized diagnostics are discontinuous where two draws
    # nearly tie, so they are held to the JAX package's estimators on the
    # port's own draws (the estimators are held to each other in
    # test_torch_host_pieces.py); the rest to the JAX package's fit
    sd = b.sample_diagnostics
    ranked = {"rhat_rank": jax_diag.rhat_rank, "ess_bulk": jax_diag.ess_bulk,
              "ess_tail": jax_diag.ess_tail}
    for k, fn in ranked.items():
        want = fn(b._raw_draws)
        np.testing.assert_allclose(sd[k], want, rtol=1e-10, err_msg=k)
        np.testing.assert_allclose(
            sd[{"rhat_rank": "rank_rhat_max"}.get(k, k + "_min")],
            (np.max if k == "rhat_rank" else np.min)(want), rtol=1e-10)
    for k, v in a.sample_diagnostics.items():
        if k not in ("wall_time_s", "ess_per_sec", "rank_rhat_max",
                     "ess_bulk_min", "ess_tail_min", *ranked):
            np.testing.assert_allclose(sd[k], v, rtol=REPLAY_RTOL,
                                       err_msg=k)
    assert b.fit_type == "bayes"
    assert _rmse_over_rp(b) < GATE_RMSE

    assert set(a.sample_diagnostics) <= set(b.sample_diagnostics)
    n_draws = 2 * budget["samples"]
    assert b._raw_draws.shape[:2] == (2, budget["samples"])
    assert b._sample_result["Z_hat"].shape == (n_draws, 2 * len(FREQ))
    assert len(b.sample_diagnostics["draw_s"]) == (budget["warmup"]
                                                   + budget["samples"])
    glo = b.predict_distribution(percentile=2.5)
    ghi = b.predict_distribution(percentile=97.5)
    assert np.all(ghi >= glo - 1e-12)
    z_lo = b.predict_Z(FREQ, percentile=2.5)
    z_hi = b.predict_Z(FREQ, percentile=97.5)
    assert np.all(z_hi.real >= z_lo.real - 1e-12)
    assert (b.predict_Rp(percentile=2.5) <= b.predict_Rp()
            <= b.predict_Rp(percentile=97.5))
    assert b.predict_Z_distribution(FREQ[:5]).shape == (n_draws, 5)
    s_lo, _ = b.predict_sigma(FREQ[:5], percentile=50)
    assert np.isfinite(s_lo).all()


def test_check_outliers_flags_corrupted_point():
    zc = Z.copy()
    zc[7] *= 1.0 + 0.5j
    b = _port()
    idx = b.check_outliers(FREQ, zc, threshold=3.5)
    assert 7 in set(idx.ravel())
    a = JaxInverter(basis_freq=BASIS)
    np.testing.assert_array_equal(idx, a.check_outliers(FREQ, zc,
                                                        threshold=3.5))
    with pytest.warns(UserWarning, match="outlier"):
        b.fit(FREQ, zc, outliers="auto", random_seed=0, max_iter=100,
              polish=False)
    assert b.stan_model_name.endswith("_outliers")
    assert b.error_fit["sigma_out"].shape == (len(FREQ),)


def test_fit_validation_and_unported_methods():
    """fit's validation errors; the drift and peak methods, which now run
    (held to the JAX package: its errors before a drift fit, and the
    peak methods on the same ridge fit at 1e-6); the plotting wrappers,
    held to the JAX package's plots of that fit."""
    b = _port()
    with pytest.raises(ValueError, match="Invalid mode"):
        b.fit(FREQ, Z, mode="map")
    with pytest.raises(ValueError, match="Unknown sampler"):
        b.fit(FREQ, Z, mode="sample", sampler="hmc")
    # sampler='chees' runs (replayed against the JAX package in
    # test_sample_matches_jax): both packages' fits at a short budget give
    # the same diagnostics, the chains' step sizes, finite coefficients
    from bayes_drt_tpu.infer.chees import ChEESConfig as JaxChEESConfig
    from bayes_drt_tpu_torch.infer.chees import ChEESConfig
    ch = dict(mode="sample", sampler="chees", chains=2, warmup=20,
              samples=10, ncp=True, random_seed=2)
    a = JaxInverter(basis_freq=BASIS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.fit(FREQ, Z, chees_cfg=JaxChEESConfig(max_steps=16), **ch)
        b.fit(FREQ, Z, chees_cfg=ChEESConfig(max_steps=16), **ch)
    assert set(a.sample_diagnostics) <= set(b.sample_diagnostics)
    assert b._raw_draws.shape == a._raw_draws.shape
    assert b.sample_diagnostics["step_size"].shape == (2,)
    assert np.isfinite(b.distribution_fits["DRT"]["coef"]).all()
    with pytest.raises(ValueError, match="add_model_data"):
        b.fit(FREQ, Z, add_model_data={"nope": 1.0}, max_iter=5)
    multi = Inverter(distributions={"a": {"kernel": "DRT"},
                                    "b": {"kernel": "DDT"}}, device="cpu")
    with pytest.raises(ValueError, match="single-distribution"):
        multi.fit(FREQ, Z, init_from_ridge=True)
    a = JaxInverter(basis_freq=BASIS)
    times = np.linspace(0.0, 1000.0, len(FREQ))
    for call in (lambda inv: inv.drift_map_fit(FREQ, Z, times[:-1]),
                 lambda inv: inv.drift_map_fit(FREQ, Z, times,
                                               drift_model="bogus"),
                 lambda inv: inv.predict_Z_drift(FREQ, times),
                 lambda inv: inv.predict_distribution_drift(0.0)):
        with pytest.raises(ValueError) as want:
            call(a)
        with pytest.raises(ValueError) as got:
            call(b)
        assert str(got.value) == str(want.value)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.ridge_fit(FREQ, Z)
        b.ridge_fit(FREQ, Z)
    for inv in (a, b):
        inv.fit_peaks()
    np.testing.assert_allclose(b.distribution_fits["DRT"]["peak_params"],
                               a.distribution_fits["DRT"]["peak_params"],
                               rtol=1e-6, atol=1e-6)
    for name, args in (("predict_peak_distribution", ()),
                       ("predict_peak_Z", (FREQ,)),
                       ("score_peak_fit", ())):
        np.testing.assert_allclose(getattr(b, name)(*args),
                                   getattr(a, name)(*args), rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    for k, v in a.extract_peak_info().items():
        np.testing.assert_allclose(b.extract_peak_info()[k], v, rtol=1e-6)
    for inv in (a, b):
        inv.fit_peaks_constrained([1e-3])
    np.testing.assert_allclose(b.distribution_fits["DRT"]["peak_params"],
                               a.distribution_fits["DRT"]["peak_params"],
                               rtol=1e-6, atol=1e-6)
    # the plotting wrappers (item 11f, ported) draw the JAX package's
    # plots of the same ridge fit, their data within 1e-6
    for name in ("plot_distribution", "plot_fit", "plot_residuals",
                 "plot_full_results", "plot_peak_fit"):
        fig_a = np.ravel(getattr(a, name)())[0].get_figure()
        fig_b = np.ravel(getattr(b, name)())[0].get_figure()
        got, want = plotted_data(fig_b), plotted_data(fig_a)
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
        plt.close(fig_a)
        plt.close(fig_b)


def test_jax_saved_fit_predicts_in_the_port(jax_map):
    """The JAX package's save_fit_data(which='core') dict loads into the
    port's Inverter: Z, gamma and sigma at 1e-10 of the JAX package's own
    predictions, at the training grid and a new one."""
    a = jax_map
    b = Inverter(device="cpu")
    b.load_fit_data(a.save_fit_data(which="core"))
    assert b.fit_type == "map"
    tau = np.logspace(-6, 1, 40)
    f_new = np.logspace(3.5, -0.5, 13)
    for f in (MAP_FREQ, f_new):
        np.testing.assert_allclose(b.predict_Z(f), a.predict_Z(f),
                                   rtol=PRED_RTOL)
        for got, want in zip(b.predict_sigma(f), a.predict_sigma(f)):
            np.testing.assert_allclose(got, want, rtol=PRED_RTOL)
    np.testing.assert_allclose(b.predict_distribution(eval_tau=tau),
                               a.predict_distribution(eval_tau=tau),
                               rtol=PRED_RTOL, atol=1e-14)


def test_port_save_load_round_trip(port_map, tmp_path):
    """A pickle written by the port restores a fit that predicts the same
    Z bit for bit; every saved value is numpy or a Python scalar."""
    path = str(tmp_path / "fit.pkl")
    port_map.save_fit_data(path)
    state = port_map.save_fit_data()

    def leaves(v):
        if isinstance(v, dict):
            for x in v.values():
                yield from leaves(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                yield from leaves(x)
        else:
            yield v

    assert not any(isinstance(v, torch.Tensor) for v in leaves(state))
    fresh = Inverter(device="cpu")
    fresh.load_fit_data(path)
    for f in (MAP_FREQ, np.logspace(3, -1, 9)):
        np.testing.assert_array_equal(fresh.predict_Z(f),
                                      port_map.predict_Z(f))
