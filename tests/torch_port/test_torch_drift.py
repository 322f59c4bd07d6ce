"""The port's drift models (models/drift.py), drift_fit_spectra_batch's
parallel forms, its validation and median rule, and drift state across
the packages, against the JAX package in float64 on the CPU (the JAX side
with x64 on, as its own tests run it). Fixtures come from the drift
bench's fleet (benchmarks/bench_drift.py:make_fleet), thinned."""

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu import Inverter as JaxInverter
from bayes_drt_tpu.models import drift as jax_drift
from bayes_drt_tpu.ops.matrices import construct_A, construct_L
from bayes_drt_tpu.parallel import drift_fit_spectra_batch as jax_fleet
from bayes_drt_tpu_torch import Inverter, convert
from bayes_drt_tpu_torch.models import drift
from bayes_drt_tpu_torch.parallel import batch
from bayes_drt_tpu_torch.parallel import drift_fit_spectra_batch
from jax_drift_reference import fleet_starts, port_init_from

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "benchmarks"))
from bench_drift import make_fleet  # noqa: E402

torch.set_num_threads(1)

# density, gradient, constrained values and prediction: 1e-10 of the
# largest entry of each
DENSITY_TOL = 1e-10
# the fleet at 25 L-BFGS iterations from the JAX package's starts: each
# drift parameter within 1e-5 of its largest entry (measured: 1.1e-6 at
# worst, an alpha of RQ-lin parallel), the objective within 1e-6
FLEET_TOL = 1e-5
VALUE_TOL = 1e-6
# predictions from one saved state in both packages
PRED_RTOL = 1e-10

MODELS = jax_drift.DRIFT_MODELS
BASIS = np.logspace(5.5, -1.5, 22)
TAU = 1.0 / (2 * np.pi * BASIS)
PARALLEL = {"P": {"kernel": "DDT", "dist_type": "parallel",
                  "bc": "blocking"}}


def _fleet(b=2, step=3, even=False):
    """The bench fleet's first b cells at every step-th point (31 of its
    93), or its first 30 of those (an even count)."""
    freq, times, Zb = make_fleet(b, seed=0)
    n = 30 if even else None
    return freq[::step][:n], times[::step][:n], Zb[:, ::step][:, :n]


def _jax_data(freq, times, target, dist_type="series"):
    kw = dict(tau=TAU, epsilon=1.0 / np.mean(np.diff(np.log(TAU))))
    if dist_type == "parallel":
        kw.update(kernel="DDT", dist_type="parallel", bc="blocking")
    A_re = np.asarray(construct_A(freq, "real", **kw))
    A_im = np.asarray(construct_A(freq, "imag", **kw))
    L = np.stack([1.5 * s * np.asarray(construct_L(
        BASIS, tau=TAU, epsilon=kw["epsilon"], order=o))
        for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])
    a = jnp.asarray
    return jax_drift.DriftData(
        A_re=a(A_re), A_im=a(A_im), L=a(L), Z=a(target), freq=a(freq),
        times=a(times), sigma_min=a(0.002), ups_alpha=a(0.05),
        ups_beta=a(0.1), induc_scale=a(1.0), tau_bounds=a([100.0, 1e4]),
        tau2_bounds=a([500.0, 1e4]),
        rq_tau_bounds=a([TAU.min(), TAU.max()]), k_bounds=a([1e-4, 1.0]),
        t_max=a(times.max()), t_min=a(times.min()))


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("dist_type", ["series", "parallel"])
def test_density_matches_jax(model, dist_type):
    """Value and gradient (with and without the Jacobian), constrain_drift
    and predict_drift_target on 3 cells from the JAX package's inits,
    nonneg off and on (a parallel distribution's coefficients are
    positive either way, so it runs nonneg off only)."""
    freq, times, Zb = _fleet(3)
    zs = np.std(np.abs(Zb), axis=1) / np.sqrt(len(freq) / 81)
    T = np.concatenate([(Zb / zs[:, None]).real, (Zb / zs[:, None]).imag],
                       axis=1)
    jd = _jax_data(freq, times, T[0], dist_type)
    for nonneg in (False, True) if dist_type == "series" else (False,):
        cfg = jax_drift.DriftConfig(model, dist_type, nonneg, len(TAU))
        pcfg, pdata = convert.drift_from_numpy(cfg, jd._replace(Z=T),
                                               dtype=torch.float64,
                                               device="cpu")
        rows, want_v, want_g = [], [], []
        for i in range(3):
            d_i = jd._replace(Z=jnp.asarray(T[i]))
            p = jax_drift.init_drift_params(cfg, d_i, jax.random.PRNGKey(i))
            q, unravel = ravel_pytree(p)
            rows.append(convert.drift_rows_from_numpy(
                pcfg, {k: np.asarray(v) for k, v in p.items()},
                dtype=torch.float64, device="cpu"))
            np.testing.assert_array_equal(rows[-1].numpy(), np.asarray(q))
            for jac in (False, True):
                v, g = jax.value_and_grad(lambda qq: jax_drift.drift_log_density(
                    cfg, d_i, unravel(qq), jacobian=jac))(q)
                want_v.append(float(v))
                want_g.append(np.asarray(g))
            c = jax_drift.constrain_drift(cfg, d_i, p)
            pc = drift.constrain_drift(pcfg, pdata._replace(Z=pdata.Z[i]),
                                       drift.unravel_drift(pcfg, rows[-1]))
            assert set(pc) == set(c)
            for k in c:
                _close(pc[k].numpy(), c[k], DENSITY_TOL, k)
            _close(drift.predict_drift_target(pcfg, pdata, pc).numpy(),
                   jax_drift.predict_drift_target(cfg, d_i, c), DENSITY_TOL,
                   "prediction")
        q = torch.stack(rows)
        for j, jac in enumerate((False, True)):
            v, g = drift.drift_value_and_grad(pcfg, pdata, jacobian=jac)(q)
            _close(v.numpy(), want_v[j::2], DENSITY_TOL, "value")
            _close(g.numpy(), np.array(want_g[j::2]), DENSITY_TOL, "grad")
        back = convert.drift_rows_to_numpy(pcfg, q)
        assert sorted(back) == sorted(p)
        np.testing.assert_array_equal(
            convert.drift_rows_from_numpy(pcfg, back, dtype=torch.float64,
                                          device="cpu").numpy(), q.numpy())


@pytest.mark.parametrize("model", ["x1", "RQ"])
def test_fleet_parallel_matches_jax(model):
    """drift_fit_spectra_batch on a parallel blocking DDT (neutral starts:
    the series ridge seed does not apply, and both packages warn), from
    the JAX package's own draws, held at 25 L-BFGS iterations. The series
    forms of all eight models are test_torch_drift_fleet.py's. Of the
    other parallel forms, x2, dx, dx-lin and RQ-from-final agreed within
    2.4e-7 at N = 31 when measured and are left out for time; RQ-lin and
    RQ-lin-from-final part by up to 1.1e-6 at 25 iterations on this grid
    (L-BFGS amplifies last-bit differences fastest on their stiff
    parallel posteriors) and are held by the density alone."""
    freq, times, Zb = _fleet()
    kw = dict(drift_model=model, n_restarts=2, min_tau_drift=100.0,
              max_iter=25, basis_freq=BASIS, random_seed=0,
              distributions=PARALLEL)
    with pytest.warns(UserWarning, match="neutral"):
        want = jax_fleet(freq, times, Zb, **kw)
    cfg = jax_drift.DriftConfig(model, "parallel", False, len(TAU))
    seeded, rand = fleet_starts(cfg, None, freq, Zb, TAU, 0, 2,
                                init_from_ridge=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch, "init_drift_params", port_init_from(seeded, rand))
        with pytest.warns(UserWarning, match="neutral"):
            got = drift_fit_spectra_batch(freq, times, Zb, device="cpu",
                                          dtype=torch.float64, **kw)
    _assert_fleet_close(got, want)


def _assert_fleet_close(got, want):
    d, dj = got.diagnostics, want.diagnostics
    np.testing.assert_allclose(d["value"], dj["value"], rtol=VALUE_TOL)
    np.testing.assert_array_equal(d["n_iter"], dj["n_iter"])
    assert d["n_iter"].dtype == np.float32
    assert set(d["drift"]) == set(dj["drift"])
    for k, v in dj["drift"].items():
        _close(d["drift"][k], v, FLEET_TOL, k)
    np.testing.assert_allclose(d["median_rel_resid"], dj["median_rel_resid"],
                               rtol=FLEET_TOL)
    for name in ("coef", "r_inf", "inductance", "z_scales", "tau"):
        _close(getattr(got, name), getattr(want, name), FLEET_TOL, name)
    assert got.epsilon == pytest.approx(want.epsilon, rel=1e-14)
    assert d["drift_model"] == dj["drift_model"]


def test_median_even_count_matches_jnp():
    """The residual median averages the two middle values of an even count
    (jnp.median's rule; torch.median takes the lower), bit for bit; the
    fleet on an even count is test_torch_drift_fleet.py's x1 case."""
    x = torch.as_tensor(np.random.default_rng(0).random((3, 62)))
    np.testing.assert_array_equal(
        batch._median_last(x).numpy(), np.asarray(jnp.median(x.numpy(), 1)))
    assert (batch._median_last(x) != torch.median(x, dim=1).values).all()


def test_sim_drift_fixtures_match_the_bench_and_the_test():
    """sim.make_drift_fleet is the drift bench's make_fleet and
    sim.make_drifting_spectrum the JAX drift test's spectrum, exactly."""
    from bayes_drt_tpu_torch import sim
    from test_drift import make_drifting_spectrum
    for got, want in zip(sim.make_drift_fleet(5, seed=3),
                         make_fleet(5, seed=3)):
        np.testing.assert_array_equal(got, want)
    for model in ("RQ", "x1"):
        for got, want in zip(sim.make_drifting_spectrum(model),
                             make_drifting_spectrum(model)):
            np.testing.assert_array_equal(got, want)


def test_fleet_validation_errors():
    freq, times, Zb = _fleet()
    kw = dict(device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="Invalid drift_model"):
        drift_fit_spectra_batch(freq, times, Zb, drift_model="bogus", **kw)
    with pytest.raises(ValueError, match="times must have same length"):
        drift_fit_spectra_batch(freq, times[:-1], Zb, **kw)
    with pytest.raises(ValueError, match="Z_batch must be"):
        drift_fit_spectra_batch(freq, times, Zb[:, :-1], **kw)
    with pytest.raises(ValueError, match="single distribution"):
        drift_fit_spectra_batch(freq, times, Zb, distributions={
            "a": {"kernel": "DRT"}, "b": {"kernel": "DRT"}}, **kw)
    # mesh= (ported with the device mesh): the padded fleet of 8 on 8
    # virtual CPU shards in both packages, the same layout and shapes
    # (the JAX mesh test's rank-1 inits shard too), finite cells
    from bayes_drt_tpu.parallel import make_mesh as jax_make_mesh
    from bayes_drt_tpu_torch.parallel import make_mesh
    mkw = dict(drift_model="x1", n_restarts=1, max_iter=30)
    got = drift_fit_spectra_batch(freq, times, Zb, **kw, **mkw,
                                  mesh=make_mesh(8, device="cpu"))
    want = jax_fleet(freq, times, Zb, mesh=jax_make_mesh(8), **mkw)
    assert got.diagnostics["shard_layout"] == want.diagnostics["shard_layout"]
    assert got.coef.shape == want.coef.shape
    assert np.isfinite(got.coef).all()
    if not torch.cuda.is_available():
        # the entry points run on CUDA unless the caller names the CPU
        from bayes_drt_tpu_torch import ecm, peaks
        for call in (lambda: drift_fit_spectra_batch(freq, times, Zb),
                     lambda: Inverter().drift_map_fit(freq, Zb[0], times),
                     lambda: peaks.fit_peaks(TAU, np.ones(len(TAU)), 1.0),
                     lambda: ecm.fit_ecm(freq, Zb[0], [("R", {"R": 1.0})])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


@pytest.mark.parametrize("model", ["x1", "RQ-lin-from-final"])
def test_jax_saved_drift_fit_predicts_in_the_port(model):
    """A JAX map-drift save_fit_data dict loads into the port's Inverter:
    predict_Z (with times), predict_Z_drift, the drift distribution at
    three times, predict_sigma and score at 1e-10 of the JAX package's."""
    freq, times, Zb = _fleet(1)
    a = JaxInverter(basis_freq=BASIS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.drift_map_fit(freq, Zb[0], times, drift_model=model, max_iter=60,
                        n_restarts=1, min_tau_drift=100.0, polish=False)
    b = Inverter(device="cpu")
    b.load_fit_data(a.save_fit_data())
    assert b.fit_type == "map-drift"
    tau = np.logspace(-7, 2, 50)
    f_new = np.logspace(4.5, -0.5, 17)
    t_new = np.linspace(0.0, 4000.0, 17)
    for f, t in ((freq, times), (f_new, t_new)):
        np.testing.assert_allclose(b.predict_Z(f, times=t),
                                   a.predict_Z(f, times=t), rtol=PRED_RTOL)
        for got, want in zip(b.predict_sigma(f, times=t),
                             a.predict_sigma(f, times=t)):
            np.testing.assert_allclose(got, want, rtol=PRED_RTOL)
    for t in (0.0, 1800.0, 5400.0):
        np.testing.assert_allclose(
            b.predict_distribution(eval_tau=tau, time=t),
            a.predict_distribution(eval_tau=tau, time=t), rtol=PRED_RTOL,
            atol=1e-14)
    np.testing.assert_allclose(b.score(freq, Zb[0], times=times),
                               a.score(freq, Zb[0], times=times),
                               rtol=PRED_RTOL)
    assert b.predict_Rp(time=1800.0) == pytest.approx(
        a.predict_Rp(time=1800.0), rel=PRED_RTOL)
    with pytest.raises(ValueError, match="requires times"):
        b.predict_Z(freq)
