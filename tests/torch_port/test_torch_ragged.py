"""fit_spectra_ragged and the per-spectrum posterior against the JAX
package in float64 on the CPU: the padded batch's setup (grids, masks,
scales, A stacks, L), the masked log density and its gradient, MAP from
matched starts, a sample-mode fit's outputs, the shared-grid identity,
and the bases other than the Gaussian."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu.models.posterior import log_density as jax_log_density
from bayes_drt_tpu.ops import basis as jax_basis
from bayes_drt_tpu.ops.matrices import construct_A as jax_construct_A
from bayes_drt_tpu.ops.matrices import construct_L as jax_construct_L
from bayes_drt_tpu.parallel import batch as jax_batch
from bayes_drt_tpu.infer import chees as jax_chees
from bayes_drt_tpu.infer.chees import SHMCConfig as JaxSHMCConfig
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer import chees
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.models.posterior import (posterior_value_and_grad,
                                                  unravel)
from bayes_drt_tpu_torch.ops import basis, matrices
from bayes_drt_tpu_torch.parallel import batch

torch.set_num_threads(1)

BASIS = np.logspace(4.5, -2.5, 15)
SP = {"DRT": {"kernel": "DRT", "basis_freq": BASIS},
      "TP-DDT": {"kernel": "DDT", "bc": "transmissive",
                 "dist_type": "parallel", "basis_freq": BASIS,
                 "x_scale": 0.8}}
# case -> fit_spectra_ragged options
CASES = {
    "series": dict(),
    "series_outliers": dict(outliers=True),
    "series_parallel": dict(distributions=SP, nonneg=True),
}


def _fleet(n=3, seed=0):
    """Three ZARC spectra on different grids (the ragged bench's recipe,
    thinned): lengths 24, 19 and 18, padded to 32."""
    return [(f[::4], z[::4]) for f, z in sim.make_ragged_fleet(n, seed)]


class _Stop(Exception):
    pass


def _jax_setup(monkeypatch, spectra, mode, **kw):
    """The JAX package's fit_spectra_ragged inputs, caught at its compiled
    program: (A stacks, targets, padded grids, masks, keys) and its
    PosteriorConfig / row-0 PosteriorData."""
    seen = {}
    build = jax_batch.build_posterior

    def spy_build(*a, **k):
        seen["posterior"] = build(*a, **k)
        return seen["posterior"]

    def stop_program(key, make):
        def run(*args):
            seen["args"] = args
            raise _Stop
        return run

    monkeypatch.setattr(jax_batch, "build_posterior", spy_build)
    monkeypatch.setattr(jax_batch, "_cached_program", stop_program)
    with pytest.raises(_Stop):
        jax_batch.fit_spectra_ragged(spectra, mode=mode, **kw)
    monkeypatch.undo()
    return seen["args"], seen["posterior"]


def _port_setup(spectra, mode, distributions=None, nonneg=False,
                outliers=False, ncp=False):
    return batch._ragged_setup(spectra, mode, None, None, nonneg, outliers,
                               distributions, "gaussian", 0.002, ncp,
                               torch.float64, "cpu")


def _close(got, want, rtol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_matches_jax(case, monkeypatch):
    """Padded grids, masks, z-scaled targets, every distribution's A stack
    (the DDT's built in several frequency-row chunks) and L against the
    JAX package's, rtol 1e-10."""
    kw = CASES[case]
    spectra = _fleet()
    args, (cfg_j, data_j) = _jax_setup(monkeypatch, spectra, "optimize",
                                       **kw)
    A_j, tgt_j, fp_j, mask_j = args[:4]
    monkeypatch.setattr(matrices, "_DDT_CHUNK", 15 * 1000 * 7)
    cfg, data, targets, z_scales, _, (tau, eps, _) = _port_setup(
        spectra, "optimize", **kw)
    assert cfg.model_name() == cfg_j.model_name()
    assert tuple(data.freq.shape) == (8, 32)
    np.testing.assert_array_equal(data.freq.numpy(), np.asarray(fp_j))
    np.testing.assert_array_equal(data.lik_mask.numpy(), np.asarray(mask_j))
    assert data.lik_mask.sum(dim=1)[:3].tolist() == [48.0, 38.0, 36.0]
    _close(targets.numpy(), tgt_j, 1e-12, "targets")
    for i in range(len(cfg.dists)):
        _close(data.A[i].numpy(), A_j[i], 1e-10, f"A_{i}")
        _close(data.L[i].numpy(), data_j.L[i], 1e-10, f"L_{i}")
    for name in ("sigma_min", "ups_alpha", "ups_beta", "x_sum_invscale",
                 "induc_scale"):
        assert getattr(data, name).item() == float(getattr(data_j, name))
    if case == "series":
        # the default basis: 10 ppd over the union of the grids plus a
        # decade at each end
        f_all = np.concatenate([f for f, _ in spectra])
        tmin = np.log10(1 / (2 * np.pi * f_all.max())) - 1
        tmax = np.log10(1 / (2 * np.pi * f_all.min())) + 1
        np.testing.assert_allclose(tau, np.logspace(
            tmin, tmax, int(10 * (tmax - tmin) + 1)), rtol=1e-15)
        zs = [np.std(np.abs(z)) / np.sqrt(len(z) / 81) for _, z in spectra]
        np.testing.assert_allclose(z_scales[:3], zs, rtol=1e-14)


def _jax_rows_vg(cfg_j, data_j, args, q, chains, jacobian):
    """JAX value and gradient of each row under its spectrum's masked
    per-spectrum data (the JAX ragged fit's dat._replace)."""
    A_j, tgt_j, fp_j, mask_j = args[:4]
    _, unravel_j = ravel_pytree(jax_init(cfg_j, data_j,
                                         jax.random.PRNGKey(0)))

    def one(A_rows, t, f, m, qq):
        d = data_j._replace(A=A_rows, target=t, freq=f, lik_mask=m)
        return jax.vmap(jax.value_and_grad(
            lambda x: jax_log_density(cfg_j, d, unravel_j(x),
                                      jacobian=jacobian)))(qq)

    b = tgt_j.shape[0]
    lp, g = jax.vmap(one)(A_j, tgt_j, fp_j, mask_j,
                          jnp.asarray(q).reshape(b, chains, -1))
    return np.asarray(lp).reshape(-1), np.asarray(g).reshape(b * chains, -1)


@pytest.mark.parametrize("mode", ["sample", "optimize"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_density_matches_jax(case, mode, monkeypatch):
    """The port's grouped autograd value and gradient over (b*C, D) rows
    equals JAX's log_density with each spectrum's A, grid and lik_mask
    (rtol 1e-10), in the sampling measure and the MAP objective."""
    kw = dict(CASES[case], ncp=mode == "sample")
    spectra = _fleet()
    args, (cfg_j, data_j) = _jax_setup(monkeypatch, spectra, mode, **kw)
    cfg, data, targets, _, _, _ = _port_setup(spectra, mode, **kw)
    chains = 3
    D = ravel_pytree(jax_init(cfg_j, data_j, jax.random.PRNGKey(0)))[0].size
    q = np.random.default_rng(5).uniform(-2, 2, (8 * chains, D))
    jac = mode == "sample"
    lp, g = posterior_value_and_grad(
        cfg, data, targets.repeat_interleave(chains, dim=0),
        jacobian=jac)(torch.as_tensor(q))
    lp_j, g_j = _jax_rows_vg(cfg_j, data_j, args, q, chains, jac)
    assert np.isfinite(lp.numpy()).all() and np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=1e-10)
    for r in range(len(q)):
        _close(g[r].numpy(), g_j[r], 1e-10, f"grad row {r}")


@pytest.mark.parametrize("n", [16, 13])
def test_identical_grids_give_the_shared_density(n):
    """A ragged batch whose grids are all one grid gives, per row, the
    shared-grid path's density and gradient; with n=13 the grid is padded
    to 16 and the padding, masked out, changes nothing."""
    freq = np.logspace(4, -1, n)
    _, zb = sim.make_benchmark_batch(8, freq=freq, seed=2)
    spectra = [(freq, z) for z in zb]
    cfg, data, targets, zs_r, _, _ = _port_setup(spectra, "sample",
                                                 nonneg=True, ncp=True)
    _, _, _, cfg_s, data_s, dists = batch._build_shared(
        freq, mode="sample", nonneg=True, ncp=True, dtype=torch.float64,
        device="cpu")
    zs, tgt_s = batch._scaled_targets(zb, 8, None, torch.float64,
                                      "cpu", dists)
    np.testing.assert_allclose(zs_r, zs, rtol=1e-15)
    chains = 2
    q = torch.as_tensor(np.random.default_rng(1).uniform(
        -2, 2, (16, data_s.A[0].shape[1] * 2 + 9)))
    lp_r, g_r = posterior_value_and_grad(
        cfg, data, targets.repeat_interleave(chains, dim=0))(q)
    lp_s, g_s = posterior_value_and_grad(
        cfg_s, data_s, tgt_s.repeat_interleave(chains, dim=0))(q)
    np.testing.assert_allclose(lp_r.numpy(), lp_s.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_r.numpy(), g_s.numpy(), rtol=1e-10,
                               atol=1e-12 * float(g_s.abs().max()))


def test_ragged_map_matches_jax_from_matched_starts(monkeypatch):
    """mode='optimize' at 15 L-BFGS iterations, no polish: the port from
    the JAX package's own random starts (every spectrum's restarts drawn
    from its key) reaches the JAX fit's coefficients, R_inf and objective
    (1e-8 of each spectrum's largest entry)."""
    spectra = _fleet()
    kw = dict(max_iter=15, n_restarts=2, random_seed=3)
    _, (cfg_j, data_j) = _jax_setup(monkeypatch, spectra, "optimize")
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    q0 = np.stack([[np.asarray(ravel_pytree(jax_init(cfg_j, data_j, k))[0])
                    for k in jax.random.split(keys[i], 2)] for i in range(8)])

    def matched_init(cfg, data, gen, batch_shape=(), init_values=None):
        return unravel(cfg, torch.tensor(q0).reshape(
            tuple(batch_shape) + q0.shape[-1:]))

    want = jax_batch.fit_spectra_ragged(spectra, mode="optimize", **kw)
    monkeypatch.setattr(batch, "init_unconstrained", matched_init)
    got = batch.fit_spectra_ragged(spectra, mode="optimize", device="cpu",
                                   dtype=torch.float64, **kw)
    assert got.gamma_lo is None and got.gamma_hi is None
    np.testing.assert_allclose(got.tau, want.tau, rtol=1e-15)
    full = lambda r: np.concatenate([r.coef, r.r_inf[:, None]], axis=1)
    scale = np.abs(full(want)).max(axis=1, keepdims=True)
    err = np.abs(full(got) - full(want)) / scale
    assert err.max() < 1e-8, err.max(axis=1)
    np.testing.assert_allclose(got.diagnostics["value"],
                               want.diagnostics["value"], rtol=1e-8)
    np.testing.assert_array_equal(got.diagnostics["n_iter"], [15.0] * 3)


@pytest.mark.parametrize("sampler", ["shmc", "nuts"])
def test_ragged_sample_outputs_match_jax(sampler):
    """Sample mode on 3 spectra with different grids: every output of the
    JAX package's fit is there with its shape, the scales and basis
    agree, the bands are ordered and the values finite."""
    spectra = _fleet()
    kw = dict(chains=2, warmup=20, samples=6, ncp=True, sampler=sampler,
              gamma_eval_tau=np.logspace(-6, 1, 9))
    if sampler == "shmc":
        want = jax_batch.fit_spectra_ragged(
            spectra, shmc_cfg=JaxSHMCConfig(n_steps=3, warm_steps=3), **kw)
    got = batch.fit_spectra_ragged(
        spectra, device="cpu", max_tree_depth=3,
        shmc_cfg=SHMCConfig(n_steps=3, warm_steps=3, recompute_grad=True),
        **kw)
    d = got.diagnostics
    assert got.coef.shape == (3, 97)
    assert np.isfinite(got.coef).all() and np.isfinite(d["z_hat_mean"]).all()
    assert (got.gamma_lo <= got.gamma_hi).all()
    assert (d["gamma_eval_lo"] <= d["gamma_eval_hi"]).all()
    assert d["z_hat_mean"].shape == (3, 64) and "f_train" not in d
    assert d["state_cfg"].model_name() == "Series"
    if sampler == "nuts":
        return
    np.testing.assert_allclose(got.tau, want.tau, rtol=1e-15)
    np.testing.assert_allclose(got.z_scales, want.z_scales, rtol=1e-14)
    for k, v in want.diagnostics.items():
        assert k in d, k
        if k != "state_cfg":
            assert np.shape(d[k]) == np.shape(v), k
    for f in ("coef", "r_inf", "inductance", "gamma_lo", "gamma_hi"):
        assert getattr(got, f).shape == getattr(want, f).shape


def test_ragged_raises():
    spectra = _fleet()
    with pytest.raises(NotImplementedError, match="item 12"):
        batch.fit_spectra_ragged(spectra, device="cpu", mesh=object())
    # sampler='chees' (item 12's first piece) runs, as in the JAX package:
    # the same diagnostics and shapes, a trajectory time per spectrum
    kw = dict(sampler="chees", chains=2, warmup=20, samples=10, ncp=True)
    got = batch.fit_spectra_ragged(
        spectra, device="cpu", chees_cfg=chees.ChEESConfig(max_steps=16),
        **kw)
    want = jax_batch.fit_spectra_ragged(
        spectra, chees_cfg=jax_chees.ChEESConfig(max_steps=16), **kw)
    for k, v in want.diagnostics.items():
        if k != "state_cfg":
            assert np.shape(got.diagnostics[k]) == np.shape(v), k
    assert got.diagnostics["state_traj_time"].shape == (len(spectra),)
    assert np.isfinite(got.coef).all()
    # warm_start is ported (item 12's metric family): a result without
    # sampler state fails its guard
    with pytest.raises(ValueError, match="missing diagnostics"):
        batch.fit_spectra_ragged(spectra, device="cpu", warm_start=batch.
                                 BatchFitResult(*([None] * 8), {}))
    with pytest.raises(ValueError, match="Invalid mode"):
        batch.fit_spectra_ragged(spectra, mode="map", device="cpu")
    with pytest.raises(ValueError, match="Unknown sampler"):
        batch.fit_spectra_ragged(spectra, sampler="hmc", device="cpu")


def test_bases_match_jax():
    """zic_rbf, the basis lookup and construct_A with the Zic and
    Cole-Cole bases (DRT and DDT) against the JAX package; construct_L of
    the Zic basis at order 0, and the ValueError both raise beyond it."""
    y = np.linspace(-30, 30, 121)
    np.testing.assert_allclose(basis.zic_rbf(torch.as_tensor(y)).numpy(),
                               np.asarray(jax_basis.zic_rbf(y)), rtol=1e-14)
    for name in ("gaussian", "Cole-Cole", "Zic"):
        got = basis.get_basis_func(name)(torch.as_tensor(y), 0.7).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_basis.get_basis_func(name)(y, 0.7)),
            rtol=1e-13)
    with pytest.raises(ValueError, match="Invalid basis"):
        basis.get_basis_func("box")
    freq = np.logspace(4, -1, 11)
    tau = 1.0 / (2 * np.pi * BASIS)
    for b_name, kw in (("Zic", {}), ("Cole-Cole", {}),
                       ("Zic", dict(kernel="DDT", dist_type="parallel",
                                    bc="blocking"))):
        for part in ("real", "imag"):
            got = matrices.construct_A(freq, part, tau=tau, basis=b_name,
                                       epsilon=0.8, device="cpu", **kw)
            want = jax_construct_A(freq, part, tau=tau, basis=b_name,
                                   epsilon=0.8, dtype=jnp.float64, **kw)
            _close(got.numpy(), want, 1e-12, f"{b_name} {kw} {part}")
    got = matrices.construct_L(BASIS, tau=tau, basis="Zic", order=0,
                               device="cpu")
    _close(got.numpy(), jax_construct_L(BASIS, tau=tau, basis="Zic",
                                        order=0, dtype=jnp.float64), 1e-14,
           "L Zic")
    for fn in (lambda: matrices.construct_L(BASIS, basis="Zic", order=1,
                                            device="cpu"),
               lambda: jax_construct_L(BASIS, basis="Zic", order=1)):
        with pytest.raises(ValueError, match="Unsupported"):
            fn()


def test_fit_spectra_batch_zic_raises_like_jax():
    """fit_spectra_batch(basis='Zic') builds L orders 0-2, so both packages
    raise construct_L's ValueError at order 1."""
    freq, zb = sim.make_benchmark_batch(1, freq=np.logspace(4, -1, 11))
    for fit in (lambda: batch.fit_spectra_batch(freq, zb, basis="Zic",
                                                device="cpu"),
                lambda: jax_batch.fit_spectra_batch(freq, zb, basis="Zic")):
        with pytest.raises(ValueError, match="Unsupported"):
            fit()
