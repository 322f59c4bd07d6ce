"""The summarizer's SBC monitor draws (``monitor_thin``) against the JAX
package on identical draws (float64 on the CPU): the thinned,
chain-major monitor columns of the single series DRT, its outlier variant
(sigma_out at outlier_monitor_indices) and a series-parallel posterior,
then their rescale to physical units: both packages' fit_spectra_batch
run on the same draws (the JAX program's output replaced by its own
summarizer on them, the port's sampler by them), so each package's own
rescale turns them into monitor_draws, held equal at 1e-10. The port
summarizes (B, C, S, D) at once; the JAX package one spectrum's
(C, S, D), vmapped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import bayes_drt_tpu.parallel.batch as jax_batch
import bayes_drt_tpu_torch.parallel.batch as torch_batch
from bayes_drt_tpu.models.posterior import init_unconstrained
from bayes_drt_tpu.parallel.batch import _build_shared as jax_build_shared
from bayes_drt_tpu.parallel.batch import _make_summarize as jax_summarize
from bayes_drt_tpu_torch.convert import posterior_from_numpy
from bayes_drt_tpu_torch.parallel.batch import _make_summarize

torch.set_num_threads(1)

B, C, S = 3, 2, 12
RTOL = 1e-10
FREQ = np.logspace(5, -1, 21)
GE_TAU = np.array([1e-4, 1e-2, 1.0])
BASIS = np.logspace(5.5, -1.5, 19)
MODELS = {
    "series": dict(),
    "outliers": dict(outliers=True),
    "series_parallel": dict(distributions={
        "DRT": {"kernel": "DRT", "basis_freq": BASIS},
        "TP-DDT": {"kernel": "DDT", "bc": "transmissive",
                   "dist_type": "parallel", "basis_freq": BASIS,
                   "x_scale": 0.8}}),
}


def _draws(kw):
    """The JAX package's posterior of ``kw`` on FREQ and numpy-made draws
    and sampler info around its Stan-random init."""
    _, tau, eps, cfg_j, data_j, _ = jax_build_shared(
        FREQ, mode="sample", ncp=True, dtype=jnp.float64, **kw)
    q0, unravel_j = ravel_pytree(init_unconstrained(
        cfg_j, data_j, jax.random.PRNGKey(0)))
    D = q0.shape[0]
    rng = np.random.default_rng(5)
    draws = (np.asarray(q0) + 0.2 * rng.standard_normal((B, C, 1, D))
             + 0.3 * rng.standard_normal((B, C, S, D)))
    info = {"logp": -50.0 + rng.standard_normal((B, C, S)),
            "diverging": rng.uniform(size=(B, C, S)) < 0.05,
            "accept_prob": rng.uniform(size=(B, C, S)),
            "n_leapfrog": rng.integers(1, 33, (B, C, S)).astype(np.int32),
            "inv_mass": np.exp(rng.uniform(-1, 1, (B, C, D))),
            "step_size": np.exp(rng.uniform(-3, -1, (B, C)))}
    mon_idx = np.unique(np.linspace(0, len(tau) - 1, 8).astype(int))
    phi_mon = np.exp(-(eps * np.log(tau[mon_idx][:, None]
                                    / tau[None, :])) ** 2)
    phi_eval = np.exp(-(eps * np.log(GE_TAU[:, None] / tau[None, :])) ** 2)
    return cfg_j, data_j, unravel_j, draws, info, phi_mon, phi_eval


def _jax_summary(cfg_j, data_j, unravel_j, draws, info, phi_mon, phi_eval,
                 thin):
    summ_j = jax_summarize(cfg_j, unravel_j, C, S, len(cfg_j.dists),
                           monitor_thin=thin)
    return jax.vmap(summ_j, in_axes=(None, 0, 0, None, None))(
        data_j, jnp.asarray(draws),
        {k: jnp.asarray(v) for k, v in info.items()},
        jnp.asarray(phi_mon), jnp.asarray(phi_eval))


def _case(kw, thin):
    cfg_j, data_j, unravel_j, draws, info, phi_mon, phi_eval = _draws(kw)
    out_j = _jax_summary(cfg_j, data_j, unravel_j, draws, info, phi_mon,
                         phi_eval, thin)
    cfg, data = posterior_from_numpy(cfg_j, data_j, dtype=torch.float64,
                                     device="cpu")
    out = _make_summarize(cfg, C, S, monitor_thin=thin)(
        data, torch.as_tensor(draws),
        {k: torch.as_tensor(v) for k, v in info.items()},
        torch.as_tensor(phi_mon), torch.as_tensor(phi_eval))
    return out_j, out


@pytest.mark.parametrize("model,thin", [("series", 1), ("series", 5),
                                        ("outliers", 3),
                                        ("series_parallel", 4)])
def test_monitor_draws_match_jax(model, thin):
    out_j, out = _case(MODELS[model], thin)
    md_j = np.asarray(out_j["monitor_draws"])
    md = out["monitor_draws"].numpy()
    n_out = 3 if model == "outliers" else 0
    assert md.shape == md_j.shape == (B, C * (S // thin),
                                      6 + len(GE_TAU) + n_out)
    np.testing.assert_allclose(md, md_j, rtol=RTOL, atol=0)


def _zarc_batch():
    """Three ZARC spectra on FREQ whose Z scales differ (x0.5, x2, x7)."""
    w = 2 * np.pi * FREQ
    z = 0.5 + 2.0 / (1 + (1j * w * 1e-2) ** 0.85)
    return np.stack([f * z for f in (0.5, 2.0, 7.0)])


@pytest.mark.parametrize("model,thin", [("series", 2), ("outliers", 3),
                                        ("series_parallel", 4)])
def test_monitor_rescale_matches_jax_fit(model, thin, monkeypatch):
    """Each package's fit_spectra_batch rescales the same draws' monitors
    with its own code: the JAX program's output is its summarizer on the
    draws, the port's sampler returns the draws."""
    kw = MODELS[model]
    cfg_j, data_j, unravel_j, draws, info, phi_mon, phi_eval = _draws(kw)
    out_j = _jax_summary(cfg_j, data_j, unravel_j, draws, info, phi_mon,
                         phi_eval, thin)
    monkeypatch.setattr(jax_batch, "_cached_program",
                        lambda key, build: lambda *a: out_j)
    monkeypatch.setattr(
        torch_batch, "_run_sampler",
        lambda *a, **k: (torch.as_tensor(draws),
                         {k: torch.as_tensor(v) for k, v in info.items()}))
    z = _zarc_batch()
    fit_kw = dict(mode="sample", chains=C, warmup=4, samples=S, ncp=True,
                  escalate=False, gamma_eval_tau=GE_TAU, monitor_thin=thin,
                  **kw)
    res_j = jax_batch.fit_spectra_batch(FREQ, z, dtype=jnp.float64, **fit_kw)
    res = torch_batch.fit_spectra_batch(FREQ, z, dtype=torch.float64,
                                        device="cpu", **fit_kw)
    np.testing.assert_allclose(res.z_scales, res_j.z_scales, rtol=RTOL)
    assert len(set(np.round(res.z_scales, 6))) == B
    md_j = res_j.diagnostics["monitor_draws"]
    md = res.diagnostics["monitor_draws"]
    assert md.shape == md_j.shape
    np.testing.assert_allclose(md, md_j, rtol=RTOL, atol=0)
    # the scaled-space summary differs from the rescaled draws in every
    # column the rescale touches
    raw = np.asarray(out_j["monitor_draws"])
    n_s = 6 + len(GE_TAU)
    touched = np.r_[0, 1, 6:md.shape[-1]]
    assert not np.allclose(md[..., touched], raw[..., touched])
    np.testing.assert_allclose(md[..., 2:6], raw[..., 2:6], rtol=RTOL,
                               atol=0)
    assert md.shape[-1] == n_s + (3 if model == "outliers" else 0)
