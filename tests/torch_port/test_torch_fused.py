"""NUTSConfig(fused_draws=True), on the CPU in float64. The JAX
package's _sample_nuts_fused (bayes_drt_tpu/infer/nuts.py:692-816) runs
a whole chain as one loop of leapfrog steps with the draw boundaries
masked; its draws are the flat form's, so the port runs the flat form.
Held against the port's flat form with the same generator at the JAX
package's bars (tests/test_nuts.py:188-228), against the JAX package's
fused sampler with its own random numbers, and for the dense-adaptation
refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer import nuts as jax_nuts
from bayes_drt_tpu_torch.infer import nuts
from jax_noise_reference import jax_nuts_stream

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "ignore:NUTSConfig\\(fused_draws=True\\)")


def _gaussian(d, seed):
    """tests/test_nuts.py:196-202's correlated Gaussian: the port's value
    and gradient, the JAX log density."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    prec = np.linalg.inv(a @ a.T + 0.5 * np.eye(d))
    P, prec_j = torch.as_tensor(prec), jnp.asarray(prec)

    def vg(q):
        g = -(q @ P)
        return 0.5 * torch.sum(q * g, dim=1), g

    return vg, (lambda q: -0.5 * q @ (prec_j @ q))


def _pair(vg, q0, warmup, samples, seed, **kw):
    runs = []
    for fused in (False, True):
        cfg = nuts.NUTSConfig(max_depth=8, flat_tree=not fused,
                              fused_draws=fused, **kw)
        runs.append(nuts.sample_nuts(
            vg, q0, warmup, samples, cfg,
            generator=torch.Generator().manual_seed(seed)))
    return runs


def test_fused_equals_flat_without_adaptation():
    """warmup=0: the same draws and trees, bit for bit (3 chains)."""
    vg, _ = _gaussian(10, 7)
    q0 = torch.ones((3, 10), dtype=torch.float64)
    (d1, i1), (d2, i2) = _pair(vg, q0, 0, 20, 0)
    assert torch.equal(d1, d2)
    for k in ("n_leapfrog", "diverging", "logp", "accept_prob", "energy"):
        assert torch.equal(i1[k], i2[k]), k


def test_fused_matches_flat_with_adaptation():
    """Step-size and mass adaptation: the same trees and divergences,
    draws at the JAX test's rtol 1e-5 / atol 1e-7, the metric at 1e-6."""
    vg, _ = _gaussian(10, 7)
    q0 = torch.zeros((3, 10), dtype=torch.float64)
    (d1, i1), (d2, i2) = _pair(vg, q0, 60, 60, 3)
    assert torch.equal(i1["n_leapfrog"], i2["n_leapfrog"])
    assert torch.equal(i1["diverging"], i2["diverging"])
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(i2["inv_mass"].numpy(),
                               i1["inv_mass"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(i2["step_size"].numpy(),
                               i1["step_size"].numpy(), rtol=1e-6)


def test_fused_replays_jax_fused():
    """fused_draws=True with the JAX package's random numbers
    reproduces JAX's sample_nuts(fused_draws=True) chain by chain through
    warmup (step size and two mass windows) and sampling."""
    d, chains, warmup, samples, md = 6, 3, 50, 20, 6
    vg, logp = _gaussian(d, 2)
    keys = jax.random.split(jax.random.PRNGKey(9), chains)
    q0 = np.random.default_rng(1).standard_normal((chains, d))
    draws_j, info_j = jax.vmap(lambda qq, k: jax_nuts.sample_nuts(
        logp, qq, k, warmup=warmup, samples=samples,
        cfg=jax_nuts.NUTSConfig(max_depth=md, fused_draws=True)))(
        jnp.asarray(q0), keys)
    noise = jax_nuts_stream(keys, d, md, warmup + samples)
    draws, info = nuts.sample_nuts(
        vg, torch.as_tensor(q0), warmup, samples,
        nuts.NUTSConfig(max_depth=md, fused_draws=True),
        noise=lambda: iter(noise))
    np.testing.assert_allclose(draws.numpy(),
                               np.asarray(draws_j).transpose(1, 0, 2),
                               rtol=1e-8, atol=1e-10)
    for k in ("logp", "accept_prob", "energy"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]).T,
                                   rtol=1e-8, atol=1e-10, err_msg=k)
    for k in ("n_leapfrog", "diverging", "warmup_diverging"):
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k]).T), k


def test_fused_fixed_dense_metric_and_dense_adaptation_refused():
    """A fixed dense metric runs fused (as the flat form, bit for bit
    without adaptation); dense mass adaptation raises the JAX package's
    ValueError in both packages."""
    vg, logp = _gaussian(4, 5)
    q0 = torch.zeros((2, 4), dtype=torch.float64)
    cov = np.diag([1.0, 2.0, 0.5, 1.5]) + 0.1
    runs = []
    for fused in (False, True):
        cfg = nuts.NUTSConfig(max_depth=5, adapt_mass=False,
                              fused_draws=fused)
        runs.append(nuts.sample_nuts(
            vg, q0, 0, 10, cfg, metric=torch.as_tensor(cov),
            generator=torch.Generator().manual_seed(2)))
    assert torch.equal(runs[0][0], runs[1][0])
    with pytest.raises(ValueError, match="dense mass adaptation"):
        nuts.sample_nuts(vg, q0, 10, 10, nuts.NUTSConfig(
            dense_mass=True, fused_draws=True),
            generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dense mass adaptation"):
        jax_nuts.sample_nuts(logp, jnp.zeros(4), jax.random.PRNGKey(0),
                             warmup=10, samples=10, cfg=jax_nuts.NUTSConfig(
                                 dense_mass=True, fused_draws=True))
