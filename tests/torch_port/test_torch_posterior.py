"""The port's log density, its autograd gradient, the hand-written flat
value-and-gradient and the flat layout against the JAX package (float64
on the CPU, identical inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu import sim as jax_sim
from bayes_drt_tpu.infer.shmc_flat import flat_shared_for as jax_shared_for
from bayes_drt_tpu.infer.shmc_flat import flat_spec_for as jax_spec_for
from bayes_drt_tpu.models.posterior import init_unconstrained as jax_init
from bayes_drt_tpu.models.posterior import log_density as jax_log_density
from bayes_drt_tpu.parallel.batch import _build_shared as jax_build_shared
from bayes_drt_tpu_torch.convert import (flat_shared_from_numpy,
                                         posterior_from_numpy)
from bayes_drt_tpu_torch.infer.shmc_flat import (flat_shared_for,
                                                 flat_spec_for,
                                                 flat_value_and_grad)
from bayes_drt_tpu_torch.models.posterior import (init_unconstrained,
                                                  log_density, ravel,
                                                  unravel)

torch.set_num_threads(1)

CASES = [(True, False), (False, False), (True, True), (False, True)]


def _setup(ncp, nonneg, R=5):
    freq = np.logspace(6, -2, 41)
    Z = jax_sim.reference_circuit("ZARC", freq)
    _, _, _, cfg_j, data_j, _ = jax_build_shared(
        freq, mode="sample", ncp=ncp, nonneg=nonneg, dtype=jnp.float64)
    target = np.concatenate([Z.real, Z.imag]) / np.abs(Z).max()
    data_j = data_j._replace(target=jnp.asarray(target))
    key = jax.random.PRNGKey(3)
    q = np.stack([np.asarray(ravel_pytree(jax_init(
        cfg_j, data_j, jax.random.fold_in(key, i)))[0]) for i in range(R)])
    cfg, data = posterior_from_numpy(cfg_j, data_j, dtype=torch.float64,
                                     device="cpu")
    return cfg_j, data_j, cfg, data, q, target


def _jax_value_and_grad(cfg_j, data_j, q):
    _, unravel_j = ravel_pytree(jax_init(cfg_j, data_j,
                                         jax.random.PRNGKey(0)))
    vg = jax.vmap(jax.value_and_grad(
        lambda x: jax_log_density(cfg_j, data_j, unravel_j(x),
                                  jacobian=True)))
    lp, g = vg(jnp.asarray(q))
    return np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize("ncp,nonneg", CASES)
def test_log_density_and_autograd_match_jax(ncp, nonneg):
    cfg_j, data_j, cfg, data, q, _ = _setup(ncp, nonneg)
    lp_ref, g_ref = _jax_value_and_grad(cfg_j, data_j, q)
    for i in range(q.shape[0]):
        x = torch.tensor(q[i], requires_grad=True)
        lp = log_density(cfg, data, unravel(cfg, x), jacobian=True)
        (g,) = torch.autograd.grad(lp, x)
        np.testing.assert_allclose(lp.item(), lp_ref[i], rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), g_ref[i], rtol=1e-10,
                                   atol=1e-9)


@pytest.mark.parametrize("ncp,nonneg", CASES)
def test_flat_value_and_grad_matches_autograd_and_jax(ncp, nonneg):
    cfg_j, data_j, cfg, data, q, target = _setup(ncp, nonneg)
    spec = flat_spec_for(cfg, data)
    shared = flat_shared_for(cfg, data, torch.float64)
    R = q.shape[0]
    tq = torch.as_tensor(q)
    targets = torch.as_tensor(target)[None, :].expand(R, -1)
    lp, g = flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                shared.scal, tq, targets)
    lp_ref, g_ref = _jax_value_and_grad(cfg_j, data_j, q)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-9, atol=1e-9)
    x = tq.clone().requires_grad_(True)
    lp_a = torch.stack([log_density(cfg, data, unravel(cfg, x[i]))
                        for i in range(R)])
    (g_a,) = torch.autograd.grad(lp_a.sum(), x)
    np.testing.assert_allclose(lp.numpy(), lp_a.detach().numpy(), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), g_a.numpy(), rtol=1e-9, atol=1e-9)
    # the shared inputs equal the JAX package's, element for element
    shared_j = flat_shared_from_numpy(jax_shared_for(cfg_j, data_j,
                                                     jnp.float64),
                                      dtype=torch.float64, device="cpu")
    for a, b in zip(shared, shared_j):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-15)


@pytest.mark.parametrize("ncp,nonneg", [(True, False), (False, True)])
def test_flat_layout_matches_jax(ncp, nonneg):
    cfg_j, data_j, cfg, data, _, _ = _setup(ncp, nonneg, R=1)
    assert tuple(flat_spec_for(cfg, data)) == tuple(jax_spec_for(cfg_j,
                                                                 data_j))
    # ravel/unravel round-trip, and a batched init has the flat width
    gen = torch.Generator().manual_seed(0)
    p = init_unconstrained(cfg, data, gen, batch_shape=(3, 2))
    flat = ravel(cfg, p)
    assert flat.shape == (3, 2, flat_spec_for(cfg, data).D)
    assert float(flat.abs().max()) <= 2.0
    for k, v in unravel(cfg, flat).items():
        torch.testing.assert_close(v, p[k], rtol=0, atol=0)


def test_flat_spec_rejects_ineligible_models():
    cfg_j, data_j, cfg, data, _, _ = _setup(True, False, R=1)
    with pytest.raises(ValueError, match="single series"):
        flat_spec_for(cfg._replace(outliers=True), data)
