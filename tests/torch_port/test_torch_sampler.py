"""The port's sampler schedules and adaptation helpers against the JAX
package, and a short flat-chain SHMC run that replays the JAX sampler's
own random numbers through the ``noise`` hook (float64 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu import sim as jax_sim
from bayes_drt_tpu.infer import chees as jax_chees
from bayes_drt_tpu.infer import nuts as jax_nuts
from bayes_drt_tpu.infer import shmc_flat as jax_flat
from bayes_drt_tpu.models.posterior import init_unconstrained
from bayes_drt_tpu.parallel.batch import _build_shared
from bayes_drt_tpu_torch.convert import (flat_shared_from_numpy,
                                         posterior_from_numpy)
from bayes_drt_tpu_torch.infer import chees, nuts
from bayes_drt_tpu_torch.infer.shmc_flat import (flat_spec_for,
                                                 sample_shmc_flat)

torch.set_num_threads(1)


@pytest.mark.parametrize("total", [1, 7, 400, 1000])
def test_halton2_bit_identical(total):
    a, b = chees._halton2(total), jax_chees._halton2(total)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("warmup", [5, 19, 20, 40, 150, 500, 1000])
def test_window_flags_equal(warmup):
    for cfg_t, cfg_j in ((chees.SHMCConfig(), jax_chees.SHMCConfig()),
                         (nuts.NUTSConfig(base_window=10),
                          jax_nuts.NUTSConfig(base_window=10))):
        got = nuts._window_flags(warmup, cfg_t)
        want = jax_nuts._window_flags(warmup, cfg_j)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_da_init_and_update_equal():
    rng = np.random.default_rng(0)
    eps = np.exp(rng.uniform(-6, 0, 16))
    acc = rng.uniform(size=(5, 16))
    cfg_t, cfg_j = chees.SHMCConfig(), jax_chees.SHMCConfig()
    st_t = nuts._da_init(torch.as_tensor(eps))
    st_j = jax.vmap(lambda e: jax_nuts._da_init(e, jnp.float64))(
        jnp.asarray(eps))
    for k in range(5):
        st_t = nuts._da_update(st_t, torch.as_tensor(acc[k]), cfg_t)
        st_j = jax_nuts._da_update(st_j, jnp.asarray(acc[k]), cfg_j)
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-14, atol=1e-15)
    reg_t = nuts._regularized_variance(torch.as_tensor(eps), 40.0)
    reg_j = jax_nuts._regularized_variance(jnp.asarray(eps), 40.0)
    np.testing.assert_allclose(reg_t.numpy(), np.asarray(reg_j), rtol=1e-15)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.25])
def test_pool_eps_matches_flat_rows(q):
    rng = np.random.default_rng(1)
    eps = np.exp(rng.uniform(-6, 0, (6, 4)))
    got = chees._pool_eps(torch.as_tensor(eps),
                          chees.SHMCConfig(eps_quantile=q))
    want = jax_flat._pool_eps_rows(jnp.asarray(eps),
                                   jax_chees.SHMCConfig(eps_quantile=q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def _jax_noise(key, rt, dim, n_leaps):
    """The random numbers sample_shmc_flat draws, regenerated from its key
    splits: eps0 momenta per row, then (z, u_sel) per draw."""
    key, k_eps = jax.random.split(key)
    z0 = np.stack([np.asarray(jax.random.normal(k, (dim,), jnp.float64))
                   for k in jax.random.split(k_eps, rt)])
    out = [torch.as_tensor(z0)]
    for nl in n_leaps:
        key, k_mom, k_sel = jax.random.split(key, 3)
        z = jax.random.normal(k_mom, (rt, dim), jnp.float64)
        u = jax.random.uniform(k_sel, (int(nl), rt), jnp.float64)
        out.append((torch.as_tensor(np.array(z)), torch.as_tensor(np.array(u))))
    return out


@pytest.mark.parametrize("warmup", [10, 40])
def test_sampler_replays_jax_noise(warmup):
    """Same inputs and the same random numbers: the port's flat SHMC
    sampler reproduces the JAX package's draws (warmup=40 exercises a
    mass-adaptation window)."""
    b, chains, samples, n_steps = 2, 2, 5, 4
    freq, Zb = jax_sim.make_benchmark_batch(b, freq=np.logspace(5, -1, 21),
                                            noise_level=0.003, seed=5)
    _, _, _, cfg_j, data_j, _ = _build_shared(freq, mode="sample", ncp=True,
                                              dtype=jnp.float64)
    zs = np.std(np.abs(Zb), axis=1) / np.sqrt(len(freq) / 81)
    Zs = Zb / zs[:, None]
    targets = np.repeat(np.concatenate([Zs.real, Zs.imag], axis=1), chains,
                        axis=0)
    rt = b * chains
    key0 = jax.random.PRNGKey(11)
    q0 = np.stack([np.asarray(ravel_pytree(init_unconstrained(
        cfg_j, data_j, jax.random.fold_in(key0, i)))[0]) for i in range(rt)])
    spec_j = jax_flat.flat_spec_for(cfg_j, data_j)
    shared_j = jax_flat.flat_shared_for(cfg_j, data_j, jnp.float64)
    cfg_sj = jax_chees.SHMCConfig(n_steps=n_steps, warm_steps=n_steps,
                                  eps_quantile=0.5)
    key = jax.random.PRNGKey(7)
    draws_j, info_j = jax_flat.sample_shmc_flat(
        spec_j, shared_j, jnp.asarray(targets), jnp.asarray(q0), key,
        warmup=warmup, samples=samples, cfg=cfg_sj, chains=chains,
        traj_impl="xla")

    cfg, data = posterior_from_numpy(cfg_j, data_j, dtype=torch.float64,
                                     device="cpu")
    spec = flat_spec_for(cfg, data)
    shared = flat_shared_from_numpy(shared_j, dtype=torch.float64,
                                    device="cpu")
    noise = _jax_noise(key, rt, spec.D, [n_steps] * (warmup + samples))
    cfg_s = chees.SHMCConfig(n_steps=n_steps, warm_steps=n_steps,
                             eps_quantile=0.5)
    draws, info = sample_shmc_flat(
        spec, shared, torch.as_tensor(targets), torch.as_tensor(q0), warmup,
        samples, cfg_s, chains, noise=lambda: iter(noise))
    np.testing.assert_allclose(draws.numpy(), np.asarray(draws_j),
                               rtol=1e-8, atol=1e-10)
    for k in ("logp", "accept_prob", "energy", "step_size", "inv_mass"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]),
                                   rtol=1e-8, atol=1e-10, err_msg=k)
    for k in ("diverging", "warmup_diverging", "n_leapfrog"):
        assert np.array_equal(info[k].numpy(), np.asarray(info_j[k])), k


def test_precision_high_is_refused():
    with pytest.raises(NotImplementedError, match="precision"):
        chees.SHMCConfig(precision="high").validate()
