"""The random numbers the JAX package's samplers draw from their keys, laid
out as the port's samplers take them in ``noise`` streams, so that a
port sampler replays a JAX run draw for draw."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayes_drt_tpu_torch.infer import nuts


@functools.lru_cache(maxsize=None)
def _jax_noise_fn(dim, max_depth):
    def one(k):
        k_mom, key = jax.random.split(k)
        z = jax.random.normal(k_mom, (dim,), jnp.float64)
        dirs, swaps, leaves = [], [], []
        for d in range(max_depth):
            key, k_dir, k_sub, k_swap = jax.random.split(key, 4)
            dirs.append(jax.random.bernoulli(k_dir))
            swaps.append(jax.random.uniform(k_swap))
            leaves += [jax.random.uniform(jax.random.fold_in(k_sub, i))
                       for i in range(1 << d)]
        return z, jnp.stack(dirs), jnp.stack(swaps), jnp.stack(leaves)

    return jax.jit(jax.vmap(one))


def jax_draw_noise(keys, dim, max_depth):
    """The random numbers JAX's flat NUTS transition draws from each row's
    key (nuts.py:449-451 momentum, :335-337 direction and subtree keys,
    :360 leaf uniforms, :391 swap uniform), as a NUTSNoise."""
    z, dirs, swaps, leaves = _jax_noise_fn(dim, max_depth)(keys)

    def t(a):
        return torch.as_tensor(np.array(a))

    return nuts.NUTSNoise(z=t(z), go_right=t(dirs).T.contiguous(),
                          swap_u=t(swaps).T.contiguous(),
                          leaf_u=t(leaves).T.contiguous())


def jax_nuts_stream(keys, dim, max_depth, draws):
    """The noise stream of JAX's sample_nuts run once per row key (a vmap
    over chains): the step-size search's normals (R, D), then each of
    ``draws`` transitions' NUTSNoise."""
    stream, step_keys = [], []
    for k in keys:
        k, k_eps = jax.random.split(k)
        stream.append(np.asarray(jax.random.normal(k_eps, (dim,),
                                                   jnp.float64)))
        ks = []
        for _ in range(draws):
            k, k_step = jax.random.split(k)
            ks.append(k_step)
        step_keys.append(ks)
    out = [torch.as_tensor(np.stack(stream))]
    for t in range(draws):
        out.append(jax_draw_noise(jnp.stack([ks[t] for ks in step_keys]),
                                  dim, max_depth))
    return out


def jax_shmc_stream(keys, dim, chains, n_leaps):
    """The random numbers JAX's sample_shmc draws from each spectrum's key
    (chees.py:555,558-561 eps0 momenta per chain, :614-624 per draw), laid
    out as the port's spectrum-major rows: eps0 normals (B*C, D), then per
    draw (z (B*C, D), u_sel (n_leap, B*C))."""
    z0, ks = [], []
    for key in keys:
        key, k_eps = jax.random.split(key)
        z0.append(np.stack([np.asarray(jax.random.normal(k, (dim,),
                                                         jnp.float64))
                            for k in jax.random.split(k_eps, chains)]))
        ks.append(key)
    out = [torch.as_tensor(np.concatenate(z0))]
    for nl in n_leaps:
        zs, us = [], []
        for i, key in enumerate(ks):
            key, k_mom, k_sel = jax.random.split(key, 3)
            ks[i] = key
            zs.append(np.asarray(jax.random.normal(k_mom, (chains, dim),
                                                   jnp.float64)))
            us.append(np.asarray(jax.random.uniform(k_sel, (int(nl), chains),
                                                    jnp.float64)))
        out.append((torch.as_tensor(np.concatenate(zs)),
                    torch.as_tensor(np.concatenate(us, axis=1))))
    return out


@functools.lru_cache(maxsize=None)
def _jax_chees_draw_fn(dim, chains, max_steps):
    def one(key):
        key, k_mom, k_j, k_sel = jax.random.split(key, 4)
        z = jax.random.normal(k_mom, (chains, dim), jnp.float64)
        uj = jax.random.uniform(k_j, (), jnp.float64)

        def leaf(i):
            return jax.random.uniform(jax.random.fold_in(k_sel, i), (chains,),
                                      jnp.float64)

        idx = jnp.arange(max_steps)
        ub = jax.vmap(leaf)(2 * idx)
        uf = jax.vmap(leaf)(2 * idx + 1)
        return key, z, uj, ub, uf

    return jax.jit(jax.vmap(one))


def jax_chees_stream(keys, dim, chains, max_steps, draws):
    """The random numbers JAX's sample_chees draws from each spectrum's key
    (chees.py:160-165 eps0 momenta per chain; per draw :202 split(key, 4)
    into k_mom, k_j, k_sel, :219 z, :233 uj and :258-260 the leaf uniforms
    from fold_in(k_sel, 2 i + pbase), pbase 0 backward and 1 forward),
    laid out as the port's spectrum-major rows: eps0 normals (B*C, D),
    then per draw (z (B*C, D), uj (B,), u_back (max_steps, B*C), u_fwd
    (max_steps, B*C))."""
    z0, ks = [], []
    for key in keys:
        key, k_eps = jax.random.split(key)
        z0.append(np.stack([np.asarray(jax.random.normal(k, (dim,),
                                                         jnp.float64))
                            for k in jax.random.split(k_eps, chains)]))
        ks.append(key)
    out = [torch.as_tensor(np.concatenate(z0))]
    ks = jnp.stack(ks)
    fn = _jax_chees_draw_fn(dim, chains, max_steps)
    b = ks.shape[0]
    for _ in range(draws):
        ks, z, uj, ub, uf = fn(ks)

        def legs(u):
            # (B, max_steps, C) -> (max_steps, B*C)
            return torch.as_tensor(np.array(u).transpose(1, 0, 2).reshape(
                max_steps, b * chains))

        out.append((torch.as_tensor(np.array(z).reshape(b * chains, dim)),
                    torch.as_tensor(np.array(uj)), legs(ub), legs(uf)))
    return out
