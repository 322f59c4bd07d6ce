"""One trajectory of the port's plain trajectory (the version the CUDA
kernel is held to on the card) against the JAX package's XLA trajectory
and its Pallas kernel in interpret mode, on identical inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu import sim as jax_sim
from bayes_drt_tpu.infer.shmc_flat import (_traj_pallas, _traj_xla,
                                           flat_shared_for, flat_spec_for,
                                           flat_value_and_grad)
from bayes_drt_tpu.models.posterior import init_unconstrained
from bayes_drt_tpu.parallel.batch import _build_shared
from bayes_drt_tpu_torch.convert import (flat_shared_from_numpy,
                                         flat_state_from_numpy)
from bayes_drt_tpu_torch.infer import shmc_flat

torch.set_num_threads(1)

NAMES = ["q", "logp", "grad", "kin", "sacc", "diverging"]


def _inputs(jdt, rt=8, n_leap=6, seed=0, freq=(6, -2, 41)):
    freq = np.logspace(*freq)
    Z = jax_sim.reference_circuit("ZARC", freq)
    _, _, _, cfg, data, _ = _build_shared(freq, mode="sample", ncp=True,
                                          dtype=jdt)
    target = jnp.asarray(np.concatenate([Z.real, Z.imag]) / np.abs(Z).max(),
                         jdt)
    data = data._replace(target=target)
    spec = flat_spec_for(cfg, data)
    shared = flat_shared_for(cfg, data, jdt)
    key = jax.random.PRNGKey(seed)
    q = jnp.stack([ravel_pytree(jax.tree.map(
        lambda a: a.astype(jdt),
        init_unconstrained(cfg, data, jax.random.fold_in(key, i))))[0]
        for i in range(rt)])
    targets = jnp.broadcast_to(target[None, :], (rt, target.shape[0]))
    lp, g = flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                shared.scal, q, targets)
    rng = np.random.default_rng(seed)
    p0 = jnp.asarray(rng.standard_normal((rt, spec.D)), jdt)
    eps = jnp.asarray(np.exp(rng.uniform(-6.0, -4.0, rt)), jdt)
    m_inv = jnp.asarray(np.exp(rng.uniform(-0.5, 0.5, (rt, spec.D))), jdt)
    u_sel = jnp.asarray(rng.uniform(size=(n_leap, rt)), jdt)
    j = 2
    return spec, shared, (q, p0, g, lp, eps, m_inv, targets, j, u_sel)


def _port_args(spec, shared, args, tdt):
    q, p0, g, lp, eps, m_inv, targets, j, u_sel = args
    sh = flat_shared_from_numpy(shared, dtype=tdt, device="cpu")
    qt, mt, et = flat_state_from_numpy(q, m_inv, eps, dtype=tdt,
                                       device="cpu")
    t = [torch.as_tensor(np.array(a)).to(tdt) for a in (p0, g, lp, targets,
                                                        u_sel)]
    pspec = shmc_flat.FlatSpec(*spec)
    return (pspec, sh, qt, t[0], t[1], t[2], et, mt, t[3], j, t[4])


@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.float64, torch.float64, 1e-9), (jnp.float32, torch.float32, 2e-5)])
def test_traj_plain_matches_jax_xla_and_pallas(jdt, tdt, tol):
    spec, shared, args = _inputs(jdt)
    n_leap = args[-1].shape[0]
    out_x = _traj_xla(spec, n_leap, 1000.0, shared, *args)
    out_p = _traj_pallas(spec, n_leap, 1000.0, 8, True, shared, *args)
    pspec, sh, qt, p0, g, lp, et, mt, tg, j, us = _port_args(spec, shared,
                                                             args, tdt)
    before = shmc_flat.traj_fused.launches
    out_t = shmc_flat.traj_fused(pspec, n_leap, 1000.0, sh, qt, p0, g, lp,
                                 et, mt, tg, j, us)
    assert shmc_flat.traj_fused.launches == before   # CPU: plain version
    for name, a, b, c in zip(NAMES, out_t, out_x, out_p):
        a = a.double().numpy()
        for ref, which in ((b, "xla"), (c, "pallas")):
            np.testing.assert_allclose(a, np.asarray(ref, np.float64),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{name} vs {which}")


# (n, K) = (41, 101) as above; (101, 121) takes two output passes of the
# kernel's forward product; (121, 141) its wide tile (K > 128)
GRIDS = [(6, -2, 41), (7, -3, 101), (8, -4, 121)]


@pytest.mark.parametrize("freq", GRIDS)
@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.float64, torch.float64, 1e-9), (jnp.float32, torch.float32, 2e-5)])
def test_stacked_layout_matches_jax(jdt, tdt, tol, freq):
    """The kernel reads A and L only through the stacked W (OP, KP) =
    [A; L0; L1; L2] and its transpose WT, zero padded; FlatShared's A and
    L are views into W that equal the JAX package's matrices, and the
    plain trajectory on them equals the JAX package's."""
    spec, shared, args = _inputs(jdt, freq=freq)
    n_leap = args[-1].shape[0]
    pspec, sh, qt, p0, g, lp, et, mt, tg, j, us = _port_args(spec, shared,
                                                             args, tdt)
    K, n2 = spec.K, 2 * spec.n
    op, kp = shmc_flat.stacked_shape(spec.n, K)
    assert tuple(sh.W.shape) == (op, kp) and sh.WT.is_contiguous()
    assert torch.equal(sh.WT, sh.W.T) and tuple(sh.A.shape) == (n2, K)
    assert not sh.W[n2 + 3 * K:].any() and not sh.W[:, K:].any()
    assert sh.A.data_ptr() == sh.W.data_ptr()
    np.testing.assert_array_equal(sh.A.numpy(), np.asarray(shared.A))
    np.testing.assert_array_equal(sh.L.numpy(), np.asarray(shared.L))
    out_t = shmc_flat._traj_plain(pspec, n_leap, 1000.0, sh, qt, p0, g, lp,
                                  et, mt, tg, j, us)
    out_x = _traj_xla(spec, n_leap, 1000.0, shared, *args)
    for name, a, b in zip(NAMES, out_t, out_x):
        np.testing.assert_allclose(a.double().numpy(),
                                   np.asarray(b, np.float64), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("K,n", [(2, 1), (101, 41), (101, 106), (111, 91),
                                 (121, 72), (129, 40), (281, 27)])
def test_stacked_shape_covers_every_shape(K, n):
    """W has 2n + 3K rows or more (at least 2 KP, the two KP-row blocks
    the kernel keeps the dups weights in) and K columns, each padded to a
    multiple of 8; A and L read back from W exactly."""
    op, kp = shmc_flat.stacked_shape(n, K)
    assert op % 8 == 0 and kp % 8 == 0
    assert kp - 8 < K <= kp and op >= 2 * n + 3 * K and op >= 2 * kp
    assert op - 8 < 2 * n + 3 * K or op == 2 * kp
    rng = np.random.default_rng(K * 1000 + n)
    A = torch.as_tensor(rng.standard_normal((2 * n, K)))
    L = torch.as_tensor(rng.standard_normal((3, K, K)))
    sh = shmc_flat.make_flat_shared(A, L, torch.zeros((3, 2 * n),
                                                      dtype=A.dtype),
                                    torch.zeros(8, dtype=A.dtype))
    assert tuple(sh.W.shape) == (op, kp)
    assert torch.equal(sh.A, A) and torch.equal(sh.L, L)
    assert torch.equal(sh.WT, sh.W.T) and sh.WT.is_contiguous()
