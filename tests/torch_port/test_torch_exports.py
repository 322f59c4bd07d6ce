"""The port's package-level names against the JAX package's: importing
bayes_drt_tpu_torch.infer, .ops, .parallel and .experiments gives every
public name the JAX package's modules of the same names give (their
__all__ lists equal), each pointing at the port's counterpart, and
importing them builds no CUDA extension."""

import importlib

import numpy as np
import pytest
import torch

import bayes_drt_tpu.experiments  # noqa: F401  (loads ops.pallas_quad)
from bayes_drt_tpu.infer import nnls as jax_nnls
from bayes_drt_tpu_torch import _build

MODULES = ("infer", "ops", "parallel", "experiments")


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_jax(name):
    jax_mod = importlib.import_module(f"bayes_drt_tpu.{name}")
    port = importlib.import_module(f"bayes_drt_tpu_torch.{name}")
    assert set(jax_mod.__all__) <= set(port.__all__)
    jax_names = {n for n in dir(jax_mod) if not n.startswith("_")}
    port_names = {n for n in dir(port) if not n.startswith("_")}
    assert jax_names <= port_names, sorted(jax_names - port_names)
    for n in port.__all__:
        assert getattr(port, n) is not None, n


def test_names_point_at_the_port():
    """The re-exports are the port's own objects (ess_jnp the device ESS,
    construct_A_drt_pallas the quadrature kernel's entry), and importing
    the packages built nothing."""
    from bayes_drt_tpu_torch import experiments, infer, ops
    from bayes_drt_tpu_torch.infer import diagnostics, nuts
    from bayes_drt_tpu_torch.ops import matrices, quad
    assert infer.ess_jnp is diagnostics.ess_jnp
    assert infer.NUTSConfig is nuts.NUTSConfig
    assert ops.construct_A is matrices.construct_A
    assert ops.pallas_quad is quad
    assert experiments.construct_A_drt_pallas is quad.construct_A_drt_quad
    assert not _build._loaded


def test_solve_qp_box_batch_matches_jax():
    """solve_qp_box_batch (the JAX package's vmapped solve_qp_box over
    rows, shared bounds) on random SPD QPs: the same solutions, float64;
    per-row bounds are refused."""
    from bayes_drt_tpu_torch.infer.nnls import solve_qp_box_batch
    rng = np.random.default_rng(0)
    b, k = 4, 6
    m = rng.standard_normal((b, k, k))
    P = m @ m.transpose(0, 2, 1) + 0.5 * np.eye(k)
    q = rng.standard_normal((b, k))
    lb, ub = np.full(k, -0.3), np.full(k, 0.4)
    got = solve_qp_box_batch(torch.as_tensor(P), torch.as_tensor(q),
                             torch.as_tensor(lb), torch.as_tensor(ub))
    want = jax_nnls.solve_qp_box_batch(P, q, lb, ub)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="shared"):
        solve_qp_box_batch(torch.as_tensor(P), torch.as_tensor(q),
                           torch.zeros((b, k), dtype=torch.float64),
                           torch.as_tensor(ub))


def test_nuts_transition_matches_jax_order():
    """nuts_transition takes the JAX signature's order (value_and_grad, q,
    logp, grad, key -> the draw's noise, eps, m_inv, max_depth, ...) and
    replays the JAX package's recursive nuts_transition from its keys on a
    correlated Gaussian: the same trees, and q, logp and grad at 1e-10 in
    float64."""
    import jax
    import jax.numpy as jnp

    from bayes_drt_tpu.infer import nuts as jax_nuts
    from bayes_drt_tpu_torch.infer import nuts
    from jax_noise_reference import jax_draw_noise

    d, rows, md = 4, 6, 5
    rng = np.random.default_rng(3)
    a = rng.standard_normal((d, d))
    prec = np.linalg.inv(a @ a.T + 0.5 * np.eye(d))
    P, prec_j = torch.as_tensor(prec), jnp.asarray(prec)

    def vg(x):
        g = -(x @ P)
        return 0.5 * torch.sum(x * g, dim=1), g

    vg_j = jax.value_and_grad(lambda x: -0.5 * x @ (prec_j @ x))
    q = rng.standard_normal((rows, d))
    eps = np.exp(rng.uniform(-1.5, -0.5, rows))
    m_inv = np.exp(rng.uniform(-0.5, 0.5, (rows, d)))
    keys = jax.random.split(jax.random.PRNGKey(4), rows)

    def one(qq, k, e, m):
        lp0, g0 = vg_j(qq)
        return jax_nuts.nuts_transition(vg_j, qq, lp0, g0, k, e, m, md)

    want = jax.jit(jax.vmap(one))(jnp.asarray(q), keys, jnp.asarray(eps),
                                  jnp.asarray(m_inv))
    qt = torch.as_tensor(q)
    lp, g = vg(qt)
    got = nuts.nuts_transition(vg, qt, lp, g, jax_draw_noise(keys, d, md),
                               torch.as_tensor(eps), torch.as_tensor(m_inv),
                               md)
    for k in ("n_leapfrog", "diverging"):
        assert np.array_equal(getattr(got[3], k).numpy(),
                              np.asarray(getattr(want[3], k))), k
    assert int(got[3].n_leapfrog.min()) > 1
    for i, name in ((0, "q"), (1, "logp"), (2, "grad")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
