"""The port's bounded Levenberg-Marquardt solver (infer/lsq.py) against
the JAX package's, float64 on the CPU (the JAX side with x64 on, as its
own tests run it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer.lsq import bounded_lm as jax_lm
from bayes_drt_tpu.infer.lsq import make_bound_transform as jax_transform
from bayes_drt_tpu_torch.infer.lsq import bounded_lm, make_bound_transform

# the bound transforms: elementwise at 1e-12 (relative, absolute near 0)
TRANSFORM_TOL = 1e-12
# a well-posed fit (an exponential decay with offset, the optimum
# certified by both): x within 1e-8
LM_TOL = 1e-8
# a stiff residual (Rosenbrock-like, condition ~1e4 at the start): held
# at a capped count, x within 1e-10 of the JAX package's iterate
STIFF_TOL = 1e-10

T = np.linspace(0.0, 3.0, 40)
Y = 2.0 * np.exp(-1.3 * T) + 0.5 + 0.01 * np.sin(7 * T)
LB = np.array([0.0, 0.0, -np.inf, -np.inf])
UB = np.array([np.inf, 5.0, np.inf, 2.0])


def test_bound_transforms_match_jax():
    u = np.linspace(-40.0, 40.0, 161)
    lb = np.array([0.0, -1.0, -np.inf, -np.inf])
    ub = np.array([np.inf, 3.0, 2.0, np.inf])
    to_x_j, to_u_j = jax_transform(jnp.asarray(lb), jnp.asarray(ub))
    to_x, to_u = make_bound_transform(torch.as_tensor(lb), torch.as_tensor(ub))
    uu = np.repeat(u[:, None], 4, axis=1)
    want = np.asarray(to_x_j(jnp.asarray(uu)))
    got = to_x(torch.as_tensor(uu)).numpy()
    np.testing.assert_allclose(got, want, rtol=TRANSFORM_TOL,
                               atol=TRANSFORM_TOL)
    # back to u from points strictly inside the bounds
    x = np.clip(want, lb + 1e-6, ub - 1e-6)
    np.testing.assert_allclose(to_u(torch.as_tensor(x)).numpy(),
                               np.asarray(to_u_j(jnp.asarray(x))),
                               rtol=TRANSFORM_TOL, atol=TRANSFORM_TOL)


def _decay(xp):
    def res(x):
        return (x[0] * xp.exp(-x[1] * xp.asarray(T)) + x[2]
                + 0.0 * x[3] - xp.asarray(Y) + 1e-3 * (x[3] - 1.0))
    return res


def test_bounded_lm_well_posed_matches_jax():
    x0 = np.array([1.0, 1.0, 0.0, 0.5])
    want = jax_lm(_decay(jnp), jnp.asarray(x0), jnp.asarray(LB),
                  jnp.asarray(UB), max_iter=100)
    got = bounded_lm(_decay(torch), torch.as_tensor(x0)[None], LB, UB,
                     max_iter=100)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                               rtol=LM_TOL, atol=LM_TOL)
    np.testing.assert_allclose(float(got.cost[0]), float(want.cost),
                               rtol=LM_TOL)
    assert float(got.grad_norm[0]) < 1e-8 and float(want.grad_norm) < 1e-8
    assert got.x.shape == (1, 4) and got.n_iter.dtype == torch.int32


@pytest.mark.parametrize("cap", [3, 10])
def test_bounded_lm_stiff_at_capped_count(cap):
    def rosen(xp):
        def res(x):
            return xp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0],
                             100.0 * (x[2] - x[1]) ** 2])
        return res

    x0 = np.array([-1.2, 1.0, 0.3])
    lb = np.array([-2.0, -np.inf, 0.0])
    ub = np.array([2.0, np.inf, np.inf])
    want = jax_lm(rosen(jnp), jnp.asarray(x0), jnp.asarray(lb),
                  jnp.asarray(ub), max_iter=cap)
    got = bounded_lm(rosen(torch), torch.as_tensor(x0)[None], lb, ub,
                     max_iter=cap)
    assert int(got.n_iter[0]) == int(want.n_iter) == cap
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                               rtol=STIFF_TOL, atol=STIFF_TOL)
    np.testing.assert_allclose(float(got.cost[0]), float(want.cost),
                               rtol=STIFF_TOL)


def test_bounded_lm_rows_freeze_independently():
    """Rows of one call are the single-row solves: a row that stops early
    keeps its state while the others run."""
    starts = np.array([[1.0, 1.0, 0.0, 0.5], [2.0, 1.3, 0.5, 1.0],
                       [0.3, 4.0, -1.0, 0.0]])
    batch = bounded_lm(_decay(torch), torch.as_tensor(starts), LB, UB,
                       max_iter=60)
    for i, x0 in enumerate(starts):
        one = bounded_lm(_decay(torch), torch.as_tensor(x0)[None], LB, UB,
                         max_iter=60)
        assert int(one.n_iter[0]) == int(batch.n_iter[i])
        np.testing.assert_allclose(batch.x[i].numpy(), one.x[0].numpy(),
                                   rtol=1e-12, atol=1e-12)
    assert len(set(batch.n_iter.tolist())) > 1
