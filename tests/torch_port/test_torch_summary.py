"""The port's posterior summary and its convergence diagnostics against the
JAX package on identical draws (float64 on the CPU).

The port computes them over leading batch axes, (B, C, S, D); the JAX
package computes one spectrum's (C, S, D) and vmaps over B. The draws are
autocorrelated chains with chain offsets, so Rhat, ESS and the Geyer
truncation all see nontrivial input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.infer import diagnostics as jax_diag
from bayes_drt_tpu.models.posterior import init_unconstrained
from bayes_drt_tpu.parallel.batch import _build_shared as jax_build_shared
from bayes_drt_tpu.parallel.batch import _make_summarize as jax_summarize
from bayes_drt_tpu_torch.convert import posterior_from_numpy
from bayes_drt_tpu_torch.infer import diagnostics
from bayes_drt_tpu_torch.parallel.batch import _make_summarize

torch.set_num_threads(1)

B, C, S = 3, 2, 40
RTOL, ATOL = 1e-10, 1e-13


def _ar1(rng, shape, rho=0.7):
    """AR(1) series along axis -2 with unit marginal variance."""
    e = rng.standard_normal(shape)
    x = np.empty(shape)
    x[..., 0, :] = e[..., 0, :]
    for t in range(1, shape[-2]):
        x[..., t, :] = rho * x[..., t - 1, :] + np.sqrt(1 - rho ** 2) \
            * e[..., t, :]
    return x


@pytest.fixture(scope="module")
def case():
    freq = np.logspace(6, -2, 21)
    _, tau, eps, cfg_j, data_j, _ = jax_build_shared(
        freq, mode="sample", ncp=True, dtype=jnp.float64)
    q0, unravel_j = ravel_pytree(init_unconstrained(
        cfg_j, data_j, jax.random.PRNGKey(0)))
    D = q0.shape[0]
    rng = np.random.default_rng(7)
    offs = 0.2 * rng.standard_normal((B, C, 1, D))
    draws = np.asarray(q0) + offs + 0.3 * _ar1(rng, (B, C, S, D))
    lp = (-50.0 + 3.0 * rng.standard_normal((B, C, 1))
          + 2.0 * _ar1(rng, (B, C, S, 1))[..., 0])
    info = {"logp": lp,
            "diverging": rng.uniform(size=(B, C, S)) < 0.05,
            "accept_prob": rng.uniform(size=(B, C, S)),
            "n_leapfrog": rng.integers(1, 33, size=(B, C, S)).astype(np.int32),
            "inv_mass": np.exp(rng.uniform(-1, 1, (B, C, D))),
            "step_size": np.exp(rng.uniform(-3, -1, (B, C)))}
    k0 = len(tau)
    mon_idx = np.unique(np.linspace(0, k0 - 1, 8).astype(int))
    phi_mon = np.exp(-(eps * np.log(tau[mon_idx][:, None]
                                    / tau[None, :])) ** 2)
    ge_tau = np.logspace(-7, 1, 9)
    phi_eval = np.exp(-(eps * np.log(ge_tau[:, None] / tau[None, :])) ** 2)
    return dict(cfg_j=cfg_j, data_j=data_j, unravel_j=unravel_j,
                draws=draws, info=info, phi_mon=phi_mon, phi_eval=phi_eval)


def _assert_close(got, want, name):
    """Within RTOL/ATOL; where the JAX package returns float32 (the mean of
    a bool array is float32 in jnp even under x64) within float32's
    rounding instead."""
    want = np.asarray(want)
    rtol, atol = (RTOL, ATOL) if want.dtype != np.float32 else (1e-7, 0.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=name)


def test_summarize_matches_jax(case):
    summ_j = jax_summarize(case["cfg_j"], case["unravel_j"], C, S, 1)
    out_j = jax.vmap(summ_j, in_axes=(None, 0, 0, None, None))(
        case["data_j"], jnp.asarray(case["draws"]),
        {k: jnp.asarray(v) for k, v in case["info"].items()},
        jnp.asarray(case["phi_mon"]), jnp.asarray(case["phi_eval"]))

    cfg, data = posterior_from_numpy(case["cfg_j"], case["data_j"],
                                     dtype=torch.float64, device="cpu")
    out = _make_summarize(cfg, C, S)(
        data, torch.as_tensor(case["draws"]),
        {k: torch.as_tensor(v) for k, v in case["info"].items()},
        torch.as_tensor(case["phi_mon"]), torch.as_tensor(case["phi_eval"]))

    assert set(out) == set(out_j)
    for k in sorted(out):
        assert tuple(out[k].shape) == tuple(out_j[k].shape), k
        _assert_close(out[k].numpy(), out_j[k], k)
    # the summary is not degenerate on these draws
    assert (out["logp_rhat"] > 1.0).all()
    assert (out["min_ess"] < C * S).all()
    assert (out["rank_rhat_max"] > 1.01).all()


@pytest.mark.parametrize("d_chunk", [32, None])
def test_rank_diagnostics_match_jax(case, d_chunk):
    draws = case["draws"]
    x = torch.as_tensor(draws)
    pairs = (
        (diagnostics.ess_jnp(x), jax.vmap(jax_diag.ess_jnp)),
        (diagnostics.rhat_rank_jnp(x, d_chunk=d_chunk),
         jax.vmap(lambda d: jax_diag.rhat_rank_jnp(d, d_chunk=d_chunk))),
        (diagnostics.ess_bulk_jnp(x, d_chunk=d_chunk),
         jax.vmap(lambda d: jax_diag.ess_bulk_jnp(d, d_chunk=d_chunk))),
    )
    for name, (got, fn_j) in zip(("ess", "rhat_rank", "ess_bulk"), pairs):
        want = fn_j(jnp.asarray(draws))
        assert tuple(got.shape) == (B, draws.shape[-1]), name
        _assert_close(got.numpy(), want, name)
        # without the batch axis the port gives the same per spectrum
        one = {"ess": lambda d: diagnostics.ess_jnp(d),
               "rhat_rank": lambda d: diagnostics.rhat_rank_jnp(
                   d, d_chunk=d_chunk),
               "ess_bulk": lambda d: diagnostics.ess_bulk_jnp(
                   d, d_chunk=d_chunk)}[name](x[1])
        _assert_close(one.numpy(), want[1], name + " unbatched")


def test_rank_helpers_match_jax(case):
    draws = case["draws"]
    x = torch.as_tensor(draws)
    _assert_close(diagnostics._rank_normalize_jnp(x).numpy(),
                  jax.vmap(jax_diag._rank_normalize_jnp)(jnp.asarray(draws)),
                  "rank_normalize")
    _assert_close(diagnostics._split_rhat_jnp(x).numpy(),
                  jax.vmap(jax_diag._split_rhat_jnp)(jnp.asarray(draws)),
                  "split_rhat")
    med = np.median(draws.reshape(B, C * S, -1), axis=1)
    _assert_close(diagnostics._median_pooled(x).numpy()[:, 0, 0], med,
                  "median_pooled")
    # parameter blocks are exact: chunked equals whole for any block size
    whole = diagnostics.rhat_rank_jnp(x)
    for d_chunk in (1, 7, 32):
        _assert_close(diagnostics._map_param_chunks(
            lambda d: diagnostics.rhat_rank_jnp(d), x, d_chunk).numpy(),
            whole.numpy(), f"map_param_chunks {d_chunk}")
