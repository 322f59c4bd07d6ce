"""The reduced-precision arm, SHMCConfig(precision='high'): tf32x3
products on a CUDA device (_numerics.tf32x3_matmul), the counterpart of
the JAX package's bf16x3. On the CPU, as on XLA:CPU in the JAX package
(tests/test_round3.py:125-140), 'high' is 'highest' bit for bit; the
TF32 split is checked on the helper alone (its rounding, its error
bound, its gradient); the probe and the guard keep the JAX package's
keys, constants and escalation gate."""

import warnings

import jax
import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer.chees import SHMCConfig as JaxSHMCConfig
from bayes_drt_tpu.infer.chees import sample_shmc as jax_sample_shmc
from bayes_drt_tpu.parallel import batch as jax_batch
from bayes_drt_tpu_torch import _numerics, progcache, sim
from bayes_drt_tpu_torch.infer import chees
from bayes_drt_tpu_torch.parallel import batch
from bayes_drt_tpu_torch.parallel.batch import _build_shared

torch.set_num_threads(1)

FREQ = np.logspace(3, -1, 16)
BASIS = np.logspace(3.2, -1.2, 11)
SP = {"DRT": {"kernel": "DRT", "basis_freq": BASIS},
      "TP-DDT": {"kernel": "DDT", "bc": "transmissive",
                 "dist_type": "parallel", "basis_freq": BASIS,
                 "x_scale": 0.8}}


def _gaussian(d=5):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((d, d))
    cov = a @ a.T / d + 0.5 * np.eye(d)
    return cov, np.linalg.inv(cov)


def test_high_is_highest_on_the_cpu():
    """The generic sampler at 'high' draws what it draws at 'highest' on
    the CPU, bit for bit, on a Gaussian (the JAX test's, float64) and on
    a float32 Series-Parallel fit_spectra_batch, as XLA:CPU makes the JAX
    package's 'high'; the JAX package's own Gaussian run for both too."""
    cov, prec = _gaussian()
    d = cov.shape[0]
    P = torch.as_tensor(prec)

    def vg(q):
        g = -q @ P
        return 0.5 * torch.sum(q * g, dim=1), g

    q0 = torch.as_tensor(np.random.default_rng(7).standard_normal((4, d)))
    runs = [chees.sample_shmc(vg, q0, 200, 200,
                              chees.SHMCConfig(n_steps=16, precision=p), 4,
                              generator=torch.Generator().manual_seed(7))[0]
            for p in ("highest", "high")]
    assert torch.equal(*runs)
    logp = (lambda q: -0.5 * q @ (jax.numpy.asarray(prec) @ q))
    key = jax.random.PRNGKey(7)
    qj = jax.random.normal(key, (4, d))
    jruns = [np.asarray(jax_sample_shmc(
        logp, qj, key, warmup=100, samples=100,
        cfg=JaxSHMCConfig(n_steps=16, precision=p))[0])
        for p in ("highest", "high")]
    np.testing.assert_array_equal(*jruns)
    Z = sim.noisy_replicas(sim.series_parallel_circuit(FREQ), 2)
    kw = dict(distributions=SP, nonneg=True, ncp=True, chains=2, warmup=20,
              samples=10, sampler="shmc", escalate=False, device="cpu")
    fits = [batch.fit_spectra_batch(FREQ, Z, shmc_cfg=chees.SHMCConfig(
        n_steps=4, warm_steps=4, precision=p), **kw) for p in
        ("highest", "high")]
    assert np.array_equal(fits[0].coef, fits[1].coef)
    assert [f.diagnostics["precision"] for f in fits] == ["highest", "high"]
    assert "bf16x3_grad_err" not in fits[1].diagnostics   # CUDA only


def test_tf32_round():
    """Round to nearest, ties to even, at 10 explicit mantissa bits; the
    low 13 bits clear; idempotent; infinities and NaN pass through."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -12,
                      one + 2 ** -10 + 2 ** -12, -(one + 2 ** -11) * 4,
                      float("inf"), float("-inf"), float("nan")],
                     dtype=torch.float32)
    r = _numerics.tf32_round(x)
    want = [one, one + 2 ** -9, one, one + 2 ** -10, -4.0]
    assert r[:5].tolist() == want
    assert torch.isinf(r[5:7]).all() and torch.isnan(r[7])
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rv = _numerics.tf32_round(v)
    assert ((rv.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(_numerics.tf32_round(rv), rv)
    assert ((rv - v).abs() <= v.abs() * 2.0 ** -11).all()


def test_tf32x3_matmul_error_bound():
    """tf32x3 against the float64 product: within 2^-20 of sum |a||b|
    elementwise (the dropped lo x lo term and the lo pieces' own TF32
    rounding), against one TF32 product's ~2^-11; the same order as the
    true fp32 product's error."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn((64, 96), generator=g)
    b = torch.randn((96, 48), generator=g)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = ((_numerics.tf32x3_matmul(a, b).double() - exact).abs()
            / scale).max()
    err1 = ((_numerics.tf32_round(a).double()
             @ _numerics.tf32_round(b).double() - exact).abs() / scale).max()
    err_f32 = (((a @ b).double() - exact).abs() / scale).max()
    assert err3 <= 2.0 ** -20
    assert err1 > 2.0 ** -14
    assert err3 < 2.0 ** -8 * err1
    assert err3 < 16 * err_f32


def test_tf32x3_gradient():
    """The backward pass multiplies in tf32x3 too: the gradients of a
    broadcast product (rows (2, 5, K) against (K, M)) within the same
    bound of the float64 ones, summed over the broadcast axis."""
    g = torch.Generator().manual_seed(4)
    a = torch.randn((2, 5, 24), generator=g, requires_grad=True)
    b = torch.randn((24, 7), generator=g, requires_grad=True)
    w = torch.randn((2, 5, 7), generator=g)
    (_numerics.tf32x3_matmul(a, b) * w).sum().backward()
    a64, b64 = a.detach().double(), b.detach().double()
    ga = w.double() @ b64.T
    gb = (a64.mT @ w.double()).sum(dim=0)
    np.testing.assert_allclose(a.grad.numpy(), ga.numpy(), rtol=0,
                               atol=2.0 ** -19 * float(ga.abs().max()) * 24)
    np.testing.assert_allclose(b.grad.numpy(), gb.numpy(), rtol=0,
                               atol=2.0 ** -19 * float(gb.abs().max()) * 10)
    assert _numerics.matmul(a, b).dtype == torch.float32   # CPU: a @ b


def test_precision_context_keys_the_cache():
    """The precision context (the counterpart of precise_matmuls) is part
    of every progcache key made under 'high'; outside it keys stay as
    they were; an unknown precision raises."""
    progcache.clear()
    progcache.cached_program(("k",), lambda: 1)
    with progcache.precise_matmuls("high"):
        assert progcache.matmul_precision() == "high"
        progcache.cached_program(("k",), lambda: 2)
    assert progcache.matmul_precision() == "highest"
    assert set(progcache._CACHE) == {("k",), ("k", ("precision", "high"))}
    progcache.clear()
    with pytest.raises(ValueError, match="precision"):
        with progcache.precise_matmuls("medium"):
            pass


def test_probe_and_guard_keep_the_jax_keys():
    """The probe's shape (one value a spectrum, 0 on the CPU), the guard's
    diagnostics key and warning regime (n_steps > 64 or samples > 400),
    the JAX package's constants, and the escalation gate
    escalate_gate=dict(bf16x3_tol=...) flagging the same spectra as the
    JAX package's escalation_mask."""
    for k in ("BF16X3_GRAD_TOL", "BF16X3_WARN_STEPS", "BF16X3_WARN_SAMPLES"):
        assert getattr(batch, k) == getattr(jax_batch, k), k
    freq, tau, eps, cfg, data, _ = _build_shared(
        FREQ, distributions=SP, nonneg=True, ncp=True, dtype=torch.float64,
        device="cpu")
    b, chains = 3, 2
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, chains, batch.flat_dim(cfg, len(FREQ))),
                    generator=gen, dtype=torch.float64) * 0.1
    targets = torch.randn((b, 2 * len(FREQ)), generator=gen,
                          dtype=torch.float64)
    err = batch.tf32x3_grad_err(cfg, data, targets, q)
    assert err.shape == (b,) and (err == 0).all()
    diag = {"state_q": q.numpy()}
    for n_steps, samples, warns in ((32, 250, False), (65, 250, True),
                                    (32, 401, True)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            batch._tf32x3_guard(diag, cfg, data, targets, b, b, chees
                                .SHMCConfig(n_steps=n_steps,
                                            precision="high"), samples)
        hit = [w for w in rec if "outside the verified screening regime"
               in str(w.message)]
        assert bool(hit) == warns, (n_steps, samples)
        assert diag["bf16x3_grad_err"].shape == (b,)
    d = {"ess_bulk_min": np.full(3, 5.0), "logp_rhat": np.ones(3),
         "logp_chain_gap": np.zeros(3),
         "bf16x3_grad_err": np.array([1e-6, 3e-3, 1e-4])}
    for tol in (None, 1e-3, 1e-5):
        got = batch.escalation_mask(d, 3, bf16x3_tol=tol, n_draws=1000)
        want = jax_batch.escalation_mask(d, 3, bf16x3_tol=tol, n_draws=1000)
        np.testing.assert_array_equal(got, want)
    assert batch.escalation_mask(d, 3, bf16x3_tol=1e-3).tolist() == [
        False, True, False]
