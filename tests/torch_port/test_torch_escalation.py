"""The port's escalation gate, splice, quality presets, escalate=None
semantics and ridge-seeded sample init against the JAX package, and a
forced escalation end to end (float64 on the CPU)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu.models.posterior import constrain as jax_constrain
from bayes_drt_tpu.models.posterior import \
    init_unconstrained as jax_init_unconstrained
from bayes_drt_tpu.parallel import batch as jax_batch
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.parallel import batch

torch.set_num_threads(1)

TINY = dict(chains=2, warmup=20, samples=20, ncp=True, device="cpu",
            dtype=torch.float64)


def _batch(b=3, seed=3):
    return sim.make_benchmark_batch(b, freq=np.logspace(5, -1, 21),
                                    noise_level=0.003, seed=seed)


def _diagnostics(seed, b=40, optional=True):
    rng = np.random.default_rng(seed)
    d = {"ess_bulk_min": rng.uniform(0.5, 6.0, b),
         "logp_rhat": rng.uniform(1.0, 8.0, b)}
    if optional:
        d["logp_chain_gap"] = rng.uniform(0.0, 300.0, b)
        d["metric_lambda_max"] = rng.uniform(1.0, 50.0, b)
        d["bf16x3_grad_err"] = rng.uniform(0.0, 2e-3, b)
    return d


GATE_CASES = {
    "defaults_screening_budget": (True, dict(n_draws=1000)),
    "defaults_strict_budget": (True, dict(n_draws=2000)),
    "defaults_no_budget": (True, {}),
    "explicit_every_gate": (True, dict(ess_bulk_min=3.0, logp_rhat=2.0,
                                       lambda_max=20.0, logp_gap=50.0,
                                       bf16x3_tol=1e-3, n_draws=1000)),
    "required_keys_only": (False, dict(n_draws=2000, ess_bulk_min=1.5)),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_escalation_mask_matches_jax(case):
    optional, kw = GATE_CASES[case]
    d = _diagnostics(len(case), optional=optional)
    got = batch.escalation_mask(d, 37, **kw)
    want = jax_batch.escalation_mask(d, 37, **kw)
    assert got.dtype == bool and got.shape == (37,)
    assert np.array_equal(got, want)
    assert 0 < got.sum() < 37


def _results(cls, rng_seed, b):
    rng = np.random.default_rng(rng_seed)
    k = 6

    def a(*shape):
        return rng.standard_normal(shape)

    diag = {"logp_rhat": a(b), "gamma_eval_lo": a(b, 4),
            "state_q": a(b, 2, 9), "ess_bulk_min": a(b),
            "shared_grid": a(k + 1), "phase_s": {"sample": 1.0},
            "note": "kept"}
    return cls(coef=a(b, k), r_inf=a(b), inductance=a(b), gamma_lo=a(b, k),
               gamma_hi=a(b, k), z_scales=a(b), tau=np.logspace(-5, 0, k),
               epsilon=1.5, diagnostics=diag)


def test_splice_results_matches_jax():
    mask = np.array([False, True, False, True, False])
    pair = []
    for cls in (batch.BatchFitResult, jax_batch.BatchFitResult):
        res = _results(cls, 0, 5)
        sub = _results(cls, 1, 2)
        sub.diagnostics["state_q"] = np.zeros((2, 3, 9))   # other shape
        pair.append(getattr(batch if cls is batch.BatchFitResult
                            else jax_batch, "_splice_results")(res, sub,
                                                               mask))
    got, want = pair
    for name in ("coef", "r_inf", "inductance", "gamma_lo", "gamma_hi",
                 "z_scales", "tau"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert set(got.diagnostics) == set(want.diagnostics)
    for k, v in want.diagnostics.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got.diagnostics[k], v), k
        else:
            assert got.diagnostics[k] == v, k


def test_quality_preset_errors_and_fields():
    freq, Zb = _batch(1)
    with pytest.raises(ValueError, match="Unknown quality"):
        batch.fit_spectra_batch(freq, Zb, quality="wat", device="cpu")
    with pytest.raises(ValueError, match="mode='sample'"):
        batch.fit_spectra_batch(freq, Zb, mode="optimize", quality="fast",
                                device="cpu")
    port, ref = batch.QUALITY_PRESETS, jax_batch.QUALITY_PRESETS
    assert set(port) == set(ref) >= {"fast", "strict"}
    for name in port:
        p, r = dict(port[name]), dict(ref[name])
        cfg_p, cfg_r = p.pop("shmc_cfg", None), r.pop("shmc_cfg", None)
        assert p == r, name
        if cfg_r is not None:
            # every field but the reduced precision: the port's preset
            # stays fp32, tf32x3 being slower a draw on the card
            for f in SHMCConfig._fields:
                want = getattr(cfg_r, f)
                if f == "precision":
                    want = "highest"
                assert getattr(cfg_p, f) == want, (name, f)
    assert port["strict"]["sampler"] == "nuts"


class _Reached(Exception):
    pass


@pytest.mark.parametrize("name", ["fast", "strict"])
def test_quality_preset_reaches_the_sampler(monkeypatch, name):
    seen = {}

    def stop(*args, **kw):
        seen.update(args=args, kw=kw)
        raise _Reached

    monkeypatch.setattr(batch, "sample_nuts", stop)
    monkeypatch.setattr(batch, "sample_shmc_flat", stop)
    freq, Zb = _batch(1)
    with pytest.raises(_Reached):
        batch.fit_spectra_batch(freq, Zb, quality=name, sampler="nuts",
                                chains=9, warmup=1, samples=1, device="cpu")
    args = seen["args"]
    if name == "fast":
        cfg = args[6]
        assert (args[4], args[5], args[7]) == (150, 250, 4)
        assert cfg == batch.QUALITY_PRESETS["fast"]["shmc_cfg"]
    else:
        cfg = args[4]
        assert (args[1].shape[0] // 8, args[2], args[3]) == (4, 1000, 1000)
        assert (cfg.max_depth, cfg.tree_scan, cfg.scan_unroll) == (8, True, 2)


ESCALATE_CASES = {
    # (fit arguments, is the mask recorded)
    "shmc_default_on": (dict(sampler="shmc",
                             shmc_cfg=SHMCConfig(n_steps=4, warm_steps=4)),
                        True),
    "nuts_default_on": (dict(max_tree_depth=3), True),
    "nuts_ridge_seeded_off": (dict(max_tree_depth=3, init_from_ridge=True),
                              False),
    "explicit_off": (dict(sampler="shmc", escalate=False,
                          shmc_cfg=SHMCConfig(n_steps=4, warm_steps=4)),
                     False),
}


@pytest.mark.parametrize("case", sorted(ESCALATE_CASES))
def test_escalate_none_semantics(case):
    kw, recorded = ESCALATE_CASES[case]
    freq, Zb = _batch(2)
    res = batch.fit_spectra_batch(freq, Zb, escalate_gate=dict(
        ess_bulk_min=0.0), **TINY, **kw)
    assert ("escalated" in res.diagnostics) == recorded
    if recorded:
        assert not res.diagnostics["escalated"].any()


def test_forced_escalation_splices_only_flagged_rows(monkeypatch):
    freq, Zb = _batch(4, seed=8)
    kw = dict(TINY, sampler="shmc", warmup=30,
              shmc_cfg=SHMCConfig(n_steps=6, warm_steps=6, eps_quantile=0.5))
    base = batch.fit_spectra_batch(freq, Zb, escalate=False, **kw)
    ess = np.sort(base.diagnostics["ess_bulk_min"])
    thr = 0.5 * (ess[1] + ess[2])              # flags the two lowest
    seen = {}
    splice = batch._splice_results

    def spy(result, sub, mask):
        seen.update(sub=sub, mask=mask)
        return splice(result, sub, mask)

    monkeypatch.setattr(batch, "_splice_results", spy)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = batch.fit_spectra_batch(freq, Zb,
                                      escalate_gate=dict(ess_bulk_min=thr),
                                      escalate_kw=dict(max_tree_depth=3),
                                      **kw)
    assert any("2/4 spectra failed the mixing gate" in str(x.message)
               for x in w)
    mask = res.diagnostics["escalated"]
    assert np.array_equal(mask, base.diagnostics["ess_bulk_min"] < thr)
    sub = seen["sub"]
    assert sub.coef.shape[0] == 2
    for name in ("coef", "r_inf", "inductance", "gamma_lo", "gamma_hi",
                 "z_scales"):
        got = getattr(res, name)
        assert np.array_equal(got[~mask], getattr(base, name)[~mask]), name
        assert np.array_equal(got[mask], getattr(sub, name)), name
    for k in ("ess_bulk_min", "logp_rhat", "z_hat_mean"):
        assert np.array_equal(res.diagnostics[k][mask], sub.diagnostics[k])
        assert np.array_equal(res.diagnostics[k][~mask],
                              base.diagnostics[k][~mask])


@pytest.mark.parametrize("model", ["ncp", "centered", "nonneg_ncp"])
def test_ridge_seeded_init_matches_jax_transform(monkeypatch, model):
    """Every chain of a ridge-seeded NUTS fit starts at the coordinates
    JAX's init_unconstrained gives the JAX package's ridge solution: the
    constrained x, R_inf and inductance of the port's q0 equal those of
    JAX's init from JAX's ridge."""
    ncp = model != "centered"
    nonneg = model.startswith("nonneg")
    seen = {}

    def stop(vg, q0, *a, **k):
        seen["q0"] = q0
        raise _Reached

    monkeypatch.setattr(batch, "sample_nuts", stop)
    freq, Zb = _batch(3)
    with pytest.raises(_Reached):
        batch.fit_spectra_batch(freq, Zb, init_from_ridge=True,
                                **dict(TINY, ncp=ncp, nonneg=nonneg))
    q0 = seen["q0"].numpy().reshape(8, 2, -1)[:3]

    f_desc = np.sort(freq)[::-1]
    Z_desc = Zb[:, np.argsort(freq)[::-1]]
    _, _, _, cfg_j, data_j, _ = jax_batch._build_shared(
        f_desc, mode="sample", ncp=ncp, nonneg=nonneg, dtype=jnp.float64)
    rres = jax_batch.ridge_fit_spectra_batch(
        f_desc, Z_desc, penalty="integral", hyper_lambda=True, lambda_0=1.0,
        hl_beta=5, weights="modulus", dtype=jnp.float64)
    zs = np.std(np.abs(Z_desc), axis=1) / np.sqrt(len(freq) / 81)
    template = jax_init_unconstrained(cfg_j, data_j, jax.random.PRNGKey(0))
    _, unravel = ravel_pytree(template)
    for i in range(3):
        iv = {"x_0": jnp.asarray(rres.coef[i] / zs[i]),
              "Rinf_raw": max(rres.r_inf[i] / zs[i], 1e-10) / 100.0,
              "induc_raw": max(rres.inductance[i] / zs[i], 1e-10)}
        want = jax_constrain(cfg_j, data_j, jax_init_unconstrained(
            cfg_j, data_j, jax.random.PRNGKey(i), init_values=iv))
        for c in range(2):
            got = jax_constrain(cfg_j, data_j, unravel(jnp.asarray(
                q0[i, c])))
            for key in ("x_0", "Rinf", "induc"):
                np.testing.assert_allclose(
                    np.asarray(got[key]), np.asarray(want[key]), rtol=1e-8,
                    atol=1e-12, err_msg=f"{key} spectrum {i} chain {c}")
