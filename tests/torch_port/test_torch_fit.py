"""The port's batch fit end to end on the CPU, held to the analytic ZARC
distribution and, within Monte-Carlo error, to the JAX package's
flat-chain fit of the same batch; and the port's package boundary."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bayes_drt_tpu.infer.chees import SHMCConfig as JaxSHMCConfig
from bayes_drt_tpu.parallel import evaluate_gamma as jax_evaluate_gamma
from bayes_drt_tpu.parallel import fit_spectra_batch as jax_fit
from bayes_drt_tpu_torch import sim
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.ops.matrices import construct_A
from bayes_drt_tpu_torch.parallel import evaluate_gamma, fit_spectra_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
KW = dict(mode="sample", chains=2, warmup=60, samples=40, ncp=True,
          sampler="shmc", escalate=False)


def _batch():
    return sim.make_benchmark_batch(4, freq=np.logspace(5, -1, 31),
                                    noise_level=0.003, seed=3)


def _port_fit(seed):
    freq, Zb = _batch()
    cfg = SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5)
    return fit_spectra_batch(freq, Zb, random_seed=seed, shmc_cfg=cfg,
                             dtype=np.float32, device="cpu", **KW)


@pytest.fixture(scope="module")
def port_fits():
    return [_port_fit(0), _port_fit(1)]


def test_fit_end_to_end_recovers_zarc(port_fits):
    res = port_fits[0]
    assert res.coef.shape == (4, len(res.tau))
    assert np.isfinite(res.coef).all()
    d = res.diagnostics
    for k in ("logp_rhat", "min_ess", "ess_bulk_min", "rank_rhat_max",
              "metric_lambda_max", "divergence_rate", "z_hat_mean"):
        assert np.isfinite(d[k]).all(), k
    assert d["state_q"].shape == (4, 2, 2 * len(res.tau) + 9)
    assert (d["accept_prob"] > 0.2).all()
    gt = sim.reference_gamma("ZARC", res.tau)
    rp = np.trapezoid(gt, np.log(res.tau))
    g = evaluate_gamma(res, res.tau)
    rmse = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    assert (rmse < 0.15 * rp).all(), rmse / rp
    assert (evaluate_gamma(res, res.tau, "lo")
            <= evaluate_gamma(res, res.tau, "hi") + 1e-12).all()


def test_posterior_means_match_jax_within_mc_error(port_fits):
    """Two seeds per package. Under the null (same posterior, independent
    chains) the difference of the packages' two-seed means has the spread
    of one seed-to-seed difference over sqrt(2); the RMS over every
    spectrum and tau of that difference, over the pooled seed-to-seed
    spread, sits near 1 and must stay below 2."""
    freq, Zb = _batch()
    cfg_j = JaxSHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5,
                          flat_chain=True)
    res_j = [jax_fit(freq, Zb, random_seed=s, shmc_cfg=cfg_j,
                     dtype=np.float32, **KW) for s in (0, 1)]
    tau = port_fits[0].tau
    np.testing.assert_allclose(tau, res_j[0].tau, rtol=1e-12)

    def ratio(t, j):
        spread = np.sqrt(np.mean((t[0] - t[1]) ** 2 + (j[0] - j[1]) ** 2)
                         / 2.0)
        diff = 0.5 * (t[0] + t[1]) - 0.5 * (j[0] + j[1])
        return np.sqrt(np.mean(diff ** 2)) / (spread / np.sqrt(2.0))

    r_gamma = ratio([evaluate_gamma(r, tau) for r in port_fits],
                    [np.asarray(jax_evaluate_gamma(r, tau)) for r in res_j])
    r_rinf = ratio([r.r_inf for r in port_fits], [r.r_inf for r in res_j])
    print(f"gamma ratio {r_gamma:.3f}, r_inf ratio {r_rinf:.3f}")
    assert r_gamma < 2.0 and r_rinf < 2.0, (r_gamma, r_rinf)


def _port_files():
    return sorted((REPO / "bayes_drt_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    banned = ("jax", "jaxlib", "bayes_drt_tpu")
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
    code = (
        "import pkgutil, sys, importlib\n"
        "import bayes_drt_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bayes_drt_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    freq, Zb = _batch()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_spectra_batch(freq, Zb, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        construct_A(freq, "real")


def test_unported_options_raise():
    freq, Zb = _batch()
    # monitor_thin (item 10d, ported): the JAX package's layout, and in
    # both packages the unthinned monitor columns average to the fit's own
    # R_inf, inductance and gamma means (physical units)
    ge_tau = np.array([1e-4, 1e-2])
    kw = {**KW, "warmup": 20, "samples": 10, "monitor_thin": 1,
          "gamma_eval_tau": ge_tau, "dtype": np.float32}
    got = fit_spectra_batch(freq, Zb, device="cpu", shmc_cfg=SHMCConfig(
        n_steps=8, warm_steps=8, eps_quantile=0.5), **kw)
    want = jax_fit(freq, Zb, shmc_cfg=JaxSHMCConfig(
        n_steps=8, warm_steps=8, eps_quantile=0.5, flat_chain=True), **kw)
    for res in (got, want):
        md = np.asarray(res.diagnostics["monitor_draws"], float)
        assert md.shape == (4, 2 * 10, 6 + 2)
        assert (md[:, :, :6] > 0).all()
        np.testing.assert_allclose(md[:, :, 0].mean(1), res.r_inf,
                                   rtol=1e-5)
        np.testing.assert_allclose(md[:, :, 1].mean(1), res.inductance,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            md[:, :, 6:].mean(1), res.diagnostics["gamma_eval_mean"],
            rtol=1e-5, atol=1e-6 * np.abs(md[:, :, 6:]).max())
    # sampler='chees' (item 12's first piece, ported): both packages run
    # it on these spectra, with the same diagnostics and shapes, the
    # trajectory time per spectrum and finite coefficients
    from bayes_drt_tpu.infer.chees import ChEESConfig as JaxChEESConfig
    from bayes_drt_tpu_torch.infer.chees import ChEESConfig
    kw_c = {**KW, "sampler": "chees", "warmup": 30, "samples": 20}
    got_c = fit_spectra_batch(freq, Zb, device="cpu",
                              chees_cfg=ChEESConfig(max_steps=32), **kw_c)
    want_c = jax_fit(freq, Zb, chees_cfg=JaxChEESConfig(max_steps=32),
                     **kw_c)
    for k, v in want_c.diagnostics.items():
        if k != "state_cfg":
            assert np.shape(got_c.diagnostics[k]) == np.shape(v), k
    assert got_c.diagnostics["state_traj_time"].shape == (4,)
    assert np.isfinite(got_c.coef).all()
    # warm_start and precondition (ported with item 12's metric family)
    # keep the JAX package's guards; a result carrying no sampler state
    # and the pooled metric on SHMC raise them
    with pytest.raises(ValueError, match="missing diagnostics"):
        fit_spectra_batch(freq, Zb, device="cpu", **KW,
                          warm_start=got._replace(diagnostics={}))
    with pytest.raises(ValueError, match="builds a dense metric"):
        fit_spectra_batch(freq, Zb, device="cpu", precondition="pooled",
                          **KW)
    with pytest.raises(ValueError, match="Unknown sampler"):
        fit_spectra_batch(freq, Zb, device="cpu",
                          **{**KW, "sampler": "hmc"})
    # the flat-chain SHMC sampler takes no ridge seed (nor does the JAX
    # package's flat-chain path)
    with pytest.raises(ValueError, match="init_from_ridge"):
        fit_spectra_batch(freq, Zb, device="cpu", init_from_ridge=True,
                          **KW)
