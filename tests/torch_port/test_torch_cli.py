"""The port's command line (``python -m bayes_drt_tpu_torch fit``) on the
CPU: the JAX package's CLI cases (tests/test_cli.py) run with
``--device cpu`` and their own bars, ground truth from
sim.reference_gamma; both CLIs on one directory in ridge mode, the
files' columns equal and their values within float32 rounding of each
other; ``--help`` in a subprocess; the exit codes; an import of the
package, sbc and the CLI with pandas and matplotlib blocked, which pulls
in neither JAX nor the JAX package; and profiling.trace."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from bayes_drt_tpu.cli import main as jax_main
from bayes_drt_tpu_torch import profiling, sim
from bayes_drt_tpu_torch.cli import main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# both CLIs' float32 ridge outputs, relative to each column's largest
# entry (see test_ridge_outputs_match_jax_cli)
PARITY_RTOL = 3e-3
# the fitted inductance is ~1e-9 H on these spectra (none in the
# circuit): held to 1e-10 H, whose reactance at the top frequency (1 MHz)
# is 6e-4 ohm, 0.06% of Rp
ATOL_FLOOR = {"inductance": 1e-10}


def _main(argv):
    return main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Four simulated ZARC spectra on two frequency grids (so the CLI must
    bucket), written as plain CSVs the loader understands."""
    d = tmp_path_factory.mktemp("spectra")
    rng = np.random.default_rng(0)
    grids = [np.logspace(6, -2, 65), np.logspace(5, -1, 49)]
    for i in range(4):
        freq = grids[i % 2]
        Z = sim.reference_circuit("ZARC", freq)
        Z = Z + 0.002 * (rng.standard_normal(len(Z))
                         + 1j * rng.standard_normal(len(Z)))
        pd.DataFrame({"Freq": freq, "Zreal": Z.real, "Zimag": Z.imag,
                      "Extra": np.arange(len(freq))}).to_csv(
            d / f"spec_{i}.csv", index=False)
    return d


def _ground_truth():
    tau = np.logspace(-8, 3, 500)
    gamma = sim.reference_gamma("ZARC", tau)
    return tau, gamma, np.trapezoid(gamma, np.log(tau))


def _rmse(path):
    tau, gt, _ = _ground_truth()
    g = pd.read_csv(path)
    gi = np.interp(tau, g["tau"].values, g["gamma"].values)
    return np.sqrt(np.mean((gi - gt) ** 2))


def test_cli_ridge_directory(data_dir, tmp_path):
    out = tmp_path / "out"
    rc = _main(["fit", str(data_dir), "--pattern", "*.csv",
                "--out", str(out), "--mode", "ridge"])
    assert rc == 0
    summary = pd.read_csv(out / "summary.csv")
    assert len(summary) == 4
    _, _, rp = _ground_truth()
    assert np.allclose(summary["Rp"], rp, rtol=0.15), summary["Rp"].values
    for i in range(4):
        g = pd.read_csv(out / f"Gout_spec_{i}.csv")
        assert list(g.columns) == ["tau", "gamma"]
        assert np.isfinite(g.values).all()


def test_cli_sample_writes_credible_bands(data_dir, tmp_path):
    out = tmp_path / "out_hmc"
    rc = _main(["fit", str(data_dir / "spec_0.csv"),
                str(data_dir / "spec_2.csv"), "--out", str(out),
                "--mode", "sample", "--chains", "2", "--warmup", "80",
                "--samples", "80", "--seed", "3"])
    assert rc == 0
    summary = pd.read_csv(out / "summary.csv")
    assert len(summary) == 2
    assert {"min_ess", "logp_split_rhat", "divergence_rate"} <= set(summary)
    g = pd.read_csv(out / "Gout_spec_0.csv")
    assert list(g.columns) == ["tau", "gamma", "gamma_lo", "gamma_hi"]
    assert (g["gamma_lo"] <= g["gamma_hi"]).all()
    assert (g["gamma"] >= g["gamma_lo"] - 1e-9).all()
    assert (g["gamma"] <= g["gamma_hi"] + 1e-9).all()
    _, _, rp = _ground_truth()
    rmse = _rmse(out / "Gout_spec_0.csv")
    assert rmse < 0.10 * rp, rmse


def test_cli_optimize_single_file(data_dir, tmp_path):
    out = tmp_path / "out_map"
    rc = _main(["fit", str(data_dir / "spec_1.csv"), "--out", str(out),
                "--mode", "optimize", "--max-iter", "800"])
    assert rc == 0
    _, _, rp = _ground_truth()
    rmse = _rmse(out / "Gout_spec_1.csv")
    assert rmse < 0.05 * rp, rmse


def test_cli_ridge_cv(data_dir, tmp_path):
    out = tmp_path / "out_cv"
    rc = _main(["fit", str(data_dir / "spec_0.csv"), "--out", str(out),
                "--mode", "ridge", "--ridge-cv", "--cv-grid", "1e-5,1,5"])
    assert rc == 0
    summary = pd.read_csv(out / "summary.csv")
    lam = float(summary["cv_lambda"].iloc[0])
    assert np.isclose(lam, np.logspace(-5, 0, 5), rtol=1e-10).any(), lam
    _, _, rp = _ground_truth()
    rmse = _rmse(out / "Gout_spec_0.csv")
    assert rmse < 0.10 * rp, rmse


def test_cli_ridge_outliers(data_dir, tmp_path):
    out = tmp_path / "out_hw"
    rc = _main(["fit", str(data_dir / "spec_0.csv"), "--out", str(out),
                "--mode", "ridge", "--outliers"])
    assert rc == 0
    _, _, rp = _ground_truth()
    rmse = _rmse(out / "Gout_spec_0.csv")
    assert rmse < 0.20 * rp, rmse
    # --ridge-cv and --outliers are mutually exclusive in ridge mode
    assert _main(["fit", str(data_dir / "spec_0.csv"), "--out", str(out),
                  "--mode", "ridge", "--outliers", "--ridge-cv"]) == 2


def test_cli_exit_codes(tmp_path, data_dir):
    assert _main(["fit", str(tmp_path), "--pattern", "*.nope"]) == 2
    for grid in ("1,1e-3,5", "1e-3,1,1", "a,b,c"):
        assert _main(["fit", str(data_dir / "spec_0.csv"), "--out",
                      str(tmp_path), "--ridge-cv", "--cv-grid", grid]) == 2
    with pytest.raises(NotImplementedError, match="item 12"):
        _main(["fit", str(data_dir / "spec_0.csv"), "--out", str(tmp_path),
               "--mesh"])
    # --sampler chees runs in both CLIs: the same files and columns,
    # finite bands
    outs = {}
    for name, run in (("port", _main), ("jax", jax_main)):
        outs[name] = tmp_path / f"chees_{name}"
        assert run(["fit", str(data_dir / "spec_0.csv"), "--out",
                    str(outs[name]), "--sampler", "chees", "--chains", "2",
                    "--warmup", "2", "--samples", "2"]) == 0
    assert (sorted(p.name for p in outs["port"].iterdir())
            == sorted(p.name for p in outs["jax"].iterdir()))
    for f in ("summary.csv", "Gout_spec_0.csv"):
        got, want = (pd.read_csv(outs[k] / f) for k in ("port", "jax"))
        assert list(got.columns) == list(want.columns), f
    g = pd.read_csv(outs["port"] / "Gout_spec_0.csv")
    assert np.isfinite(g.values).all()
    assert (g["gamma_lo"] <= g["gamma_hi"]).all()


def test_cli_skips_unparseable_file(data_dir, tmp_path):
    bad = tmp_path / "corrupt.csv"
    bad.write_text("this is not a spectrum\x00\x01")
    out = tmp_path / "out_skip"
    rc = _main(["fit", str(data_dir / "spec_0.csv"), str(bad),
                "--out", str(out), "--mode", "ridge"])
    assert rc == 0
    summary = pd.read_csv(out / "summary.csv")
    assert len(summary) == 2
    bad_row = summary[summary["file"] == "corrupt.csv"]
    assert bad_row["status"].iloc[0].startswith("load_error")
    ok = summary[summary["file"] == "spec_0.csv"]
    assert ok["status"].iloc[0] == "ok"
    assert float(ok["median_rel_resid"].iloc[0]) < 0.02


def test_cli_peak_fitting(data_dir, tmp_path):
    out = tmp_path / "out_peaks"
    rc = _main(["fit", str(data_dir / "spec_0.csv"), "--out", str(out),
                "--mode", "ridge", "--peaks"])
    assert rc == 0
    summary = pd.read_csv(out / "summary.csv")
    assert int(summary["n_peaks"].iloc[0]) >= 1
    assert float(summary["peak_fit_rmse_rel"].iloc[0]) < 0.15
    peaks = pd.read_csv(out / "Peaks_spec_0.csv")
    assert list(peaks.columns) == ["R", "tau0", "alpha", "beta"]
    top = peaks.iloc[peaks["R"].abs().idxmax()]
    assert 0.6 < top["R"] < 1.4
    assert 1e-4 < top["tau0"] < 1e-2


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


JAX_CLI_F32 = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from bayes_drt_tpu.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_ridge_outputs_match_jax_cli(data_dir, tmp_path):
    """Both CLIs in float32 (the JAX package's in a process of its own,
    x64 off) on one directory with a corrupt file: the same files, the
    same columns in the same order, the same non-numeric cells, and the
    numbers within PARITY_RTOL of each column's largest entry. The
    hyper-lambda ridge's box QP amplifies float32 rounding: the port and
    the JAX package part by up to 1.5e-3 of gamma's peak here, and the
    JAX package's own float32 and float64 fits by 6.9e-3."""
    bad = tmp_path / "bad.csv"
    bad.write_text("Freq,Zreal,Zimag\n")
    argv = ["fit", str(data_dir), str(bad), "--pattern", "*.csv",
            "--mode", "ridge"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_CLI_F32, *argv,
                          "--out", str(tmp_path / "jax")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert _main(argv + ["--out", str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 1 + 4
    for name in names:
        a, b = _rows(tmp_path / "jax" / name), _rows(tmp_path / "port" / name)
        assert a[0] == b[0], name
        assert len(a) == len(b), name
        for j, col in enumerate(a[0]):
            if col == "fit_seconds_bucket":
                continue
            ca = [r[j] for r in a[1:]]
            cb = [r[j] for r in b[1:]]
            try:
                xa = np.array([np.nan if c == "" else c for c in ca], float)
            except ValueError:
                assert ca == cb, (name, col)
                continue
            xb = np.array([np.nan if c == "" else c for c in cb], float)
            atol = max(PARITY_RTOL * np.nanmax(np.abs(xa)),
                       ATOL_FLOOR.get(col, 0.0))
            np.testing.assert_allclose(xb, xa, rtol=0, atol=atol,
                                       err_msg=f"{name}:{col}")


def test_module_help_in_subprocess():
    out = subprocess.run([sys.executable, "-m", "bayes_drt_tpu_torch", "fit",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--ridge-cv" in out.stdout


GUARD = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'matplotlib'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import bayes_drt_tpu_torch, bayes_drt_tpu_torch.sbc, bayes_drt_tpu_torch.cli
import bayes_drt_tpu_torch.native, bayes_drt_tpu_torch.io
import bayes_drt_tpu_torch.viz
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'bayes_drt_tpu', 'pandas', 'matplotlib')]
print(bad)
sys.exit(1 if bad else 0)
"""


def test_imports_without_pandas_matplotlib_or_jax():
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages() is not None
