"""Loading and running a cell imports no JAX and no JAX package (whole
top-level names), and the command refuses to run without a card or
without the program."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "bayes_drt_tpu"}

LOAD_EVERYTHING = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from portbench import compare, core, devtrace, gen, plainmodel, probe
bench = json.load(open(core.ROOT / "BENCHMARK.json"))
for w in bench["workloads"]:
    cell = core.load_cell(w["name"])
    ref = core.load_module(core.HERE / "reference" / f"{w['config']}.py",
                           "r_" + w["config"])
    ref.model(cell.config, cell.traffic["mode"], "cpu")
    core.fit_kwargs(cell, [1e-3], False, "cpu")
for m in bench["end_to_end"] + bench["per_layer"]:
    core.load_module(core.HERE / "metrics" / f"{m['name']}.py",
                     "m_" + m["name"].replace(".", "_"))
probe.Probe().install().uninstall()
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_loading_every_cell_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_EVERYTHING, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bayes_drt_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN


def test_whole_names_are_compared():
    import importlib.util
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  ROOT / "portbench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    saved = dict(sys.modules)
    try:
        sys.modules["bayes_drt_tpu_torch_extra"] = object()
        sys.modules["jaxtyping_like"] = object()
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & FORBIDDEN)
        sys.modules["jax.numpy"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        for k in ("bayes_drt_tpu_torch_extra", "jaxtyping_like",
                  "jax.numpy"):
            sys.modules.pop(k, None)


def command(cwd, tmp_path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "zarc-shmc",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})


def test_command_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command(ROOT, tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    shutil.copytree(ROOT / "portbench", alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(alone, tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
