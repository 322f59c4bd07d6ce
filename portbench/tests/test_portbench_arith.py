"""Operation counts, the roofline, mfu and idle arithmetic, and the trace
reduction, on synthetic intervals."""

import importlib.util
from pathlib import Path

import pytest

from portbench import devtrace, peaks
from portbench.devtrace import Event

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k1_counts_at_the_cell_shapes():
    k1 = metric("k1_roofline")
    ops_s, bytes_s = k1.bound_s(n=81, K=101, D=211, R=4096, n_leap=32)
    # 93,930 FMA a row and leaf on the fp32 CUDA cores
    assert ops_s == pytest.approx(2 * 4096 * 32 * 93930 / 67e12, rel=1e-12)
    assert ops_s > bytes_s            # operation-bound
    assert ops_s * 1e3 == pytest.approx(0.3676, abs=1e-4)


def test_flops_a_gradient():
    mfu = metric("sample_mfu")
    assert mfu.flops_per_gradient(81, [101]) == 2 * 93930
    assert mfu.flops_per_gradient(81, [81, 81]) == 2 * 2 * (
        2 * 162 * 81 + 6 * 81 * 81)


def test_union_and_gaps():
    ev = [Event("k1", True, 100, 200), Event("k2", True, 150, 260),
          Event("k1", True, 400, 500), Event("aten::sort", False, 260, 400),
          Event("cudaStreamSynchronize", False, 500, 900),
          Event("portbench.fit", False, 0, 1000)]
    s = devtrace.summarize([ev])
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(260e-9)      # [100,260] + [400,500]
    assert s.kernels["k1"] == (2, pytest.approx(200e-9))
    assert s.gaps[0] == ("cudaStreamSynchronize", pytest.approx(500e-9))
    assert ("aten::sort", pytest.approx(140e-9)) in s.gaps
    # the lead-in before the first kernel: only the harness's own span
    assert ("host (no traced op)", pytest.approx(100e-9)) in s.gaps
    assert s.device_ops[0] == ("k1", pytest.approx(200e-9))
    assert devtrace.kernel_time(s, "k") == (3, pytest.approx(310e-9))


def test_slices_add_up():
    a = [Event("k1", True, 0, 50), Event("aten::mm", False, 50, 100)]
    b = [Event("k1", True, 1000, 1030), Event("cudaGraphLaunch", False,
                                              1030, 1100)]
    s = devtrace.summarize([a, [], b])
    assert s.window_s == pytest.approx(200e-9)
    assert s.busy_s == pytest.approx(80e-9)
    assert s.kernels["k1"] == (2, pytest.approx(80e-9))
    assert s.gaps == [("cudaGraphLaunch", pytest.approx(70e-9)),
                      ("aten::mm", pytest.approx(50e-9))]
    assert devtrace.summarize([[], []]) is None


def ctx(mode, trace=None, fits=None, workload="zarc-shmc"):
    from portbench import core
    cell = core.load_cell(workload)
    return core.Ctx(cell=cell, mode=mode,
                    shapes={"n": 81, "K": [101], "D": 211, "R": 4096},
                    fits=fits or [], setup_s=12.5, trace=trace)


def fit(start, end, kind="plain", **diag):
    from portbench.core import FitRecord
    return FitRecord(start, end, 1024, diag, kind)


def test_idle_and_roofline_readers():
    from portbench.devtrace import TraceSummary
    secs = 400 * 0.3676e-3 / 0.25          # K1 at 25% of its bound
    tr = TraceSummary(kernels={"void traj_kernel<float>(...)": (400, secs)},
                      busy_s=0.75, window_s=1.0, gaps=[], device_ops=[])
    c = ctx("sample", trace=tr)
    assert metric("idle_share.sample").read(c) == pytest.approx(25.0)
    assert metric("idle_share.generic").read(c) == pytest.approx(25.0)
    assert metric("idle_share.map").read(c) is None
    assert metric("k1_roofline").read(c) == pytest.approx(25.0, rel=1e-3)
    assert metric("k1_roofline").read(ctx("sample")) is None


def test_rates_mfu_and_means():
    """A traced window: the profiled fit, then fits with the program
    spans on and plain ones; spans are read from the first, the whole
    fit's mfu from the plain ones alone."""
    fits = [fit(0.0, 1.0, "profiled", phase_s={"summary": 9.0}),
            fit(1.0, 2.5, "spans", phase_s={"summary": 0.4}),
            fit(2.5, 3.5, "plain"),
            fit(3.5, 5.0, "spans", phase_s={"summary": 0.6}),
            fit(5.0, 6.0, "plain")]
    c = ctx("sample", fits=fits)
    assert metric("sample_spectra_per_min").read(c) == pytest.approx(
        60 * 5 * 1024 / 6.0)
    assert metric("sample_spectra_per_min.generic").read(c) == (
        metric("sample_spectra_per_min").read(c))
    assert metric("map_spectra_per_min").read(c) is None
    assert metric("summary_s.sample").read(c) == pytest.approx(0.5)
    assert metric("summary_s.generic").read(c) == pytest.approx(0.5)
    want = 100 * 4096 * 400 * 32 * 187860 / 1.0 / peaks.FP32_FLOPS
    assert metric("sample_mfu").read(c) == pytest.approx(want)
    assert metric("setup_s").read(c) == 12.5


@pytest.mark.parametrize("trace", [0, 1])
def test_fit_kinds(trace):
    from portbench.core import fit_kind
    kinds = [fit_kind(trace, i) for i in range(5)]
    if trace:
        assert kinds == ["profiled", "spans", "plain", "spans", "plain"]
    else:
        assert kinds == ["plain"] * 5


def test_map_readers():
    import numpy as np
    fits = [fit(0.0, 10.0, "spans", phase_s={"lbfgs": 6.0, "polish": 3.0},
                n_iter_lbfgs=np.array([100.0, 1500.0]))]
    c = ctx("optimize", fits=fits, workload="zarc-map")
    assert metric("lbfgs_iter_ms.map").read(c) == pytest.approx(4.0)
    assert metric("polish_s.map").read(c) == pytest.approx(3.0)
    assert metric("map_spectra_per_min").read(c) == pytest.approx(6144.0)


def test_escalated_share():
    import numpy as np

    from portbench import compare
    fits = [fit(0, 1, escalated=np.array([True] + [False] * 9)),
            fit(1, 2, escalated=np.zeros(10, bool))]
    c = ctx("sample", fits=fits)
    assert metric("escalated_share.sample").read(c) == pytest.approx(5.0)
    assert metric("draw_ms.generic").read(c) is None

    class R:
        diagnostics = {"escalated": fits[0].diagnostics["escalated"]}

    one = compare.Fit(None, R(), {}, 4, {})
    assert compare.escalated(one, None) == pytest.approx(10.0)


def test_slices_tick_on_torch_calls(monkeypatch):
    """Every torch call between start and finish ticks the slices: the
    profiler switches with no hook in the program."""
    import torch
    s = devtrace.Slices(on_s=1.0, every_s=1.0)
    ticks = []
    monkeypatch.setattr(s, "tick", lambda: ticks.append(1))
    monkeypatch.setattr(s, "_on", lambda: None)
    s.start()
    torch.ones(3).sum()
    torch.zeros(2) + 1
    s.finish()
    n = len(ticks)
    assert n >= 3
    torch.ones(3).sum()
    assert len(ticks) == n
