"""The span arithmetic (``spans.py``) on synthetic intervals, and a CPU
traced run of each cell reading every span metric."""

import json

import pytest
import torch

from portbench import core, spans
from portbench.devtrace import Event
from portbench.tests import cpu_cells


def sp(name, i, parent, start, end, device_s=None, fit=0, shard=None):
    return {"name": name, "id": i, "parent": parent, "fit": fit,
            "shard": shard, "start_ns": start, "end_ns": end,
            "device_s": device_s}


def test_idle_over_a_known_gap():
    # the device runs [100, 200) and [300, 400); the span covers [150,
    # 350): idle [200, 300)
    ev = [Event("k", True, 100, 200), Event("k", True, 300, 400),
          Event("aten::mm", False, 0, 500)]
    assert spans.idle([ev], [(150, 350)]) == (100, 200)
    # busy all through, and idle all through
    assert spans.idle([ev], [(100, 200)]) == (0, 100)
    assert spans.idle([ev], [(210, 290)]) == (80, 80)


def test_idle_cut_by_the_slice_edges():
    # the slices' windows are [0, 100) and [1000, 1100): a span over
    # [50, 1050) counts only what the profiler saw
    a = [Event("k", True, 0, 20), Event("op", False, 20, 100)]
    b = [Event("k", True, 1000, 1030), Event("op", False, 1030, 1100)]
    assert spans.idle([a, [], b], [(50, 1050)]) == (50 + 20, 50 + 50)
    # a span outside every slice is not traced
    assert spans.idle([a, b], [(200, 900)]) == (0, 0)


def test_idle_merges_overlapping_spans():
    ev = [Event("k", True, 0, 10), Event("op", False, 0, 100)]
    assert spans.idle([ev], [(0, 60), (40, 100), (50, 70)]) == (90, 100)


def test_self_time_of_nested_spans():
    s = [sp("sample/draw/traj/replay", 3, 2, 20, 30),
         sp("sample/draw/traj", 2, 1, 10, 40),
         sp("sample/draw", 1, None, 0, 100),
         sp("sample/draw/traj", 5, 4, 110, 150),
         sp("sample/draw", 4, None, 100, 160)]
    assert spans.self_ns(s, "sample/draw") == [70, 20]
    assert spans.self_ns(s, "sample/draw/traj") == [20, 40]
    assert spans.self_ns(s, "sample/draw/traj/replay") == [10]


def test_last_draws_by_fit_and_shard():
    s = [sp("sample/draw", i, None, 10 * i, 10 * i + 5, shard=i % 2)
         for i in range(6)]
    assert sorted(x["id"] for x in spans.last_draws(s, 2)) == [2, 3, 4, 5]


def test_device_seconds_and_counters():
    class Fit:
        def __init__(self, spans_, counters):
            self.diagnostics = {"spans": spans_, "counters": counters}

    class Ctx:
        mode = "optimize"

        def __init__(self, fits):
            self._fits = fits

        def spans(self):
            return self._fits

    ctx = Ctx([Fit([sp("polish/solve", 1, None, 0, 10, 0.25),
                    sp("polish/solve", 2, None, 10, 30, 0.5)],
                   {"polish/rows": 10}),
               Fit([sp("polish/solve", 3, None, 0, 2_000_000_000)],
                   {"polish/rows": 30})])
    # a CPU span's work runs inside its host interval
    assert spans.device_s_mean(ctx, "optimize", "polish/solve") == (
        pytest.approx((0.75 + 2.0) / 2))
    assert spans.counter_mean(ctx, "optimize", "polish/rows") == 20
    assert spans.device_s_mean(ctx, "sample", "polish/solve") is None
    assert spans.counter_mean(ctx, "optimize", "polish/iters") is None


NEW = {"zarc-shmc": ["summary_idle_share.sample", "draw_idle_share.sample"],
       "sp-shmc": ["draw_idle_share.generic", "draw_host_ms.generic"],
       "zarc-map": ["polish_hessian_s.map", "polish_solve_s.map",
                    "polish_idle_share.map", "polish_rows.map"]}
BUDGET = {"warmup": 12, "samples": 8}


def test_new_metrics_name_their_cells():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert listed[name] == [cell]


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_cpu_run_reads_every_span_metric(cell):
    torch.set_num_threads(1)
    traffic = {"batch": cpu_cells.SIZES[cell], "pool": 1}
    override = {"traffic": traffic}
    if cell == "zarc-map":
        traffic["map"] = {"init_from_ridge": True, "max_iter": 40,
                          "polish": True}
    else:
        traffic["escalate"] = False
        override["config"] = BUDGET
    out, _, _ = core.run(cell, cpu_cells.SEED, 0.0, 1, device="cpu",
                         warm=False, override=override)
    for name in NEW[cell]:
        assert name in out["metrics"], (name, sorted(out["metrics"]))
    m = out["metrics"]
    for name in NEW[cell]:
        if "idle_share" in name:
            # no device events on the CPU: every traced moment is idle
            assert m[name]["value"] == pytest.approx(100.0)
        else:
            assert m[name]["value"] > 0
