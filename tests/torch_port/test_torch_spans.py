"""The port's span-and-counter recorder (profiling.py) on tiny CPU fits:
nothing recorded with timing off, every span inside its parent with the
names each layer records, the counters against independent counts, the
timing views (phase_s, draw_s, n_iter_lbfgs) unchanged, and the spans'
clock against torch.profiler's."""

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bayes_drt_tpu_torch import profiling, sim
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.infer.map import newton_polish
from bayes_drt_tpu_torch.parallel import fit_spectra_batch
from bayes_drt_tpu_torch.parallel.mesh import make_mesh, run_shards

WARMUP, SAMPLES = 20, 10
SHMC = SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5)
SUMMARY = {"summary/constrain", "summary/percentiles", "summary/ess",
           "summary/rank", "summary/power_iter", "summary/predict",
           "summary/to_host"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    return sim.make_benchmark_batch(4, freq=np.logspace(5, -1, 31))


def _sampled(**kw):
    freq, Z = _batch()
    args = dict(chains=2, warmup=WARMUP, samples=SAMPLES, ncp=True,
                sampler="shmc", shmc_cfg=SHMC, device="cpu")
    args.update(kw)
    return fit_spectra_batch(freq, Z, **args)


def _map(**kw):
    freq, Z = _batch()
    return fit_spectra_batch(freq, Z, mode="optimize", init_from_ridge=True,
                             max_iter=60, device="cpu", **kw)


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _check_tree(spans):
    """Each span inside its parent, each self time >= 0; returns
    {name: parent's name}."""
    by_id = _by_id(spans)
    child_ns = Counter()
    parents = {}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"], s
        if s["parent"] is None:
            assert s["name"] == "fit", s
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= (
            p["end_ns"]), (s, p)
        child_ns[p["id"]] += s["end_ns"] - s["start_ns"]
        parents.setdefault(s["name"], set()).add(p["name"])
    for s in spans:
        assert s["end_ns"] - s["start_ns"] - child_ns[s["id"]] >= 0, s
    return parents


def test_timing_off_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(profiling.Recorder, "add",
                        lambda self, *a: made.append(a))

    def no_sync(*a, **k):
        raise AssertionError("a synchronize with timing off")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    res = _sampled(escalate=False)
    opt = _map()
    for r in (res, opt):
        assert not {"spans", "counters", "phase_s"} & set(r.diagnostics)
    assert made == [] and profiling._on == 0


def test_span_is_one_check_when_off():
    assert profiling.span("x") is profiling.span("y") is profiling._NULL
    profiling.count("x")
    assert profiling.fork() is None


def test_stage_timer_marks_laps_and_off():
    t = profiling.StageTimer("cpu")
    for _ in range(3):
        with t.stage("draw"):
            sum(range(1000))
    t.mark("setup")
    t.mark("sample")
    assert len(t.laps["draw"]) == 3
    assert t.stages["draw"] == pytest.approx(sum(t.laps["draw"]))
    assert set(t.summary()) == {"draw", "setup", "sample"}
    off = profiling.StageTimer("cpu", on=False, phases=True)
    with off.stage("draw"):
        pass
    off.mark("setup")
    assert off.stages == {} and off.laps == {}


def test_flat_shmc_spans_and_views():
    res = _sampled(escalate_gate=dict(ess_bulk_min=np.inf),
                   escalate_kw=dict(max_tree_depth=3), timing=True)
    d = res.diagnostics
    assert d["shmc_route"] == "flat-kernel"
    parents = _check_tree(d["spans"])
    own = {s["name"] for s in d["spans"] if s["fit"] == 0}
    assert own == {"fit", "setup", "sample", "summary", "sample/draw",
                   "sample/draw/traj", "escalate", "escalate/gate",
                   "escalate/refit"} | SUMMARY
    assert parents["sample/draw"] == {"sample"}
    assert parents["sample/draw/traj"] == {"sample/draw"}
    assert all(parents[n] == {"summary"} for n in SUMMARY)
    assert parents["escalate/gate"] == parents["escalate/refit"] == {
        "escalate"}
    # the refit is a fit of its own under escalate/refit
    roots = [s for s in d["spans"] if s["name"] == "fit"]
    assert sorted(s["fit"] for s in roots) == [0, 1]
    assert parents["fit"] == {"escalate/refit"}
    names = Counter(s["name"] for s in d["spans"] if s["fit"] == 0)
    assert names["sample/draw"] == names["sample/draw/traj"] == (
        WARMUP + SAMPLES)
    assert d["counters"]["sample/draws"] == WARMUP + SAMPLES
    assert d["counters"]["escalate/rows"] == int(d["escalated"].sum()) == 4
    assert set(d["phase_s"]) == {"setup", "sample", "summary"}
    refit = next(s for s in d["spans"] if s["name"] == "escalate/refit")
    assert d["refit_s"] == pytest.approx(
        (refit["end_ns"] - refit["start_ns"]) * 1e-9)
    # the phases' host intervals are phase_s's
    for s in d["spans"]:
        if s["fit"] == 0 and s["name"] in d["phase_s"]:
            assert (s["end_ns"] - s["start_ns"]) * 1e-9 == pytest.approx(
                d["phase_s"][s["name"]], abs=2e-3)
    assert all(s["device_s"] is None and s["shard"] is None
               for s in d["spans"])


def test_generic_shmc_spans_and_views():
    res = _sampled(outliers=True, escalate=False, timing=True)
    d = res.diagnostics
    assert d["shmc_route"] == "generic"
    parents = _check_tree(d["spans"])
    assert set(parents) == {"setup", "sample", "summary", "sample/draw",
                            "sample/draw/traj"} | SUMMARY
    assert d["counters"] == {"sample/draws": WARMUP + SAMPLES}
    assert set(d["phase_s"]) == {"setup", "sample", "summary"}
    assert d["draw_s"].shape == (WARMUP + SAMPLES,)
    assert (d["draw_s"] > 0).all()
    # draw_s closes each draw around its span
    draws = [s for s in d["spans"] if s["name"] == "sample/draw"]
    assert all((s["end_ns"] - s["start_ns"]) * 1e-9 <= t + 1e-4
               for s, t in zip(draws, d["draw_s"]))


def test_map_spans_counters_and_views():
    res = _map(timing=True)
    d = res.diagnostics
    parents = _check_tree(d["spans"])
    assert set(parents) == {"setup", "ridge", "lbfgs", "polish",
                            "lbfgs/iter", "polish/check", "polish/hessian",
                            "polish/solve", "polish/step"}
    assert parents["lbfgs/iter"] == {"lbfgs"}
    assert set(d["phase_s"]) == {"setup", "ridge", "lbfgs", "polish"}
    assert d["n_iter_lbfgs"].shape == (4,)
    names = Counter(s["name"] for s in d["spans"])
    c = d["counters"]
    assert names["polish/hessian"] == names["polish/solve"] == (
        names["polish/step"]) == c["polish/iters"] > 0
    assert names["polish/check"] == c["polish/iters"] + 1
    assert names["lbfgs/iter"] >= np.max(d["n_iter_lbfgs"])
    assert c["lbfgs/ls_steps"] >= names["lbfgs/iter"]
    assert c["polish/rows"] >= c["polish/iters"]


def _quartic(a):
    """A row-wise convex loss sum(a (x - 1)^4 + x^2 / 2), its value and
    gradient and its Hessian, on the rows ``rows``."""
    def vg(x, rows):
        ar = a[rows][:, None]
        return (ar * (x - 1) ** 4 + 0.5 * x * x).sum(1), (
            4 * ar * (x - 1) ** 3 + x)

    def hess(x, rows):
        ar = a[rows][:, None]
        return torch.diag_embed(12 * ar * (x - 1) ** 2 + 1)

    return vg, hess


def test_polish_rows_against_its_stopping_rule():
    torch.manual_seed(0)
    a = torch.logspace(-3, 3, 7, dtype=torch.float64)
    x0 = 3 * torch.randn(7, 5, dtype=torch.float64)
    vg, hess = _quartic(a)
    seen = []

    def hess_seen(x, rows):
        seen.append(rows.numel())
        return hess(x, rows)

    with profiling.recording() as rec:
        res = newton_polish(vg, hess_seen, x0, max_iter=40)
    n_iter = res.n_iter.numpy()
    assert len(set(n_iter)) > 1           # rows stop at different points
    # a row is active in exactly the iterations that count it
    assert rec.counters["polish/rows"] == int(n_iter.sum()) == sum(seen)
    assert rec.counters["polish/iters"] == int(n_iter.max()) == len(seen)


def test_mesh_shards_record_under_the_phase():
    freq, Z = _batch()
    res = fit_spectra_batch(freq, Z, mode="optimize", init_from_ridge=True,
                            max_iter=30, polish=False, timing=True,
                            device="cpu", mesh=make_mesh(2, device="cpu"))
    d = res.diagnostics
    by_id = _by_id(d["spans"])
    iters = [s for s in d["spans"] if s["name"] == "lbfgs/iter"]
    assert {s["shard"] for s in iters} == {0, 1}
    assert {by_id[s["parent"]]["name"] for s in iters} == {"lbfgs"}
    assert all(s["shard"] is None for s in d["spans"]
               if s["name"] != "lbfgs/iter")


def test_counter_from_many_threads():
    """The shared counters lose no update across worker threads."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            forked = profiling.fork()

            def work(i):
                with profiling.adopt(forked, i):
                    for _ in range(2000):
                        profiling.count("n")
                        with profiling.span("w"):
                            pass

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters["n"] == 16 * 2000
    w = [s for s in rec.spans if s["name"] == "w"]
    assert len(w) == 16 * 2000
    assert Counter(s["shard"] for s in w) == {i: 2000 for i in range(16)}


def test_run_shards_carries_the_open_span():
    def inner(shard):
        with profiling.span("inner"):
            pass

    mesh = make_mesh(3, device="cpu")
    with profiling.recording() as rec:
        with profiling.span("outer"):
            run_shards(inner, mesh.shards(24))
    by_id = _by_id(rec.spans)
    inner = [s for s in rec.spans if s["name"] == "inner"]
    assert sorted(s["shard"] for s in inner) == [0, 1, 2]
    assert {by_id[s["parent"]]["name"] for s in inner} == {"outer"}


def _profiled_ops(prof, name):
    return sorted((int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == name)


TOL_NS = 200_000        # 0.2 ms


def _inside(op, s):
    return (s["start_ns"] - TOL_NS <= op[0]
            and op[1] <= s["end_ns"] + TOL_NS)


def test_shared_clock_probe_span():
    x = torch.randn(2000, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            with profiling.span("probe"):
                torch.sort(x, dim=0)
    probe = next(s for s in rec.spans if s["name"] == "probe")
    ops = _profiled_ops(prof, "aten::sort")
    assert ops and all(_inside(op, probe) for op in ops), (ops, probe)


def test_shared_clock_in_a_fit():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _sampled(escalate=False, timing=True)
    spans = res.diagnostics["spans"]
    summary = next(s for s in spans if s["name"] == "summary")
    first = next(op for op in _profiled_ops(prof, "aten::sort")
                 if op[0] >= summary["start_ns"])
    pct = [s for s in spans if s["name"] == "summary/percentiles"]
    assert any(_inside(first, s) for s in pct), (first, pct)
