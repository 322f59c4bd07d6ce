"""One run of one cell: load the cell's files by name, make the inputs
from the seed, warm up on the cell's shapes, fit back to back for the
window, check every fit against the plain reference, read the metrics.

Everything a cell needs is found by name: ``BENCHMARK.json``'s entry of
the workload names its configuration (``configs/<config>.json``, its
reference ``reference/<config>.py``) and its traffic
(``traffic/<traffic>.json``); the checks' limits are in
``limits/<workload>.json``; each metric is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    workload: str
    config: dict
    traffic: dict
    limits: dict
    bench: dict           # BENCHMARK.json
    entry: dict           # its workloads entry


def load_cell(workload, bench_path=None, override=None):
    """The cell's files. ``override`` ({"config": {...}, "traffic":
    {...}}) replaces keys, for the CPU tests' small sizes."""
    bench = json.loads(Path(bench_path or ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    for key, part in (override or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[key].update(
            part)
    return Cell(workload, config, traffic, limits, bench, entry)


def make_pool(cell, seed, ref_mod=None):
    """(freq descending, [noisy batches (B, N)], noiseless Z) from the
    seed: the pool's batch i from stream (POOL, i). The noiseless
    spectrum is the configuration's reference module's ``circuit(config,
    freq)`` where it has one, else ``gen.circuit`` of the configuration's
    ``circuit`` parameters."""
    from portbench import gen
    cfg, tr = cell.config, cell.traffic
    freq = np.logspace(*cfg["freq"])
    make = getattr(ref_mod, "circuit", None)
    z_true = (make(cfg, freq) if make is not None
              else gen.circuit(cfg["circuit"], freq))
    pool = [gen.noisy_replicas(z_true, tr["batch"], cfg["noise_level"],
                               gen.stream(seed, gen.POOL, i))
            for i in range(tr["pool"])]
    return freq, pool, z_true


def fit_kwargs(cell, ref_tau, timing, device):
    """The entry's keyword arguments for the cell, as a user calls it."""
    import torch
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    cfg, tr = cell.config, cell.traffic
    kw = dict(mode=tr["mode"], dtype=getattr(torch, cfg["dtype"]),
              sigma_min=cfg["sigma_min"], nonneg=cfg["nonneg"],
              timing=timing, device=device)
    if len(cfg["distributions"]) > 1 or any(
            "basis_freq" in d for d in cfg["distributions"]):
        dists = {}
        for d in cfg["distributions"]:
            e = {k: v for k, v in d.items() if k not in ("name",
                                                          "basis_freq")}
            if "basis_freq" in d:
                e["basis_freq"] = np.logspace(*d["basis_freq"])
            dists[d["name"]] = e
        kw["distributions"] = dists
    if tr["mode"] == "sample":
        kw.update(chains=cfg["chains"], warmup=cfg["warmup"],
                  samples=cfg["samples"], ncp=cfg["ncp"],
                  sampler=tr["sampler"], gamma_eval_tau=ref_tau)
        if tr["sampler"] == "shmc":
            kw["shmc_cfg"] = SHMCConfig(**tr["shmc"])
        if tr.get("escalate") is not None:
            kw["escalate"] = tr["escalate"]
    else:
        kw.update(tr["map"])
    return kw


class FitRecord(NamedTuple):
    start: float
    end: float
    batch: int
    diagnostics: dict
    kind: str             # "plain", "spans" or "profiled" (fit_kind)


class Ctx(NamedTuple):
    """What a metric reader reads."""
    cell: Cell
    mode: str
    shapes: dict          # n, K (list), D, R (rows of the sampler)
    fits: list            # FitRecord of every timed fit
    setup_s: float
    trace: Optional[object]   # devtrace.TraceSummary of the traced fit

    def spans(self):
        """The fits that recorded the entry's program spans (timing=True)
        outside the profiler."""
        return [f for f in self.fits if f.kind == "spans"]

    def plain(self):
        """The fits called as the end-to-end run calls them (timing=False,
        no profiler)."""
        return [f for f in self.fits if f.kind == "plain"]


def fit_kind(trace, i):
    """The i-th fit of a window: every fit of an end-to-end run is plain;
    a traced run profiles its first fit (with the program spans on), then
    alternates a fit with the spans on and a plain one, so that the
    spans' synchronizes slow no fit that a rate is read from."""
    if not trace:
        return "plain"
    if i == 0:
        return "profiled"
    return "spans" if i % 2 else "plain"


def window_sample():
    """The host and card state beside the window: the host's cumulative
    CPU time split (/proc/stat, steal where a hypervisor took it), this
    process's CPU seconds and involuntary context switches."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        cpu = []
    return {"t": time.perf_counter(), "cpu": cpu,
            "proc_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw}


def window_line(a, b):
    """One line of what the host did over the window (``window_sample``s
    at its start and end)."""
    wall = b["t"] - a["t"]
    parts = [f"process cpu {b['proc_s'] - a['proc_s']:.2f} s in "
             f"{wall:.2f} s", f"{b['nivcsw'] - a['nivcsw']} involuntary "
             "switches"]
    if len(a["cpu"]) >= 8 and len(b["cpu"]) >= 8:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        tot = max(1, sum(d[:8]))
        parts.append(f"host busy {100 * (tot - d[3] - d[4]) / tot:.1f}%, "
                     f"steal {100 * d[7] / tot:.2f}% of all cores")
    return "window host: " + ", ".join(parts)


def card_state():
    """The card's clocks, temperature, power and throttle reasons, read by
    ``nvidia-smi`` (outside any timed span)."""
    import subprocess
    q = ("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
         "clocks_throttle_reasons.active")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run(workload, seed, seconds, trace, device="cuda", t_start=None,
        override=None, control=False, warm=True):
    """One run of ``workload``. Returns (result dict, the checks' verdicts
    {number: (worst reading, limit, passed)}, the control's verdicts or
    None). ``device``, ``override`` (load_cell's) and
    ``warm=False`` (no warm-up fit) are for the CPU tests."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    from portbench import compare, devtrace, gen
    from portbench.plainmodel import Grid
    from portbench.probe import Probe

    cell = load_cell(workload, override=override)
    cfg, tr = cell.config, cell.traffic
    ref_mod = load_module(HERE / "reference" / f"{cfg['name']}.py",
                          f"portbench_reference_{cfg['name']}")
    freq, pool, z_true = make_pool(cell, seed, ref_mod)
    # the reference's grid only: its matrices are built after the window
    grid = Grid(freq, cfg["distributions"])
    eval_tau = grid.tau[0]
    kws = {t: fit_kwargs(cell, eval_tau, t, device)
           for t in ({False, True} if trace else {False})}
    cuda = str(device).startswith("cuda")
    probe = Probe().install()
    try:
        if warm:
            # a fit of the cell's shapes each way the window calls it:
            # captures, first calls
            for t, kw in sorted(kws.items()):
                fit_spectra_batch(freq, pool[0],
                                  random_seed=gen.stream(seed, gen.WARMUP,
                                                         int(t)), **kw)
                _sync(device)
                probe.take()
        setup_s = time.perf_counter() - t_start
        log(f"setup {setup_s:.3f} s; window of {seconds} s")
        if cuda:
            log(f"card before the window: {card_state()}")
        records, fits, traced_events = [], [], None
        attempted = failed = 0
        host0 = window_sample()
        t0 = time.perf_counter()
        i = 0
        while True:
            b = i % len(pool)
            kind = fit_kind(trace, i)
            _sync(device)
            ts = time.perf_counter()
            if kind == "profiled":
                tslice = devtrace.Slices(tr["trace_on_s"],
                                         tr["trace_every_s"])
                tslice.start()
            try:
                res = fit_spectra_batch(
                    freq, pool[b], random_seed=gen.stream(seed, gen.FIT, i),
                    **kws[kind != "plain"])
            except (RuntimeError, ValueError) as e:
                log(f"fit {i} raised {e!r}")
                res = None
            if kind == "profiled":
                tslice.finish()
                traced_events = tslice.slices
            _sync(device)
            te = time.perf_counter()
            attempted += 1
            if res is None:
                failed += 1
            else:
                records.append(FitRecord(ts, te, len(pool[b]),
                                         res.diagnostics, kind))
                fits.append(compare.Fit(pool[b], res, probe.take(),
                                        cfg.get("chains", 1), {}))
            esc = (int(np.sum(res.diagnostics["escalated"]))
                   if res is not None and "escalated" in res.diagnostics
                   else 0)
            log(f"fit {i}: {te - ts:.4f} s, {kind}, batch {b}, {esc} "
                "escalated")
            i += 1
            # a traced window holds a fit of each kind
            if te - t0 >= seconds and (not trace or i >= 3):
                break
        host1 = window_sample()
    finally:
        probe.uninstall()
    log(window_line(host0, host1))
    if cuda:
        log(f"card after the window: {card_state()}")
    peak = int(torch.cuda.max_memory_allocated()) if str(
        device).startswith("cuda") else 0
    log(f"window {records[-1].end - records[0].start if records else 0:.3f} s,"
        f" {attempted} fits; peak {peak} bytes")

    # ---- the checks, after the window ----
    ref_dev = device
    ref = compare.Ref(exact=ref_mod.model(cfg, tr["mode"], ref_dev),
                      low=(ref_mod.model(cfg, tr["mode"], ref_dev, "tf32")
                           if control else None),
                      truths=None, rp=None, z_true=z_true)
    truths = ref_mod.truths(cfg, ref.exact.tau)
    rp = float(np.trapezoid(truths[0], np.log(ref.exact.tau[0])))
    ref = ref._replace(truths=truths, rp=rp)
    tc = time.perf_counter()
    verdict, n_bad = compare.judge(fits, ref, cell.limits)
    ctl = (compare.judge(fits, ref, cell.limits, control=True)[0]
           if control else None)
    log(f"checks {time.perf_counter() - tc:.3f} s")
    failed += n_bad
    ok = bool(records) and failed == 0 and all(v[2] for v in
                                               verdict.values())

    summary = None
    if traced_events is not None:
        tt = time.perf_counter()
        summary = devtrace.summarize(traced_events)
        log(f"trace: {len(traced_events)} slices, "
            f"{sum(map(len, traced_events))} events reduced in "
            f"{time.perf_counter() - tt:.2f} s")
    D = grid.D
    R = _padded(tr["batch"]) * cfg.get("chains", 1)
    ctx = Ctx(cell=cell, mode=tr["mode"],
              shapes={"n": grid.n, "K": [len(t) for t in grid.tau], "D": D,
                      "R": R},
              fits=records, setup_s=setup_s, trace=summary)
    metrics = read_metrics(ctx, cell, per_layer=bool(trace))
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info(device, peak, summary)}
    if summary is not None:
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.gaps]}
    out["checks"] = {k: {"value": v[0], "limit": v[1]}
                     for k, v in verdict.items()}
    return out, verdict, ctl


def check_lines(verdict, limits, who="check"):
    """One line a compared number: its worst reading beside its limit."""
    return [f"{who} {k}: {v[0]!r} (limit {v[1]!r}, kept "
            f"{limits[k]['keep']}) {'ok' if v[2] else 'FAILED'}"
            for k, v in verdict.items()]


def _padded(b):
    t = 8
    while t < b:
        t *= 2
    return t


def metric_names(cell, per_layer):
    """The metrics this cell reports: those of BENCHMARK.json's list that
    name it, or name none and move a metric that it reports."""
    bench = cell.bench
    e2e = [m for m in bench["end_to_end"]
           if cell.workload in m.get("workloads", [cell.workload])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}

    def applies(m):
        if "workloads" in m:
            return cell.workload in m["workloads"]
        return m["moves"] in names

    return [m for m in bench["per_layer"] if applies(m)]


def read_metrics(ctx, cell, per_layer):
    out = {}
    for m in metric_names(cell, per_layer):
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "portbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is None or (isinstance(v, float) and not math.isfinite(v)):
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(device, peak, summary):
    import torch
    if str(device).startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info
