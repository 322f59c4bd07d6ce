"""Check on a CUDA card that the port's spans share the device trace's
clock: a zarc-shmc fit (portbench's cell: B=1024, 4 x (150+250) SHMC
draws, one K1 launch a draw) called with ``timing=True`` under
``torch.profiler``, after a warm-up fit. Every K1 kernel
(``traj_kernel``) must begin after the host start of its own
``sample/draw/traj`` span (the i-th kernel with the i-th span). The
host runs ahead of the card by up to the launch queue's depth, so a
kernel may start after later spans opened.

    python3 scripts/span_clock_check.py [--seed N] [--out PATH]

Prints one JSON line: the counts, the largest, smallest and median lag
from a span's host start to its kernel's start, how many draws the host
ran ahead at most, and whether the check held; exits 1 where it did
not."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    from portbench import core, devtrace
    from portbench.plainmodel import Grid

    if not torch.cuda.is_available():
        raise SystemExit("span_clock_check: needs a CUDA card")
    cell = core.load_cell("zarc-shmc")
    ref = core.load_module(ROOT / "portbench" / "reference"
                           / "zarc_series.py", "ref_zarc_series")
    freq, pool, _ = core.make_pool(cell, args.seed, ref)
    tau = Grid(freq, cell.config["distributions"]).tau[0]
    kw = core.fit_kwargs(cell, tau, True, "cuda")
    kw["escalate"] = False
    fit_spectra_batch(freq, pool[0], random_seed=1, **kw)     # captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fit_spectra_batch(freq, pool[1 % len(pool)], random_seed=2,
                                **kw)
        torch.cuda.synchronize()
    evts = devtrace.events(prof)
    k1 = sorted(e.start_ns for e in evts
                if e.device and "traj_kernel" in e.name)
    trajs = sorted((s["start_ns"], s["end_ns"])
                   for s in res.diagnostics["spans"]
                   if s["name"] == "sample/draw/traj" and s["fit"] == 0)
    n = min(len(k1), len(trajs))
    lag = np.array([k1[i] - trajs[i][0] for i in range(n)], float)
    opened = np.array([t[0] for t in trajs])
    ahead = [int(np.searchsorted(opened, k1[i])) - 1 - i for i in range(n)]
    ok = (len(k1) == len(trajs) == cell.config["warmup"]
          + cell.config["samples"] and bool((lag >= 0).all()))
    out = {"ok": ok, "card": card(), "k1_kernels": len(k1),
           "traj_spans": len(trajs),
           "lag_ms_max": float(lag.max()) * 1e-6 if n else None,
           "lag_ms_min": float(lag.min()) * 1e-6 if n else None,
           "lag_ms_median": float(np.median(lag)) * 1e-6 if n else None,
           "host_ahead_draws_max": max(ahead) if n else None,
           "negative_lags": int((lag < 0).sum())}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
