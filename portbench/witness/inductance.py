"""A second witness for zarc-shmc's spectra whose posterior-mean
prediction lies far above their data at the top frequencies (a large
mean inductance): are they the model's and the sampler's, or a fault of
the float32 program?

    python3 portbench/witness/inductance.py --seed <n> [--fits 4] \
        [--out <file.json>]

on a machine with the card. It fits the cell's first ``--fits`` batches
as a run of zarc-shmc with ``--seed`` does (the same pool and sampler
seeds), finds the spectra whose largest |R_inf + j w L + A coef| exceeds
ten times their data's largest |Z|, and for each reads, by the float64
plain reference, every chain's inductance and log density at the last
draw. Then it fits those spectra again by themselves: float32 SHMC as
the cell, SHMC in float64 (the program's other precision), and NUTS in
float32 (its other sampler), and reads the same ratio there. Not a part
of any benchmark run."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def ratios(ref, res, Z):
    """Each spectrum's largest |predicted Z| over its data's largest."""
    import numpy as np
    import torch
    z = ref.z_series(res.coef, res.r_inf, res.inductance)
    n = z.shape[1] // 2
    pred = torch.hypot(z[:, :n], z[:, n:]).max(dim=1).values.cpu().numpy()
    return pred / np.abs(Z).max(axis=1)


def chains(ref, res, Z, rows):
    """Per chain of each spectrum in ``rows``: the inductance (ohm s) and
    the float64 log density at the last draw's state."""
    import numpy as np
    import torch
    sq = np.asarray(res.diagnostics["state_q"])[rows]           # (w, C, D)
    w, c, d = sq.shape
    q = torch.as_tensor(sq.reshape(w * c, d), dtype=torch.float64,
                        device=ref.device)
    tg, zs = ref.targets(Z[rows])
    idx = torch.arange(w * c, device=tg.device) // c
    lp, _ = ref.value_and_grad(q, tg[idx])
    induc = ref.constrain(ref.unravel(q))["induc"].cpu().numpy()
    induc = induc.reshape(w, c) * zs[:, None]
    return induc.tolist(), lp.reshape(w, c).cpu().numpy().tolist()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fits", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    import numpy as np
    import torch

    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    from portbench import core, gen
    from portbench.plainmodel import Grid
    cell = core.load_cell("zarc-shmc")
    cfg = cell.config
    ref_mod = core.load_module(ROOT / "portbench/reference/zarc_series.py",
                               "portbench_reference_zarc_series")
    freq, pool, _ = core.make_pool(cell, args.seed, ref_mod)
    grid = Grid(freq, cfg["distributions"])
    kw = core.fit_kwargs(cell, grid.tau[0], False, "cuda")
    ref = ref_mod.model(cfg, "sample", "cuda")
    out = {"seed": args.seed, "fits": [], "refits": {}}
    wild = []
    for i in range(args.fits):
        b = i % len(pool)
        res = fit_spectra_batch(freq, pool[b],
                                random_seed=gen.stream(args.seed, gen.FIT, i),
                                **kw)
        r = ratios(ref, res, pool[b])
        rows = np.flatnonzero(r > 10).tolist()
        ind, lp = chains(ref, res, pool[b], rows) if rows else ([], [])
        d = res.diagnostics
        out["fits"].append({
            "fit": i, "batch": b, "rows": rows,
            "ratio": r[rows].tolist(), "ratio_median": float(np.median(r)),
            "chain_induc": ind, "chain_logp": lp,
            "logp_rhat": np.asarray(d["logp_rhat"])[rows].tolist(),
            "min_ess": np.asarray(d["min_ess"])[rows].tolist(),
            "escalated": np.asarray(d.get("escalated", []))[rows].tolist()})
        print(f"fit {i} batch {b}: {len(rows)} spectra over 10x, ratios "
              f"{np.round(r[rows], 1).tolist()}, median ratio "
              f"{np.median(r):.4f}", flush=True)
        wild += [(b, j) for j in rows]
    wild = sorted(set(wild))[:8]
    if wild:
        Zw = np.stack([pool[b][j] for b, j in wild])
        arms = {
            "shmc_float32": dict(kw),
            "shmc_float64": dict(kw, dtype=torch.float64),
            "nuts_float32": {k: v for k, v in kw.items()
                             if k not in ("shmc_cfg", "sampler")}}
        arms["nuts_float32"].update(sampler="nuts", max_tree_depth=8)
        for name, akw in arms.items():
            for s in range(2):
                res = fit_spectra_batch(
                    freq, Zw, random_seed=gen.stream(args.seed, 7, s), **akw)
                r = ratios(ref, res, Zw)
                out["refits"][f"{name}.{s}"] = {
                    "ratio": r.tolist(),
                    "logp_rhat": np.asarray(
                        res.diagnostics["logp_rhat"]).tolist()}
                print(f"refit {name} seed {s}: ratios "
                      f"{np.round(r, 2).tolist()}", flush=True)
        out["refit_spectra"] = wild
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))


if __name__ == "__main__":
    main()
