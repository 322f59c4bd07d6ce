"""Batch-fitting command line: a directory of spectra in, results out (port
of bayes_drt_tpu/cli.py).

The reference's paper workflow (loop over instrument files, fit each, save
``Gout_*.csv`` distributions) as one command: the files are bucketed by
frequency grid through the native loader and each bucket is fit in one
batched call on the card.

    python -m bayes_drt_tpu_torch fit data/*.DTA --out results/
    python -m bayes_drt_tpu_torch fit data_dir --pattern '*.csv' --mode optimize
    python -m bayes_drt_tpu_torch fit data_dir --pattern '*.csv' --device cpu

Outputs, per input file ``<stem>``:
  <out>/Gout_<stem>.csv   tau, gamma [, gamma_lo, gamma_hi]  (the
                          reference's bayes_results/map_results format)
and one ``<out>/summary.csv`` with per-spectrum offsets (R_inf,
inductance), Rp, reconstruction quality (median relative Z residual), and
sampling diagnostics (min-ESS, logp split-Rhat, divergence rate).
Unparseable files are skipped (the status column records the error).
``--peaks`` additionally fits HN peaks to each recovered distribution
(``Peaks_<stem>.csv``, the reference's peak-fit workflow). The files are
written with the standard library's csv module, floats as their repr, so
no pandas is needed. ``--device`` (default cuda) places every fit.
"""

from __future__ import annotations

import argparse
import csv
import glob
import math
import os
import sys
import time

import numpy as np

_ITEM_12 = "is not ported yet (ROADMAP Queue 1 item 12)"


def _expand_paths(paths, pattern):
    files = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, pattern))))
        else:
            files.extend(sorted(glob.glob(p)) or [p])
    seen, out = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def _eval_tau(tau_basis, n_points):
    lo, hi = np.log10(tau_basis.min()), np.log10(tau_basis.max())
    return np.logspace(lo, hi, n_points)


def _fit_parser(sub):
    p = sub.add_parser(
        "fit", help="batch-fit spectra from instrument/CSV files",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="+",
                   help="spectrum files, globs, or directories")
    p.add_argument("--pattern", default="*.DTA",
                   help="glob used inside directory arguments")
    p.add_argument("--out", default="drt_results", help="output directory")
    p.add_argument("--mode", choices=("sample", "optimize", "ridge"),
                   default="sample",
                   help="sample = full HMC posterior (credible bands); "
                        "optimize = MAP; ridge = hyper-lambda ridge")
    p.add_argument("--sampler", choices=("shmc", "nuts", "chees"),
                   default="shmc")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=250)
    p.add_argument("--samples", type=int, default=250)
    p.add_argument("--max-iter", type=int, default=1500,
                   help="L-BFGS iteration cap (optimize mode)")
    p.add_argument("--nonneg", action="store_true",
                   help="constrain the distribution non-negative")
    p.add_argument("--outliers", action="store_true",
                   help="sample/optimize: include the per-point outlier "
                        "error contribution; ridge: use the outlier-robust "
                        "hyper-weights iteration")
    p.add_argument("--centered", action="store_true",
                   help="sample the centered (strict Stan-coordinate) "
                        "parameterization instead of the non-centered "
                        "production default")
    p.add_argument("--quality", choices=("fast", "strict"), default=None,
                   help="named sampler preset (sample mode): 'fast' = the "
                        "production SHMC config, 'strict' = the "
                        "calibrated-interval config (NUTS md8, "
                        "4x(1000+1000))")
    p.add_argument("--no-escalate", action="store_true",
                   help="disable the mixing-gate escalation refit of "
                        "under-mixed spectra (sample mode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-points", type=int, default=200,
                   help="points in the output tau grid")
    p.add_argument("--mesh", action="store_true",
                   help="shard each batch over all visible devices (not "
                        "ported yet)")
    p.add_argument("--peaks", action="store_true",
                   help="also fit HN peaks to each recovered distribution "
                        "(writes Peaks_<stem>.csv and a n_peaks column)")
    p.add_argument("--ridge-cv", action="store_true",
                   help="ridge mode: select each spectrum's lambda_0 by "
                        "Re-Im cross-validation over --cv-grid (the whole "
                        "grid x batch sweep in one batched call)")
    p.add_argument("--cv-grid", default="1e-7,1e2,19",
                   help="lambda grid for --ridge-cv as lo,hi,n (logspace)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the fits (default cuda; 'cpu' "
                        "runs without a card)")
    p.set_defaults(func=cmd_fit)
    return p


def _cell(v):
    """A CSV cell as pandas' to_csv writes it: floats by their repr, NaN
    and missing values empty."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return "" if math.isnan(v) else repr(v)
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_csv(path, columns, rows):
    """Rows (dicts) under ``columns`` to a CSV, missing keys empty."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([_cell(r.get(c)) for c in columns])


def _write_columns(path, cols):
    """A dict of equal-length float columns to a CSV, in the dict's order,
    each cell as ``_cell`` writes it."""
    cells = [["" if math.isnan(v) else repr(v)
              for v in np.asarray(c, float).tolist()] for c in cols.values()]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(cols))
        w.writerows(zip(*cells))


def fit_bucket(args, freq, Zb, tau_eval, cv_lams=None):
    """One bucket's batched fit as ``cmd_fit`` runs it (``args`` its parsed
    flags). Returns the BatchFitResult."""
    from .parallel import fit_spectra_batch, ridge_fit_spectra_batch
    dev = args.device
    if args.mode == "ridge":
        if args.outliers:
            # Effat-Ciucci outlier-robust ridge (hyper-weights)
            return ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False,
                                           hyper_weights=True, device=dev)
        return ridge_fit_spectra_batch(freq, Zb, cv_lambdas=cv_lams,
                                       device=dev)
    if args.mode == "optimize":
        return fit_spectra_batch(
            freq, Zb, mode="optimize", max_iter=args.max_iter,
            init_from_ridge=True, outliers=args.outliers,
            nonneg=args.nonneg, random_seed=args.seed, device=dev)
    from .infer.chees import SHMCConfig
    kw = dict(sampler=args.sampler, chains=args.chains,
              warmup=args.warmup, samples=args.samples,
              ncp=not args.centered,
              shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32,
                                  leaf_unroll=2, draw_unroll=2,
                                  recompute_grad=True, eps_quantile=0.5))
    if args.quality:
        kw = dict(quality=args.quality)
    return fit_spectra_batch(
        freq, Zb, mode="sample", outliers=args.outliers,
        nonneg=args.nonneg, random_seed=args.seed,
        escalate=False if args.no_escalate else None,
        gamma_eval_tau=tau_eval, device=dev, **kw)


def _np(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def cmd_fit(args):
    from .native import load_spectra
    from .parallel import evaluate_gamma

    if args.mesh:
        raise NotImplementedError("--mesh " + _ITEM_12)
    cv_lams = None
    if args.ridge_cv:
        try:
            lo, hi, n_cv = args.cv_grid.split(",")
            lo, hi, n_cv = float(lo), float(hi), int(n_cv)
            if not (0 < lo < hi and n_cv >= 2):
                raise ValueError
        except ValueError:
            print("invalid --cv-grid: expected lo,hi,n with 0 < lo < hi "
                  "and n >= 2 (e.g. 1e-7,1e2,19)", file=sys.stderr)
            return 2
        cv_lams = np.logspace(np.log10(lo), np.log10(hi), n_cv)
        if args.outliers and args.mode == "ridge":
            print("--ridge-cv and --outliers cannot be combined in ridge "
                  "mode", file=sys.stderr)
            return 2

    files = _expand_paths(args.paths, args.pattern)
    if not files:
        print("no input files matched", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    failed = []
    buckets = load_spectra(files, skip_errors=True, failed=failed)
    for path, err in failed:
        print(f"SKIP {path}: {err}", file=sys.stderr)
    n_loaded = sum(len(b["paths"]) for b in buckets)
    print(f"{n_loaded}/{len(files)} spectra in {len(buckets)} frequency-grid "
          f"bucket(s)", file=sys.stderr)
    if not buckets:
        print("no spectra loaded", file=sys.stderr)
        return 2

    rows = [{"file": os.path.basename(p), "status": f"load_error: {err}"}
            for p, err in failed]
    for bi, bucket in enumerate(buckets):
        freq, Zb, paths = bucket["freq"], bucket["Z"], bucket["paths"]
        tau_eval = _eval_tau(_basis_tau(freq), args.eval_points)
        t0 = time.time()
        res = fit_bucket(args, freq, Zb, tau_eval, cv_lams)
        elapsed = time.time() - t0

        gammas = evaluate_gamma(res, tau_eval)
        if args.mode == "sample":
            lo = res.diagnostics["gamma_eval_lo"]
            hi = res.diagnostics["gamma_eval_hi"]
        ln_tau = np.log(tau_eval)
        resid = _median_rel_residuals(freq, Zb, res, args.device)

        for i, path in enumerate(paths):
            stem = os.path.splitext(os.path.basename(path))[0]
            cols = {"tau": tau_eval, "gamma": gammas[i]}
            if args.mode == "sample":
                cols["gamma_lo"] = lo[i]
                cols["gamma_hi"] = hi[i]
            _write_columns(os.path.join(args.out, f"Gout_{stem}.csv"), cols)
            rp = float(np.trapezoid(gammas[i], ln_tau))
            row = {
                "file": os.path.basename(path),
                "status": "ok",
                "mode": args.mode,
                "R_inf": float(res.r_inf[i]),
                "inductance": float(res.inductance[i]),
                "Rp": rp,
                "median_rel_resid": float(resid[i]),
                "fit_seconds_bucket": round(elapsed, 3),
                "bucket": bi,
            }
            if args.mode == "ridge" and args.ridge_cv:
                row["cv_lambda"] = float(res.diagnostics["cv_lambda"][i])
            if args.mode == "sample":
                d = res.diagnostics
                row["min_ess"] = float(d["min_ess"][i])
                row["logp_split_rhat"] = float(d["logp_rhat"][i])
                row["rank_rhat_max"] = float(d["rank_rhat_max"][i])
                row["ess_bulk_min"] = float(d["ess_bulk_min"][i])
                row["divergence_rate"] = float(d["divergence_rate"][i])
            if args.peaks:
                from .peaks import evaluate_fit_distribution, fit_peaks
                px = _np(fit_peaks(tau_eval, gammas[i], rp,
                                   device=args.device))
                _write_columns(
                    os.path.join(args.out, f"Peaks_{stem}.csv"),
                    {"R": px[0::4], "tau0": np.exp(px[1::4]),
                     "alpha": px[2::4], "beta": px[3::4]})
                row["n_peaks"] = len(px) // 4
                g_fit = _np(evaluate_fit_distribution(
                    px, tau_eval, device=args.device))
                gmax = max(float(np.abs(gammas[i]).max()), 1e-30)
                row["peak_fit_rmse_rel"] = float(
                    np.sqrt(np.mean((g_fit - gammas[i]) ** 2)) / gmax)
            rows.append(row)
        print(f"bucket {bi}: {len(paths)} spectra x {len(freq)} freqs "
              f"fit in {elapsed:.2f}s ({args.mode})", file=sys.stderr)

    columns = list(dict.fromkeys(k for r in rows for k in r))
    write_csv(os.path.join(args.out, "summary.csv"), columns, rows)
    print(f"wrote {len(rows)} Gout_*.csv + summary.csv to {args.out}",
          file=sys.stderr)
    return 0


def _basis_tau(frequencies):
    from .ops.matrices import get_tau_basis
    return get_tau_basis(np.sort(np.asarray(frequencies, float))[::-1])


def _median_rel_residuals(frequencies, Z_batch, res, device=None):
    """Per-spectrum median |Z_hat - Z| / |Z| of the fitted batch, the
    reconstruction-quality column of summary.csv, from the point-estimate
    coefficients (the posterior mean in sample mode) and A matrices built
    on ``device`` (the quadrature kernel on a card)."""
    from .ops.matrices import construct_A
    order = np.argsort(np.asarray(frequencies, float))[::-1]
    freq = np.asarray(frequencies, float)[order]
    z = np.asarray(Z_batch)[:, order]
    A_re, A_im = (_np(construct_A(freq, part, tau=res.tau, basis=res.basis,
                                  epsilon=res.epsilon, device=device))
                  for part in ("real", "imag"))
    z_hat = (res.r_inf[:, None] + res.coef @ A_re.T
             + 1j * (2 * np.pi * freq[None, :] * res.inductance[:, None]
                     + res.coef @ A_im.T))
    return np.median(np.abs(z_hat - z) / np.maximum(np.abs(z), 1e-300),
                     axis=1)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m bayes_drt_tpu_torch",
        description="Bayesian DRT/DDT inversion on an NVIDIA GPU (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)
    _fit_parser(sub)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
