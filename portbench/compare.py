"""The numbers that decide ``correct``: each fit's outputs against the
plain reference (``reference/<config>.py``) and the analytic truth.

A number is a function ``f(fit, ref) -> float`` of a ``Fit`` (the fit's
inputs, its result and what the probe kept of it) and a ``Ref`` (the
reference models and truths). The cell's file ``limits/<workload>.json``
names the numbers it compares and their limits; a number that is not
defined here is looked up as ``checks/<name>.py`` (its ``number``
function), so a later cell adds a number as a file.

``control=True`` puts the reference at TF32 (``ref.low``) in the place of
what the program computed: the control that has to come out as not
correct."""

from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.readers import escalated_share

HERE = Path(__file__).resolve().parent


class Fit(NamedTuple):
    Z: np.ndarray             # (B, N) complex, descending frequency
    result: object            # the entry's BatchFitResult
    probe: dict               # Probe.take() of this fit
    chains: int
    memo: dict                # the reference's evaluations, shared by
                              # the numbers that read them


class Ref(NamedTuple):
    exact: object             # plainmodel.Model, float64
    low: Optional[object]     # the same at TF32 (the control), or None
    truths: list              # analytic distributions on each basis grid
    rp: float                 # integral of the first truth over ln tau
    z_true: np.ndarray        # (N,) the noiseless spectrum, descending


def _sampled(fit):
    if len(fit.probe["sampled"]) != 1:
        raise LookupError(f"the probe saw {len(fit.probe['sampled'])} SHMC "
                          "runs in the fit, expected 1")
    return fit.probe["sampled"][0]


def _last_draw(fit):
    """(states, the program's logp and grad at them, each row's spectrum)
    of the last draw: the result's ``state_q`` rows (spectrum-major,
    chains within) of the spectra that the escalation refit did not
    redo, with ``diagnostics['state_logp']`` and ``['state_grad']`` where
    the entry returns them, else what the probe kept of the trajectory."""
    d = fit.result.diagnostics
    sq = np.asarray(d["state_q"])
    b, c, dim = sq.shape
    if "state_logp" in d and "state_grad" in d:
        keep = np.ones(b, bool)
        lp = torch.as_tensor(np.asarray(d["state_logp"]).reshape(b * c))
        g = torch.as_tensor(np.asarray(d["state_grad"]).reshape(b * c, dim))
    else:
        keep = ~np.asarray(d.get("escalated", np.zeros(b, bool)), bool)
        _, lp, g = _sampled(fit)
        lp, g = lp[:b * c].cpu(), g[:b * c].cpu()
    rows = torch.as_tensor(np.repeat(keep, c))
    q = torch.as_tensor(sq.reshape(b * c, dim))
    spec = torch.arange(b * c) // c
    return q[rows], lp[rows], g[rows], spec[rows]


def _density(fit, ref, control):
    """(program's (logp, grad), reference's (logp, grad)) at the last
    draw's states, float64 on the reference's device."""
    q, lp, g, spec = _last_draw(fit)
    dev = ref.exact.device
    q64 = q.to(dev, torch.float64)
    tg, _ = ref.exact.targets(fit.Z)
    want = ref.exact.value_and_grad(q64, tg[spec.to(tg.device)])
    if control:
        tl, _ = ref.low.targets(fit.Z)
        lp, g = ref.low.value_and_grad(q64.float(), tl[spec.to(tl.device)])
    return (lp.to(dev, torch.float64), g.to(dev, torch.float64)), want


def _cached(fit, key, fn):
    if key not in fit.memo:
        fit.memo[key] = fn()
    return fit.memo[key]


def logp_gap(fit, ref, control=False):
    """Largest |logp - reference logp| (nats) over the last draw's rows."""
    (lp, _), (lp_r, _) = _cached(fit, ("d", control),
                                 lambda: _density(fit, ref, control))
    return float((lp - lp_r).abs().max())


def grad_gap(fit, ref, control=False):
    """Largest ||grad - reference grad|| over the last draw's rows, each
    against the larger of its row's reference norm and the median row's."""
    (_, g), (_, g_r) = _cached(fit, ("d", control),
                               lambda: _density(fit, ref, control))
    nr = g_r.norm(dim=1)
    scale = torch.clamp(nr, min=float(nr.median()))
    return float(((g - g_r).norm(dim=1) / scale).max())


def state_match(fit, ref, control=False):
    """Largest |difference| between the probe's last states and the
    result's ``state_q`` on the spectra that were not refitted: 0 when the
    probe saw the fit's own sampler (and where the entry returns the
    last draw's density itself, which needs no probe)."""
    d = fit.result.diagnostics
    if "state_logp" in d and "state_grad" in d:
        return 0.0
    q = _sampled(fit)[0].detach().cpu().numpy()
    sq = np.asarray(d["state_q"])
    b = sq.shape[0]
    keep = ~np.asarray(d.get("escalated", np.zeros(b, bool)), bool)
    got = q[:b * fit.chains].reshape(sq.shape)
    return float(np.abs(got[keep] - sq[keep]).max()) if keep.any() else 0.0


def zhat_gap(fit, ref, control=False):
    """A series-only model: largest |posterior-mean prediction - (A @ coef
    + R_inf + j w L)| over frequencies, of the row's largest |A @ coef +
    R_inf + j w L| (a spectrum whose mean inductance is large predicts
    |Z| far above its data at the top frequencies)."""
    res = fit.result
    z_r = ref.exact.z_series(res.coef, res.r_inf, res.inductance)
    if control:
        got = ref.low.z_series(res.coef, res.r_inf, res.inductance).double()
    else:
        got = torch.as_tensor(res.diagnostics["z_hat_mean"],
                              dtype=torch.float64, device=z_r.device)
    n = z_r.shape[1] // 2
    zmax = torch.hypot(z_r[:, :n], z_r[:, n:]).max(dim=1).values
    return float(((got - z_r).abs().max(dim=1).values / zmax).max())


def gamma_gap(fit, ref, control=False):
    """Largest |posterior-mean gamma at the basis grid - basis @ coef|, of
    Rp."""
    res = fit.result
    tau = ref.exact.tau[0]
    g_r = ref.exact.gamma(0, res.coef, tau)
    if control:
        got = ref.low.gamma(0, res.coef, tau).double()
    else:
        got = torch.as_tensor(res.diagnostics["gamma_eval_mean"],
                              dtype=torch.float64, device=g_r.device)
    return float((got - g_r).abs().max()) / ref.rp


def _gamma(fit, ref, i=0):
    res = fit.result
    coef = res.coef if i == 0 else res.diagnostics[f"coef_{i}"]
    return ref.exact.gamma(i, coef, ref.exact.tau[i]).cpu().numpy()


def rmse(fit, ref, control=False):
    """RMSE of the batch-mean gamma against the truth, of Rp."""
    g = _gamma(fit, ref)
    return float(np.sqrt(np.mean((g.mean(axis=0) - ref.truths[0]) ** 2))
                 / ref.rp)


def p90(fit, ref, control=False):
    """90th percentile of the spectra's gamma RMSE, of Rp."""
    g = _gamma(fit, ref)
    per = np.sqrt(np.mean((g - ref.truths[0][None, :]) ** 2, axis=1))
    return float(np.percentile(per, 90) / ref.rp)


def drt_rmse(fit, ref, control=False):
    """Mean of the spectra's DRT RMSE against the truth (absolute)."""
    g = _gamma(fit, ref)
    return float(np.mean(np.sqrt(np.mean((g - ref.truths[0][None, :]) ** 2,
                                         axis=1))))


def coverage(fit, ref, control=False):
    """Share of (spectrum, basis point) where the truth lies inside the
    pointwise 95% band."""
    d = fit.result.diagnostics
    t = ref.truths[0][None, :]
    return float(np.mean((t >= d["gamma_eval_lo"])
                         & (t <= d["gamma_eval_hi"])))


def min_ess_med(fit, ref, control=False):
    return float(np.median(fit.result.diagnostics["min_ess"]))


def logp_rhat_med(fit, ref, control=False):
    return float(np.median(fit.result.diagnostics["logp_rhat"]))


def escalated(fit, ref, control=False):
    """% of the spectra that the escalation gate sent to the NUTS refit: a
    sampler whose answers the gate refuses shows here, though the refit
    mends them."""
    share = escalated_share([fit.result.diagnostics.get("escalated", [])])
    return 0.0 if share is None else share


def divergence(fit, ref, control=False):
    """Median of the spectra's divergence rate."""
    return float(np.median(fit.result.diagnostics["divergence_rate"]))


def z_resid(fit, ref, control=False):
    """Median |posterior-mean prediction - noiseless Z| / |noiseless Z|."""
    zm = np.asarray(fit.result.diagnostics["z_hat_mean"])
    n = zm.shape[1] // 2
    zt = ref.z_true
    return float(np.median(np.abs(zm[:, :n] + 1j * zm[:, n:] - zt[None, :])
                           / np.abs(zt)[None, :]))


def nonfinite(fit, ref, control=False):
    """Count of non-finite values among the result's arrays."""
    res = fit.result
    arrays = [res.coef, res.r_inf, res.inductance]
    arrays += [a for a in (res.gamma_lo, res.gamma_hi) if a is not None]
    arrays += [v for k, v in res.diagnostics.items()
               if k.startswith(("coef_", "z_hat", "gamma_eval"))]
    return float(sum(int((~np.isfinite(np.asarray(a, float))).sum())
                     for a in arrays))


def _optimum(fit):
    """(unconstrained rows, objective) of the MAP optimum: the entry's
    ``diagnostics['map_params']`` and ``['map_value']`` where it returns
    them, else what the probe kept."""
    d = fit.result.diagnostics
    if "map_params" in d and "map_value" in d:
        return (torch.as_tensor(np.asarray(d["map_params"])),
                torch.as_tensor(np.asarray(d["map_value"])))
    if len(fit.probe["optima"]) != 1:
        raise LookupError(f"the probe saw {len(fit.probe['optima'])} MAP "
                          "results in the fit, expected 1")
    return fit.probe["optima"][0]


def _objective(fit, ref, control):
    """(objective at the optimum rows as the program (or the control)
    computed it, the reference's, the stationarity gradient, the rows in
    float64). The program's stationarity gradient is the reference
    gradient at its optimum. The control's is the reference gradient
    less the TF32 one: an optimizer driving the TF32 gradient to zero
    stops where the exact gradient is that difference."""
    params, value = _optimum(fit)
    b = fit.Z.shape[0]
    dev = ref.exact.device
    x = params[:b].to(dev, torch.float64)
    tg, _ = ref.exact.targets(fit.Z)
    lp_r, g_r = ref.exact.value_and_grad(x, tg, jacobian=False)
    got = value[:b].to(dev, torch.float64)
    if control:
        tl, _ = ref.low.targets(fit.Z)
        lp_c, g_c = ref.low.value_and_grad(x.float(), tl, jacobian=False)
        got, g_r = -lp_c.double(), g_r - g_c.double()
    return got, -lp_r, -g_r, x


def value_gap(fit, ref, control=False):
    """Largest |objective at the optimum - the reference's| (nats)."""
    got, want, _, _ = _cached(fit, ("o", control),
                              lambda: _objective(fit, ref, control))
    return float((got - want).abs().max())


def grad_med(fit, ref, control=False):
    """Median over spectra of the reference objective's gradient infinity
    norm at the returned optimum: its stationarity."""
    _, _, g, _ = _cached(fit, ("o", control),
                         lambda: _objective(fit, ref, control))
    return float(g.abs().max(dim=1).values.median())


def coef_gap(fit, ref, control=False):
    """Largest |returned coefficients - those of the returned optimum|, of
    the spectrum's largest coefficient."""
    _, _, _, x = _cached(fit, ("o", control),
                         lambda: _objective(fit, ref, control))
    _, zs = ref.exact.targets(fit.Z)
    c = ref.exact.constrain(ref.exact.unravel(x))["x_0"].cpu().numpy()
    want = c * zs[:, None]
    got = np.asarray(fit.result.coef, float)
    if control:
        cl = ref.low.constrain(ref.low.unravel(x.float()))["x_0"]
        got = cl.double().cpu().numpy() * zs[:, None]
    scale = np.abs(want).max(axis=1)
    return float((np.abs(got - want).max(axis=1) / scale).max())


def number(name):
    """The function of the compared number ``name``."""
    fn = globals().get(name)
    if callable(fn) and not name.startswith("_") and name not in (
            "number", "judge"):
        return fn
    path = HERE / "checks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_check_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.number


def judge(fits, ref, limits, control=False):
    """Every number of ``limits`` ({name: {"limit", "keep": "below" |
    "above"}}) over ``fits``: ({name: (worst reading, limit, passed)},
    the count of fits with a number outside its limit). A number that
    cannot be computed reads NaN and fails."""
    out, bad = {}, set()
    for name, lim in limits.items():
        fn = number(name)
        below = lim["keep"] == "below"
        limit = float(lim["limit"])
        vals = []
        for i, fit in enumerate(fits):
            try:
                v = float(fn(fit, ref, control=control))
            except (LookupError, KeyError, RuntimeError, ValueError) as e:
                print(f"portbench: number {name} failed: {e!r}",
                      file=sys.stderr)
                v = math.nan
            if not (v <= limit if below else v >= limit):
                bad.add(i)
            vals.append(v)
        if not vals or any(math.isnan(v) for v in vals):
            worst = math.nan
        else:
            worst = max(vals) if below else min(vals)
        ok = worst <= limit if below else worst >= limit
        out[name] = (worst, limit, bool(ok))
    return out, len(bad)
