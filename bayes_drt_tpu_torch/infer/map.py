"""Batched MAP estimation: L-BFGS with a zoom line search, a damped
Newton polish and random restarts (port of bayes_drt_tpu/infer/map.py).

The JAX package minimizes with optax's L-BFGS (``optax.lbfgs``: the
``scale_by_lbfgs`` preconditioner, ``scale(-1)`` and
``scale_by_zoom_linesearch``, optax 0.2.6) inside a vmapped
``lax.while_loop``. Here the batch is an explicit row axis: every row of
an (R, D) tensor runs its own optimization and freezes once its own stop
rule holds, as a vmapped while_loop selects per row, and so does every
row's line search. The loss is given batched,
``value_and_grad(x) -> (f (R,), g (R, D))``. The preconditioner and the
line search are transcribed branch for branch from optax
(``transform.py:scale_by_lbfgs``, ``linesearch.py:zoom_linesearch``), so
that in float64 a row's iterates are optax's.

The host checks once an iteration, and once a line-search step, whether
any row is still running; every other decision stays on the device, so
on a CUDA device each piece of an iteration is one CUDA graph replay.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .._numerics import graph_capture


class MapResult(NamedTuple):
    params: torch.Tensor      # (R, D)
    value: torch.Tensor       # (R,) final objective (negative log posterior)
    grad_norm: torch.Tensor   # (R,) gradient infinity norm
    n_iter: torch.Tensor      # (R,) int32
    converged: torch.Tensor   # (R,) bool


# scale_by_zoom_linesearch's defaults (optax 0.2.6)
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_INCREASE_FACTOR = 2.0
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5      # its stepsize_precision


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where the radical is negative (optax
    ``_cubicmin``, its powers written as the products jnp evaluates)."""
    C = fpa
    db = b - a
    dc = c - a
    t = db * dc
    denom = t * t * (db - dc)
    dc2, db2 = dc * dc, db * db
    y1 = fb - fa - C * db
    y2 = fc - fa - C * dc
    A = (dc2 * y1 - db2 * y2) / denom
    B = (db * db2 * y2 - dc * dc2 * y1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """Armijo violation, or the approximate-Wolfe one near the minimum,
    whichever is smaller; 0 where satisfied, inf for NaN."""
    dec = value_step - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta = value_step - value_init - _APPROX_DEC_RTOL * value_init.abs()
    dec = torch.minimum(torch.maximum(approx, delta), dec)
    dec = torch.clamp_min(dec, 0.0)
    return torch.where(torch.isnan(dec), math.inf, dec)


def _curvature_error(slope_step, slope_init):
    curv = torch.clamp_min(slope_step.abs() - _CURV_RTOL * slope_init.abs(),
                           0.0)
    return torch.where(torch.isnan(curv), math.inf, curv)


def _next_stepsize(zoom, search_step, low, value_low, slope_low, high,
                   value_high, cubic_ref, value_cubic_ref):
    """Each row's next trial step: ``search_step`` in the interval search,
    and in the zoom (rows ``zoom``) the cubic's minimizer, else the
    quadratic's, else the midpoint, each only well inside the interval."""
    delta = (high - low).abs()
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    mc = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                   value_cubic_ref)
    use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
    mq = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
    middle = torch.where(use_cubic, mc,
                         torch.where(use_quad, mq, (low + high) / 2.0))
    return torch.where(zoom, middle, search_step)


def _ls_start(value, grad, slope, rows):
    """The zoom line search's initial state (optax's ``init_fn``) for the
    rows in ``rows``; the other rows start done."""
    zero = torch.zeros_like(value)
    no = torch.zeros_like(rows)
    return dict(stepsize=zero, value=value, grad=grad, slope=slope,
                dec_err=torch.full_like(value, math.inf), found=no,
                done=~rows, failed=no, low=zero, value_low=value,
                slope_low=slope, high=zero, value_high=value,
                slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
                safe_step=zero, safe_value=value, safe_grad=grad)


def _ls_step(value_and_grad, params, u, value_init, slope_init, ls, first,
             last):
    """One step of optax's zoom line search (``initial_guess_strategy=
    'one'``, no maximal step) along ``u`` for every running row: the
    interval search (Nocedal and Wright, algorithm 3.5; trial step 1, then
    doubling), the zoom (algorithm 3.6) for rows with a bracket, and the
    safe step for a row that fails. Returns the new state and whether any
    row still runs."""
    run = ~(ls["done"] | ls["failed"])
    search = run & ~ls["found"]
    zoom = run & ls["found"]
    stepsize, value, slope = ls["stepsize"], ls["value"], ls["slope"]
    low, value_low, slope_low = ls["low"], ls["value_low"], ls["slope_low"]
    high, value_high, slope_high = (ls["high"], ls["value_high"],
                                    ls["slope_high"])
    if first:
        cand = torch.ones_like(value)
    else:
        cand = _next_stepsize(zoom, _INCREASE_FACTOR * stepsize, low,
                              value_low, slope_low, high, value_high,
                              ls["cubic_ref"], ls["value_cubic_ref"])
    f, g = value_and_grad(params + cand[:, None] * u)
    slope_new = _vdot(g, u)
    dec = _decrease_error(cand, f, slope_new, value_init, slope_init)
    curv = _curvature_error(slope_new, slope_init)
    good = torch.maximum(dec, curv) <= 0.0

    # the safe point: any sufficient decrease in the interval search, a
    # lower value than the safe one's in the zoom
    upd_safe = run & (dec <= 0.0) & (~ls["found"] | (f < ls["safe_value"]))
    safe_step = torch.where(upd_safe, cand, ls["safe_step"])
    safe_value = torch.where(upd_safe, f, ls["safe_value"])
    safe_grad = torch.where(upd_safe[:, None], g, ls["safe_grad"])

    # the interval search brackets [old point, new point], the new one as
    # the high end unless it is the low end
    set_high = dec > 0.0 if first else (dec > 0.0) | (f >= value)
    set_low = (slope_new >= 0.0) & ~set_high
    lo_s = (torch.where(set_low, cand, stepsize),
            torch.where(set_low, f, value),
            torch.where(set_low, slope_new, slope))
    hi_s = (torch.where(set_low, stepsize, cand),
            torch.where(set_low, value, f),
            torch.where(set_low, slope, slope_new))
    new = lo_s + hi_s + lo_s[:2]
    fail_now = torch.full_like(run, last)
    if not first:
        # the zoom keeps the middle as the low end if it decreased enough
        # and below the low end, else as the high end; the cubic reference
        # is the end point just replaced
        too_small = (high - low).abs() <= _INTERVAL_THRESHOLD
        hi_mid = (dec > 0.0) | (f >= value_low)
        hi_low = (slope_new * (high - low) >= 0.0) & ~hi_mid
        moved_high = hi_mid | hi_low
        z_new = (torch.where(hi_mid, low, cand),
                 torch.where(hi_mid, value_low, f),
                 torch.where(hi_mid, slope_low, slope_new),
                 torch.where(hi_low, low, torch.where(hi_mid, cand, high)),
                 torch.where(hi_low, value_low,
                             torch.where(hi_mid, f, value_high)),
                 torch.where(hi_low, slope_low,
                             torch.where(hi_mid, slope_new, slope_high)),
                 torch.where(moved_high, high, ls["low"]),
                 torch.where(moved_high, value_high, value_low))
        new = tuple(torch.where(zoom, z, n) for z, n in zip(z_new, new))
        fail_now = fail_now | (zoom & too_small & (safe_step > 0.0))
    out = {k: torch.where(run, n, ls[k]) for k, n in zip(
        ("low", "value_low", "slope_low", "high", "value_high", "slope_high",
         "cubic_ref", "value_cubic_ref"), new)}
    done = ls["done"] | (run & good)
    fail_now = run & fail_now & ~good
    failed = ls["failed"] | fail_now
    dec_err = torch.where(run, dec, ls["dec_err"])
    # a failed search falls back to the safe step, or to it anyway
    # (stepsize 0, nothing moved) when the last point left the domain
    use_safe = fail_now & ((safe_step > 0.0) | torch.isinf(dec_err))
    out.update(
        stepsize=torch.where(use_safe, safe_step,
                             torch.where(run, cand, stepsize)),
        value=torch.where(use_safe, safe_value, torch.where(run, f, value)),
        grad=torch.where(use_safe[:, None], safe_grad,
                         torch.where(run[:, None], g, ls["grad"])),
        slope=torch.where(run, slope_new, slope), dec_err=dec_err,
        found=ls["found"] | (search & (set_high | set_low | good)),
        done=done, failed=failed, safe_step=safe_step,
        safe_value=safe_value, safe_grad=safe_grad)
    return out, (~(done | failed)).any()


class _LBFGS:
    """One batched L-BFGS run (optax's ``scale_by_lbfgs``, ``scale(-1)``
    and ``scale_by_zoom_linesearch``) with its state as persistent tensors.
    An iteration is three pieces that update the state in place: ``pre``
    (the memory update, the two-loop recursion and the line search's first
    step), ``step`` (one more line-search step, repeated while a row runs)
    and ``post`` (the update, the stop rule, the host's flags). The same
    pieces run eagerly, or on a CUDA device captured once as CUDA graphs
    and replayed: the loss must then be capturable (no host
    synchronization). The tolerances are floored as run_lbfgs says.
    ``reset(x0)`` starts another run from ``x0`` by copying a fresh state
    into the persistent one, so the graphs serve every run of a shape."""

    def __init__(self, value_and_grad, x0, max_iter, tol, ftol_rel, m,
                 max_ls, graphs):
        eps = torch.finfo(x0.dtype).eps
        self.vg, self.m, self.max_ls = value_and_grad, int(m), max_ls
        self.max_iter = max_iter
        self.tol, self.ftol_rel = max(tol, 50.0 * eps), max(ftol_rel,
                                                             10.0 * eps)
        self.s = self._fresh(x0)
        m = self.m
        # the two-loop's slot order at each k % m, newest pair last
        self.orders = (torch.arange(m)[None, :] + torch.arange(m)[:, None]
                       ) % m
        self.orders = self.orders.to(x0.device)
        self.graphs = None
        self.pool_id = None
        if graphs:
            self._capture()

    def reset(self, x0):
        for k, v in self._fresh(x0).items():
            self.s[k].copy_(v)
        return self

    def _fresh(self, x0):
        m, max_iter = self.m, self.max_iter
        R, D = x0.shape
        z = x0.new_zeros(R)
        act = torch.full((R,), max_iter > 0, dtype=torch.bool,
                         device=x0.device)
        s = dict(
            x=x0.clone(), value=torch.full_like(z, math.inf),
            grad=torch.zeros_like(x0), prev_params=torch.zeros_like(x0),
            prev_grad=torch.zeros_like(x0), d_params=x0.new_zeros((m, R, D)),
            d_grads=x0.new_zeros((m, R, D)), rhos=x0.new_zeros((m, R)),
            gnorm=torch.full_like(z, math.inf),
            prev_value=torch.full_like(z, math.inf),
            n_iter=torch.zeros(R, dtype=torch.int32, device=x0.device),
            act=act, flags=torch.stack([act.any(), act.any()]),
            u=torch.zeros_like(x0), value_init=z.clone(),
            slope_init=z.clone(), ls_run=act.any(),
            slot=torch.zeros(1, dtype=torch.long, device=x0.device),
            order=torch.zeros(m, dtype=torch.long, device=x0.device))
        for k, v in _ls_start(z, torch.zeros_like(x0), z, act).items():
            s["ls_" + k] = v.clone()
        return s

    def _assign(self, s, new):
        for k, v in new.items():
            s[k].copy_(v)

    def _ls(self, s):
        return {k[3:]: v for k, v in s.items() if k.startswith("ls_")}

    def pre(self, s, first):
        g_in = s["grad"]
        # memory: (s, y, 1/<y, s>) of the step just taken; the first
        # iteration scales the identity by min(1, 1/|g|)
        if first:
            gamma = torch.clamp_max(1.0 / torch.sqrt(_vdot(g_in, g_in)),
                                    1.0)
        else:
            dp = s["x"] - s["prev_params"]
            du = g_in - s["prev_grad"]
            vd = _vdot(du, dp)
            s["d_params"].index_copy_(0, s["slot"], dp[None])
            s["d_grads"].index_copy_(0, s["slot"], du[None])
            s["rhos"].index_copy_(0, s["slot"], torch.where(
                vd == 0.0, 0.0, 1.0 / vd)[None])
            den = _vdot(du, du)
            gamma = torch.where(den > 0.0, vd / den, 1.0)
        # two-loop recursion, newest pair first; slots are picked on the
        # device so that one captured graph serves every iteration

        def pair(j):
            idx = s["order"][j:j + 1]
            return (s["d_params"].index_select(0, idx)[0],
                    s["d_grads"].index_select(0, idx)[0],
                    s["rhos"].index_select(0, idx)[0])

        vec = g_in
        alphas = [None] * self.m
        for j in reversed(range(self.m)):
            dw, du_j, rho = pair(j)
            alphas[j] = rho * _vdot(dw, vec)
            vec = vec + (-alphas[j])[:, None] * du_j
        vec = gamma[:, None] * vec
        for j in range(self.m):
            dw, du_j, rho = pair(j)
            beta = rho * _vdot(du_j, vec)
            vec = vec + (alphas[j] - beta)[:, None] * dw
        u = -vec
        slope = _vdot(u, g_in)
        ls, run = _ls_step(self.vg, s["x"], u, s["value"], slope,
                           _ls_start(s["value"], g_in, slope, s["act"]),
                           first=True, last=self.max_ls == 1)
        new = {"ls_" + k: v for k, v in ls.items()}
        new.update(u=u, value_init=s["value"], slope_init=slope, ls_run=run)
        self._assign(s, new)

    def step(self, s, last):
        ls, run = _ls_step(self.vg, s["x"], s["u"], s["value_init"],
                           s["slope_init"], self._ls(s), first=False,
                           last=last)
        new = {"ls_" + k: v for k, v in ls.items()}
        new["ls_run"] = run
        self._assign(s, new)

    def post(self, s):
        act = s["act"]
        a2 = act[:, None]
        value = torch.where(act, s["ls_value"], s["value"])
        n_iter = s["n_iter"] + act.to(torch.int32)
        gnorm = torch.where(act, s["grad"].abs().amax(dim=1), s["gnorm"])
        prev_value = torch.where(act, s["value_init"], s["prev_value"])
        stagnant = (n_iter > 2) & (prev_value - value
                                   < self.ftol_rel * (value.abs() + 1.0))
        act = act & (n_iter < self.max_iter) & (gnorm > self.tol) & ~stagnant
        self._assign(s, dict(
            prev_params=s["x"].clone(), prev_grad=s["grad"].clone(),
            x=torch.where(a2, s["x"] + s["ls_stepsize"][:, None] * s["u"],
                          s["x"]),
            value=value,
            grad=torch.where(a2, s["ls_grad"], s["grad"]), gnorm=gnorm,
            prev_value=prev_value, n_iter=n_iter, act=act,
            flags=torch.stack([act.any(),
                               (act & ~torch.isfinite(value)).any()])))

    def _capture(self):
        """Warm every op up on a side stream on a copy of the state, then
        capture ``pre`` (k > 0), ``step`` (not the last) and ``post``."""
        dev = self.s["x"].device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            scratch = {k: v.clone() for k, v in self.s.items()}
            self.pre(scratch, first=False)
            self.step(scratch, last=False)
            self.post(scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        del scratch
        pool = self.pool_id = torch.cuda.graph_pool_handle()
        self.graphs = {}
        for name, fn in (("pre", lambda: self.pre(self.s, first=False)),
                         ("step", lambda: self.step(self.s, last=False)),
                         ("post", lambda: self.post(self.s))):
            g = torch.cuda.CUDAGraph()
            with graph_capture(g, dev, pool=pool):
                fn()
            self.graphs[name] = g

    def run(self):
        s, g = self.s, self.graphs
        for k in range(self.max_iter):
            any_act, any_stale = s["flags"].tolist()
            if not any_act:
                break
            if any_stale:
                # optax.value_and_grad_from_state: where the line search
                # left no finite value, evaluate at the iterate
                f0, g0 = self.vg(s["x"])
                fin = torch.isfinite(s["value"])
                s["value"].copy_(torch.where(fin, s["value"], f0))
                s["grad"].copy_(torch.where(fin[:, None], s["grad"], g0))
            s["slot"].fill_((k - 1) % self.m)
            s["order"].copy_(self.orders[k % self.m])
            if g is None or k == 0:
                self.pre(s, first=k == 0)
            else:
                g["pre"].replay()
            for step in range(1, self.max_ls):
                if not bool(s["ls_run"]):
                    break
                last = step == self.max_ls - 1
                if g is None or last:
                    self.step(s, last=last)
                else:
                    g["step"].replay()
            if g is None:
                self.post(s)
            else:
                g["post"].replay()
        return MapResult(params=s["x"].clone(), value=s["value"].clone(),
                         grad_norm=s["gnorm"].clone(),
                         n_iter=s["n_iter"].clone(),
                         converged=torch.isfinite(s["value"])
                         & (s["n_iter"] < self.max_iter))


def run_lbfgs(value_and_grad: Callable, x0, max_iter: int = 4000,
              tol: float = 1e-8, ftol_rel: float = 1e-13,
              memory_size: int = 10, max_linesearch_steps: int = 40,
              graphs=None) -> MapResult:
    """Minimize a batched loss from each row of ``x0`` (R, D).

    A row stops on gradient infinity norm <= tol (Stan's tol_grad
    analogue), on relative objective stagnation below ``ftol_rel`` after
    its second iteration (Stan's tol_rel_obj analogue), or at
    ``max_iter``. Both tolerances are floored at a multiple of the dtype's
    machine eps: the float64-calibrated defaults are unreachable in
    float32, where they would turn every fit into a fixed ``max_iter``
    burn. ``grad_norm`` is the norm of the gradient the last step started
    from; ``value`` is the objective after it. ``converged`` means the row
    stopped on a tolerance, not on the cap. On a CUDA device the
    iterations replay as CUDA graphs (the loss must be capturable), equal
    to the eager form; on the CPU they run eagerly. ``graphs`` (a progcache
    runner's dict) keeps the run's state and graphs across calls, keyed on
    the rows' shape, dtype and device, the cap, tolerances, history size
    and line-search steps; a later run of that key resets the state by
    copy and replays. ``value_and_grad`` must then be the runner's
    function."""
    key = ("lbfgs", tuple(x0.shape), str(x0.dtype), str(x0.device),
           int(max_iter), float(tol), float(ftol_rel), int(memory_size),
           int(max_linesearch_steps))
    lb = None if graphs is None else graphs.get(key)
    if lb is None:
        lb = _LBFGS(value_and_grad, x0, max_iter, tol, ftol_rel,
                    memory_size, max_linesearch_steps,
                    graphs=x0.device.type == "cuda")
        if graphs is not None:
            graphs[key] = lb
    else:
        lb.reset(x0)
    return lb.run()


def newton_polish(value_and_grad: Callable, hessian: Callable, x0,
                  max_iter: int = 100, tol: float = 1e-8) -> MapResult:
    """Damped (Levenberg) Newton refinement of each row of ``x0`` (R, D).

    ``value_and_grad(x, rows)`` and ``hessian(x, rows)`` evaluate the loss
    of the rows ``rows`` (an index tensor into the batch) at ``x`` (r, D):
    (f (r,), g (r, D)) and (r, D, D). A step solves (H + lam diag(max(
    |diag H|, 1))) s = g, is kept if the loss does not rise (lam / 3,
    floored at 1e-12) and refused otherwise (lam x 10). A row stops at
    ``max_iter``, at gradient infinity norm <= tol (floored at 50 eps) or
    once lam reaches 1e10; only running rows are evaluated. ``converged``
    is the certificate: a finite value with gradient norm <= tol."""
    x = x0.clone()
    R = x.shape[0]
    tol = max(tol, 50.0 * torch.finfo(x.dtype).eps)
    all_rows = torch.arange(R, device=x.device)
    val, g = value_and_grad(x, all_rows)
    lam = torch.full_like(val, 1e-3)
    it = torch.zeros(R, dtype=torch.int32, device=x.device)
    act = (it < max_iter) & (g.abs().amax(dim=1) > tol) & (lam < 1e10)
    while bool(act.any()):
        rows = torch.nonzero(act).flatten()
        xr, vr, gr, lr = x[rows], val[rows], g[rows], lam[rows]
        h = hessian(xr, rows)
        diag = torch.clamp_min(torch.diagonal(h, dim1=1, dim2=2).abs(), 1.0)
        h.diagonal(dim1=1, dim2=2).add_(lr[:, None] * diag)
        x_new = xr - torch.linalg.solve(h, gr)
        v_new, g_new = value_and_grad(x_new, rows)
        ok = torch.isfinite(v_new) & (v_new <= vr)
        x[rows] = torch.where(ok[:, None], x_new, xr)
        val[rows] = torch.where(ok, v_new, vr)
        g[rows] = torch.where(ok[:, None], g_new, gr)
        lam[rows] = torch.where(ok, torch.clamp_min(lr / 3.0, 1e-12),
                                lr * 10.0)
        it[rows] += 1
        act = (it < max_iter) & (g.abs().amax(dim=1) > tol) & (lam < 1e10)
    gnorm = g.abs().amax(dim=1)
    return MapResult(params=x, value=val, grad_norm=gnorm, n_iter=it,
                     converged=torch.isfinite(val) & (gnorm <= tol))


def run_lbfgs_restarts(value_and_grad: Callable, x0, max_iter: int = 4000,
                       **kw) -> MapResult:
    """L-BFGS from ``n`` starts per problem, all as one batch, keeping each
    problem's best finite optimum (the first on ties).

    x0: (P, n, D) starts; ``value_and_grad`` evaluates the (P * n, D) rows
    in that order (problem-major). Returns a MapResult over the P
    problems."""
    P, n, D = x0.shape
    res = run_lbfgs(value_and_grad, x0.reshape(P * n, D), max_iter=max_iter,
                    **kw)
    values = res.value.reshape(P, n)
    best = torch.argmin(torch.where(torch.isfinite(values), values,
                                    math.inf), dim=1)
    pick = torch.arange(P, device=x0.device) * n + best
    return MapResult(*(a[pick] for a in res))
