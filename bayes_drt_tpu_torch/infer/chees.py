"""The HMC samplers of fixed and of learned trajectory length (port of
bayes_drt_tpu/infer/chees.py).

Both run any batched ``value_and_grad`` over flat (B*C, D) rows, B
spectra of C chains each, spectrum-major, with the JAX package's
per-spectrum semantics.

``sample_shmc`` is synchronous static multinomial HMC (chees.py:98,121,
400,520). Its adaptation loop (``run_shmc``) is shared with the
flat-chain sampler of infer/shmc_flat.py; only the trajectory differs:
the hand-written kernel there, ``shmc_trajectory`` (autograd, replayed as
one CUDA graph per draw on a CUDA device) here.

``sample_chees`` is ChEES-HMC (chees.py:50-397): every chain of a
spectrum integrates for one shared, jittered trajectory time, learned in
warmup by Adam ascent on the ChEES criterion, so each chain's leapfrog
count ceil(h T / eps) differs. A draw reads the rows' largest count to
the host once and replays a CUDA graph of a fixed block of masked leaves
until every row is done (``ChEESLeaves``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._numerics import graph_capture
from ..profiling import StageTimer, count, span
from ..progcache import precise_matmuls

class SHMCConfig(NamedTuple):
    """Every draw of every chain runs exactly ``n_steps`` leapfrogs.

    The fields and defaults are the JAX package's. ``leaf_unroll``,
    ``draw_unroll`` and ``traj_block`` schedule the JAX package's compiled
    loops and Pallas grid and mean nothing here. ``pallas_traj`` and
    ``flat_chain`` pick the JAX package's flat-chain path; the port's
    single series DRT always runs its trajectory kernel, and both raise
    on any other model. ``recompute_grad`` recomputes the selected state's
    gradient once a draw instead of carrying it through the leaves (same
    posterior; the trajectory kernel always carries it). ``traj_store``
    runs the store-then-select trajectory (``shmc_trajectory_store``: the
    leaves' states stacked, one Gumbel-max categorical a draw), the same
    target distribution from another stream of draws; the trajectory
    kernel has no such form, so on the single series DRT it takes the
    generic sampler unless the flat arm is named. ``precision`` is
    "highest" (true fp32 products) or "high": the generic sampler's
    posterior products as tf32x3 (``_numerics.tf32x3_matmul``) on a CUDA
    device, the counterpart of the JAX package's bf16x3, opt-in (the
    trajectory kernel stays fp32, as the JAX package's flat-chain kernel
    pins 'highest'; on the CPU 'high' equals 'highest').
    ``rng_impl='rbg'`` (the TPU's RngBitGenerator) is dropped and
    raises."""
    n_steps: int = 32
    warm_steps: int = 0           # leapfrogs per warmup draw (0 = n_steps)
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    adapt_mass: bool = True
    leaf_unroll: int = 1
    draw_unroll: int = 1
    jitter_lo: float = 0.67       # per-draw step-size multiplier h is
                                  # halton-distributed in [jitter_lo, 1]
    rng_impl: str = "threefry"
    recompute_grad: bool = False
    eps_quantile: float = 0.0     # sampling-phase step size = this quantile
                                  # of the chains' adapted step sizes
                                  # (0 = min, < 0 = each chain its own)
    pallas_traj: bool = False
    traj_block: int = 256
    flat_chain: bool = False
    traj_store: bool = False
    precision: str = "highest"

    def validate(self) -> None:
        if self.precision not in ("highest", "high"):
            raise ValueError(f"precision must be 'highest' or 'high', not "
                             f"{self.precision!r}")
        if self.rng_impl != "threefry":
            raise NotImplementedError(
                f"SHMCConfig(rng_impl={self.rng_impl!r}) is dropped: it "
                "selected the TPU's RngBitGenerator stream, which Hopper "
                "lacks; the port draws from a torch.Generator (Philox on a "
                "CUDA device)")


def _pool_eps(eps_bc, cfg):
    """Pool per-chain adapted step sizes (B, C) into one sampling-phase eps
    per spectrum (B,) or, for eps_quantile < 0, keep them per chain."""
    q = cfg.eps_quantile
    if q < 0.0:
        return eps_bc
    if q == 0.0:
        return eps_bc.min(dim=1).values
    return torch.quantile(eps_bc, q, dim=1)


def _halton2(total: int) -> np.ndarray:
    """Van der Corput base-2 sequence in (0, 1): the shared quasi-random
    trajectory jitter."""
    out = np.zeros(total)
    for i in range(total):
        f, r, x = 0.5, 0.0, i + 1
        while x > 0:
            r += f * (x & 1)
            x >>= 1
            f *= 0.5
        out[i] = r
    return out


def _pooled_mass_step(wf, q, slow: bool, wend: bool, m_inv, da,
                      chains: int):
    """One warmup draw's mass adaptation in the chain-pooled samplers
    (SHMC, ChEES): per-chain Welford over the draws q (R, D) in the slow
    windows; at a window's end the within-chain variances, averaged over
    each spectrum's chains, become its regularized diagonal metric (B, D),
    the accumulator clears and the dual averaging restarts at the current
    step size. ``wf`` is (mean (R, D), M2 (R, D), n). Returns (wf, m_inv,
    da)."""
    from .nuts import _da_init, _regularized_variance
    mean, m2, n = wf
    if slow:
        n = n + 1.0
        dlt = q - mean
        mean = mean + dlt / n
        m2 = m2 + dlt * (q - mean)
    if wend:
        if n > 1:
            var_within = (m2 / max(n - 1.0, 1.0)).reshape(
                -1, chains, m2.shape[1]).mean(dim=1)
            m_inv = _regularized_variance(var_within, chains * n)
        mean, m2, n = torch.zeros_like(mean), torch.zeros_like(m2), 0.0
        da = _da_init(torch.exp(da.log_eps))
    return (mean, m2, n), m_inv, da


# ===================== trajectory =====================

def shmc_trajectory(value_and_grad, n_leap: int, max_e: float, q, p0, grad,
                    logp, eps, m_inv, j, u_sel, recompute_grad: bool = False):
    """One draw's static multinomial trajectory for every row (R, D): the
    backward leg with flipped momentum until leaf ``j``, then the forward
    leg from the start state; a leg freezes on NaN or when dH > max_e and
    is never selected; the next state is drawn from all n_leap + 1 states
    by streaming multinomial selection with the uniforms ``u_sel``
    (n_leap, R). ``j`` is an int or a 0-d integer tensor on the rows'
    device: the leg switch is a device-side select, so one captured graph
    serves every draw. ``recompute_grad`` evaluates the selected state's
    gradient once after the leaves instead of selecting it at each leaf.
    Returns (q, logp, grad, kin, sacc, diverging) of the selected point."""
    j = torch.as_tensor(j, device=q.device)
    kin0 = 0.5 * torch.sum(p0 * p0 * m_inv, dim=1, keepdim=True)
    lp0 = logp[:, None]
    H0 = -lp0 + kin0
    epsc = eps[:, None]
    zero = torch.zeros_like(lp0)
    no = torch.zeros_like(lp0, dtype=torch.bool)
    neg_inf = torch.full_like(lp0, -math.inf)
    qq, pp, gg, lp, dead = q, -p0, grad, lp0, no
    logw, pq, plp, pg, pkin, sacc, ever = zero, q, lp0, grad, kin0, zero, no
    for i in range(n_leap):
        flip = j == i
        qq = torch.where(flip, q, qq)
        pp = torch.where(flip, p0, pp)
        gg = torch.where(flip, grad, gg)
        lp = torch.where(flip, lp0, lp)
        dead = dead & ~flip
        p_half = pp + 0.5 * epsc * gg
        q_new = qq + epsc * p_half * m_inv
        lp1, g_new = value_and_grad(q_new)
        lp_new = lp1[:, None]
        p_new = p_half + 0.5 * epsc * g_new
        kin = 0.5 * torch.sum(p_new * p_new * m_inv, dim=1, keepdim=True)
        Hn = -lp_new + kin
        w = H0 - Hn
        bad = torch.isnan(Hn) | ((Hn - H0) > max_e)
        w = torch.where(bad | dead, neg_inf, w)
        logw_new = torch.logaddexp(logw, w)
        take = torch.log(u_sel[i][:, None]) < (w - logw_new)
        pq = torch.where(take, q_new, pq)
        plp = torch.where(take, lp_new, plp)
        if not recompute_grad:
            pg = torch.where(take, g_new, pg)
        pkin = torch.where(take, kin, pkin)
        sacc = sacc + torch.clamp(torch.exp(w), max=1.0)
        dead = dead | bad
        ever = ever | dead
        alive = ~dead
        qq = torch.where(alive, q_new, qq)
        pp = torch.where(alive, p_new, pp)
        gg = torch.where(alive, g_new, gg)
        lp = torch.where(alive, lp_new, lp)
        logw = logw_new
    if recompute_grad:
        _, pg = value_and_grad(pq)
    return pq, plp[:, 0], pg, pkin[:, 0], sacc[:, 0], ever[:, 0]


def shmc_trajectory_store(value_and_grad, n_leap: int, max_e: float, q, p0,
                          grad, logp, eps, m_inv, j, u_sel):
    """The store-then-select form of ``shmc_trajectory`` (the JAX
    package's ``traj_store``, chees.py:617-671): a leaf carries only the
    integrator state and ``dead``; the leaves' (q, logp, kin, w, dead)
    stack, and one Gumbel-max categorical over the n_leap + 1 states
    (the start state at weight 1) picks the next state with the uniforms
    ``u_sel`` (n_leap + 1, R), floored at the dtype's smallest normal. A
    leg that meets NaN or dH > max_e is dead from there on: it keeps
    integrating, its states carry w = -inf and are never selected. The
    selected state's gradient is evaluated once. The same target
    distribution as the streaming form, from another use of the uniforms.
    Returns (q, logp, grad, kin, sacc, diverging) of the selected
    point."""
    j = torch.as_tensor(j, device=q.device)
    rows = q.shape[0]
    kin0 = 0.5 * torch.sum(p0 * p0 * m_inv, dim=1)
    H0 = -logp + kin0
    epsc = eps[:, None]
    neg_inf = torch.full_like(logp, -math.inf)
    qq, pp, gg = q, -p0, grad
    dead = torch.zeros_like(logp, dtype=torch.bool)
    qs, lps, kins, ws, deads = [], [], [], [], []
    for i in range(n_leap):
        flip = j == i
        qq = torch.where(flip, q, qq)
        pp = torch.where(flip, p0, pp)
        gg = torch.where(flip, grad, gg)
        dead = dead & ~flip
        p_half = pp + 0.5 * epsc * gg
        q_new = qq + epsc * p_half * m_inv
        lp_new, g_new = value_and_grad(q_new)
        p_new = p_half + 0.5 * epsc * g_new
        kin = 0.5 * torch.sum(p_new * p_new * m_inv, dim=1)
        Hn = -lp_new + kin
        dead = dead | torch.isnan(Hn) | ((Hn - H0) > max_e)
        qs.append(q_new)
        lps.append(lp_new)
        kins.append(kin)
        ws.append(torch.where(dead, neg_inf, H0 - Hn))
        deads.append(dead)
        qq, pp, gg = q_new, p_new, g_new
    w = torch.stack(ws)
    w_all = torch.cat([torch.zeros_like(w[:1]), w])
    u = torch.clamp(u_sel, min=torch.finfo(u_sel.dtype).tiny)
    idx = torch.argmax(w_all - torch.log(-torch.log(u)), dim=0)
    took = idx > 0
    safe = torch.clamp(idx - 1, min=0)
    ar = torch.arange(rows, device=q.device)
    q_next = torch.where(took[:, None], torch.stack(qs)[safe, ar], q)
    logp_next = torch.where(took, torch.stack(lps)[safe, ar], logp)
    kin_next = torch.where(took, torch.stack(kins)[safe, ar], kin0)
    _, grad_next = value_and_grad(q_next)
    sacc = torch.clamp(torch.exp(w), max=1.0).sum(dim=0)
    return (q_next, logp_next, grad_next, kin_next, sacc,
            torch.stack(deads).any(dim=0))


class GraphedTrajectory:
    """``shmc_trajectory`` (or, with ``store``, ``shmc_trajectory_store``)
    for fixed shapes and ``n_leap`` as one CUDA graph: the draw's every
    leaf (and the recompute) leave the host in one replay. The
    constructor's arguments fix the shapes, dtype and the
    ``value_and_grad`` closure, whose own tensors must stay alive and in
    place. A call copies the draw's inputs (q, p0, grad, logp, eps, m_inv,
    j, u_sel) into the graph's buffers, replays and returns copies of the
    outputs, equal to the eager form's."""

    def __init__(self, value_and_grad, n_leap, max_e, recompute_grad, q, p0,
                 grad, logp, eps, m_inv, j, u_sel, pool=None,
                 store: bool = False):
        if q.device.type != "cuda":
            raise ValueError("GraphedTrajectory runs on a CUDA device")
        self._j = torch.tensor(int(j), device=q.device)
        self._inp = [t.clone() for t in (q, p0, grad, logp, eps, m_inv)]
        self._u = u_sel.clone()

        def run():
            if store:
                return shmc_trajectory_store(value_and_grad, n_leap, max_e,
                                             *self._inp, self._j, self._u)
            return shmc_trajectory(value_and_grad, n_leap, max_e,
                                   *self._inp, self._j, self._u,
                                   recompute_grad=recompute_grad)

        side = torch.cuda.Stream(device=q.device)
        side.wait_stream(torch.cuda.current_stream(q.device))
        with torch.cuda.stream(side):      # first use of every op off-graph
            run()
        torch.cuda.current_stream(q.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with graph_capture(self._graph, q.device, pool=pool):
            self._out = run()
        self.pool_id = self._graph.pool()

    def __call__(self, q, p0, grad, logp, eps, m_inv, j, u_sel):
        for dst, src in zip(self._inp, (q, p0, grad, logp, eps, m_inv)):
            dst.copy_(src)
        self._u.copy_(u_sel)
        self._j.fill_(int(j))
        with span("sample/draw/traj/replay"):
            self._graph.replay()
        return tuple(t.clone() for t in self._out)


# ===================== sampler =====================

def generator_noise(generator, rows, dim, dtype, device, n_leaps):
    """The default noise stream: the eps0 momentum normals (R, D), then per
    draw (z (R, D), u_sel (n_leap, R)) from ``generator``."""
    def stream():
        yield torch.randn((rows, dim), generator=generator, dtype=dtype,
                          device=device)
        for nl in n_leaps:
            z = torch.randn((rows, dim), generator=generator, dtype=dtype,
                            device=device)
            u = torch.rand((nl, rows), generator=generator, dtype=dtype,
                           device=device)
            yield z, u
    return stream


def run_shmc(value_and_grad, traj, q0, warmup: int, samples: int, cfg,
             chains: int, generator=None, noise=None, init_step_size=1.0,
             metric=None, time_draws: bool = False):
    """The adaptation loop of both SHMC samplers over (B*chains, D) rows,
    as the JAX package's sample_shmc runs it per spectrum: per-row dual
    averaging; Welford pooled within chain, then averaged per spectrum
    into that spectrum's diagonal metric; a per-spectrum pooled sampling
    step size (``_pool_eps``); the halton jitter and split schedules.

    ``traj(n_leap, q, p0, grad, logp, eps, m_inv_rows, j, u_sel)`` runs one
    draw's trajectory and returns (q, logp, grad, kin, sacc, diverging).
    ``noise`` is a zero-argument callable returning an iterator that yields
    the eps0 momentum normals (R, D) once and then (z (R, D), u_sel
    (n_leap, R), or (n_leap + 1, R) with ``cfg.traj_store``) per draw; by
    default it draws from ``generator``.
    ``init_step_size`` (a float or per-spectrum (B,)) seeds the step-size
    search, ``metric`` ((D,) or (B, D)) the inverse metric.
    ``time_draws`` records each draw's host-clock seconds, closed by a
    device synchronize (``info['draw_s']``). In a recording scope each
    draw is the span ``sample/draw``, inside that synchronize, from the
    loop's top to its last store, with the trajectory's call as
    ``sample/draw/traj``; the counter ``sample/draws`` counts them.
    Returns (draws (B, C, S, D), info with a leading B axis)."""
    from .nuts import (_da_init, _da_update, _window_flags,
                       find_reasonable_step_size)

    cfg.validate()
    rt, dim = q0.shape
    nb = rt // chains
    dtype, dev = q0.dtype, q0.device
    n_leap_s = cfg.n_steps
    n_leap_w = cfg.warm_steps or cfg.n_steps
    total = warmup + samples
    nl_sched = np.concatenate([np.full(warmup, n_leap_w),
                               np.full(samples, n_leap_s)]).astype(int)
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a noise stream")
        noise = generator_noise(generator, rt, dim, dtype, dev,
                                nl_sched + int(cfg.traj_store))
    stream = noise()

    def rows(x):
        # (B, ...) per-spectrum values -> (B * chains, ...) rows
        return x.repeat_interleave(chains, dim=0)

    logp, grad = value_and_grad(q0)
    q = q0
    if metric is None:
        m_inv = torch.ones((nb, dim), dtype=dtype, device=dev)
    else:
        m_inv = torch.as_tensor(metric, device=dev).to(dtype).expand(
            nb, dim).clone()
    eps_init = torch.as_tensor(init_step_size, device=dev).to(dtype)
    if eps_init.ndim == 1:
        eps_init = rows(eps_init)
    eps0 = find_reasonable_step_size(value_and_grad, q0, logp, grad,
                                     next(stream), rows(m_inv),
                                     init_eps=eps_init)

    if cfg.adapt_mass:
        in_slow, win_end = _window_flags(warmup, cfg)
    else:
        in_slow = win_end = np.zeros(warmup, bool)
    h1 = _halton2(total)
    h2 = _halton2(2 * total)[total:]
    jit_mult = torch.as_tensor(cfg.jitter_lo + (1.0 - cfg.jitter_lo) * h1,
                               dtype=dtype, device=dev)
    j_split = np.floor(h2 * (nl_sched + 1)).clip(0, nl_sched).astype(int)

    da = _da_init(eps0)
    wf = (torch.zeros((rt, dim), dtype=dtype, device=dev),
          torch.zeros((rt, dim), dtype=dtype, device=dev), 0.0)
    eps_fixed = None
    draws = torch.empty((samples, rt, dim), dtype=dtype, device=dev)
    logp_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    acc_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    div_s = torch.empty((samples, rt), dtype=torch.bool, device=dev)
    en_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    warm_div = torch.empty((warmup, rt), dtype=torch.bool, device=dev)
    clock = StageTimer(dev, on=time_draws)

    for t in range(total):
        with clock.stage("draw"), span("sample/draw"):
            n_leap = int(nl_sched[t])
            if t < warmup:
                eps = torch.exp(da.log_eps)
            else:
                if eps_fixed is None:
                    pooled = _pool_eps(torch.exp(da.log_eps_bar).reshape(
                        nb, chains), cfg)
                    eps_fixed = (pooled if pooled.ndim == 2 else
                                 pooled[:, None].expand(nb, chains)
                                 ).reshape(rt)
                eps = eps_fixed
            eps = (eps * jit_mult[t]).contiguous()
            z, u_sel = next(stream)
            m_inv_rows = rows(m_inv).contiguous()
            p0 = z / torch.sqrt(m_inv_rows)
            with span("sample/draw/traj"):
                q, logp, grad, kin, sacc, ever = traj(
                    n_leap, q, p0, grad, logp, eps, m_inv_rows,
                    int(j_split[t]), u_sel.contiguous())
            accept_prob = sacc / n_leap
            if t >= warmup:
                s = t - warmup
                draws[s] = q
                logp_s[s] = logp
                acc_s[s] = accept_prob
                div_s[s] = ever
                en_s[s] = -logp + kin
            else:
                warm_div[t] = ever
                da = _da_update(da, accept_prob, cfg)
                wf, m_inv, da = _pooled_mass_step(wf, q, in_slow[t],
                                                  win_end[t], m_inv, da,
                                                  chains)
    count("sample/draws", total)

    def per_spec(x):
        # (T, rt, ...) -> (B, C, T, ...)
        return x.reshape((x.shape[0], nb, chains) + x.shape[2:]).movedim(0, 2)

    info = {
        "logp": per_spec(logp_s),
        "accept_prob": per_spec(acc_s),
        "diverging": per_spec(div_s),
        "n_leapfrog": torch.full((nb, chains, samples), n_leap_s,
                                 dtype=torch.int32, device=dev),
        "energy": per_spec(en_s),
        "step_size": torch.exp(da.log_eps_bar).reshape(nb, chains),
        "inv_mass": m_inv,
        "warmup_diverging": per_spec(warm_div),
    }
    if time_draws:
        info["draw_s"] = clock.laps.get("draw", [])
    return per_spec(draws), info


def sample_shmc(value_and_grad, q0, warmup: int, samples: int,
                cfg: SHMCConfig, chains: int, generator=None, noise=None,
                init_step_size=1.0, metric=None, time_draws: bool = False,
                graphs=None):
    """Static multinomial HMC on any batched posterior: rows q0 (B*chains,
    D), spectrum-major, and ``value_and_grad(q)`` returning (logp (R,),
    grad (R, D)). Each draw samples momentum, splits the static n-step
    trajectory around the current state at the shared halton index, and
    integrates with a per-draw jittered step size (``shmc_trajectory``);
    the adaptation is ``run_shmc``'s. On a CUDA device each draw's
    trajectory replays as a CUDA graph (``GraphedTrajectory``), one for the
    warmup length and one for the sampling length, captured at their first
    draw into one memory pool; on the CPU it runs eagerly. ``graphs`` (a
    progcache runner's dict) keeps the trajectories across calls, keyed
    on their shapes, leapfrog count, ``recompute_grad``,
    ``max_energy_error``, ``traj_store`` and ``precision``;
    ``value_and_grad`` must then be the runner's function. The run is
    under ``cfg.precision`` (progcache.precise_matmuls). With
    ``time_draws``, ``info['capture_s']`` holds the captures' seconds
    (none on a hit).
    Returns (draws (B, C, S, D), info with a leading B axis); ``inv_mass``
    is per spectrum (B, D), ``step_size`` per chain (B, C)."""
    max_e = cfg.max_energy_error
    rc = cfg.recompute_grad
    graphs = {} if graphs is None else graphs
    clock = StageTimer(q0.device, on=time_draws)
    store = bool(cfg.traj_store)
    base = ("traj",) + tuple(q0.shape) + (str(q0.dtype), str(q0.device),
                                          float(max_e), bool(rc), store,
                                          cfg.precision)

    def traj(n_leap, *args):
        if q0.device.type != "cuda":
            if store:
                return shmc_trajectory_store(value_and_grad, n_leap, max_e,
                                             *args)
            return shmc_trajectory(value_and_grad, n_leap, max_e, *args,
                                   recompute_grad=rc)
        key = base + (n_leap,)
        if key not in graphs:
            with clock.stage("capture"):
                pool = next((g.pool_id for k, g in graphs.items()
                             if k[:len(base)] == base), None)
                graphs[key] = GraphedTrajectory(value_and_grad, n_leap,
                                                max_e, rc, *args, pool=pool,
                                                store=store)
                torch.cuda.synchronize(q0.device)
        return graphs[key](*args)

    with precise_matmuls(cfg.precision):
        draws, info = run_shmc(value_and_grad, traj, q0, warmup, samples,
                               cfg, chains, generator=generator, noise=noise,
                               init_step_size=init_step_size, metric=metric,
                               time_draws=time_draws)
    if time_draws:
        info["capture_s"] = clock.laps.get("capture", [])
    return draws, info


# ===================== ChEES-HMC =====================

class ChEESConfig(NamedTuple):
    """The JAX package's ChEES-HMC configuration, field for field: a draw
    runs ceil(h T / eps) leapfrogs, clipped to [min_steps, max_steps], for
    the halton jitter h, the spectrum's trajectory time T (learned in
    warmup by Adam at ``adam_lr`` from ``init_steps`` step sizes) and the
    chain's step size eps (dual averaging to ``delta``); the mass metric
    is adapted in Stan's windows, pooled within chain over a spectrum's
    chains."""
    max_steps: int = 128
    min_steps: int = 8            # a floor on leapfrogs a draw: with 1-3
                                  # leaves the accept statistic is bimodal
                                  # on stiff posteriors
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    adapt_mass: bool = True
    adam_lr: float = 0.025
    init_steps: int = 8


class _AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


def _adam_init(n: int, dtype, device=None) -> _AdamState:
    """Adam's state for ``n`` scalars (one log trajectory time a
    spectrum)."""
    z = torch.zeros(n, dtype=dtype, device=device)
    return _AdamState(m=z, v=z, t=z)


def _adam_update(st: _AdamState, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step on ``grad``: the new state and the step to add (an
    ascent step)."""
    t = st.t + 1.0
    m = b1 * st.m + (1.0 - b1) * grad
    v = b2 * st.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    step = lr * mhat / (torch.sqrt(vhat) + eps)
    return _AdamState(m=m, v=v, t=t), step


class LegState(NamedTuple):
    """Per-row state of a ChEES draw's leaves, (R, D) or (R, 1): the
    integrator (qq, pp, gg, lp, dead), the multinomial selection (logw,
    pq, plp, pg, pkin), the accept sum, the divergence flag and the
    backward leg's end (q_b, p_b)."""
    qq: torch.Tensor
    pp: torch.Tensor
    gg: torch.Tensor
    lp: torch.Tensor
    dead: torch.Tensor
    logw: torch.Tensor
    pq: torch.Tensor
    plp: torch.Tensor
    pg: torch.Tensor
    pkin: torch.Tensor
    sacc: torch.Tensor
    div: torch.Tensor
    q_b: torch.Tensor
    p_b: torch.Tensor


class LegInputs(NamedTuple):
    """What a draw's leaves read and do not change: the start state (q,
    p0, grad (R, D), lp0 (R, 1)), H0, eps (R, 1), the rows' diagonal
    metric (R, D), the backward leaves j_back and the leapfrog count
    n_steps (R, 1, integer), and the backward and forward legs' leaf
    uniforms (R, L), L at least the leaves run."""
    q: torch.Tensor
    p0: torch.Tensor
    grad: torch.Tensor
    lp0: torch.Tensor
    H0: torch.Tensor
    eps: torch.Tensor
    m_inv: torch.Tensor
    j_back: torch.Tensor
    n_steps: torch.Tensor
    u_back: torch.Tensor
    u_fwd: torch.Tensor


def leg_start(inp: LegInputs, kin0) -> LegState:
    """The state before a draw's first leaf: the backward leg (momentum
    flipped) at the start state, which holds the selection with weight
    e^0."""
    no = torch.zeros_like(inp.lp0, dtype=torch.bool)
    zero = torch.zeros_like(inp.lp0)
    return LegState(qq=inp.q, pp=-inp.p0, gg=inp.grad, lp=inp.lp0, dead=no,
                    logw=zero, pq=inp.q, plp=inp.lp0, pg=inp.grad, pkin=kin0,
                    sacc=zero, div=no, q_b=inp.q, p_b=-inp.p0)


def chees_leaves(value_and_grad, k0, n_leaf: int, max_e: float,
                 st: LegState, inp: LegInputs) -> LegState:
    """Leaves k0 .. k0 + n_leaf - 1 of a ChEES draw for every row, ``k0`` a
    0-d integer tensor on the rows' device (so one captured graph serves
    every block). Row r runs its backward leg for leaves k < j_back[r]
    (leaf k of the leg), then restarts from the start state with the
    momentum forward for leaves j_back[r] <= k < n_steps[r] (forward leaf
    k - j_back[r]); later leaves are masked no-ops. Each leg freezes on NaN
    or when dH > ``max_e`` and never selects such a state; the next state
    streams by multinomial selection with the leg's leaf uniforms. This
    is the JAX package's two while_loops (chees.py:222-287) per row, run
    as one loop of max over rows of n_steps leaves."""
    neg_inf = torch.full_like(inp.lp0, -math.inf)
    zero = torch.zeros_like(inp.lp0)
    last = inp.u_fwd.shape[1] - 1
    for m in range(n_leaf):
        k = k0 + m
        flip = inp.j_back == k
        q_b = torch.where(flip, st.qq, st.q_b)
        p_b = torch.where(flip, st.pp, st.p_b)
        qq = torch.where(flip, inp.q, st.qq)
        pp = torch.where(flip, inp.p0, st.pp)
        gg = torch.where(flip, inp.grad, st.gg)
        lp = torch.where(flip, inp.lp0, st.lp)
        dead = st.dead & ~flip
        act = (k < inp.n_steps) & ~dead
        p_half = pp + 0.5 * inp.eps * gg
        q_new = qq + inp.eps * p_half * inp.m_inv
        lp1, g_new = value_and_grad(q_new)
        lp_new = lp1[:, None]
        p_new = p_half + 0.5 * inp.eps * g_new
        kin = 0.5 * torch.sum(p_new * p_new * inp.m_inv, dim=1, keepdim=True)
        Hn = -lp_new + kin
        w = inp.H0 - Hn
        bad = torch.isnan(Hn) | ((Hn - inp.H0) > max_e)
        w = torch.where(bad, neg_inf, w)
        logw = torch.where(act, torch.logaddexp(st.logw, w), st.logw)
        u_b = inp.u_back.index_select(1, k.reshape(1))
        u_f = inp.u_fwd.gather(1, torch.clamp(k - inp.j_back, 0, last))
        u = torch.where(k < inp.j_back, u_b, u_f)
        take = act & ~bad & (torch.log(u) < (w - logw))
        ok = act & ~bad
        st = LegState(
            qq=torch.where(ok, q_new, qq), pp=torch.where(ok, p_new, pp),
            gg=torch.where(ok, g_new, gg), lp=torch.where(ok, lp_new, lp),
            dead=dead | (act & bad), logw=logw,
            pq=torch.where(take, q_new, st.pq),
            plp=torch.where(take, lp_new, st.plp),
            pg=torch.where(take, g_new, st.pg),
            pkin=torch.where(take, kin, st.pkin),
            sacc=st.sacc + torch.where(act, torch.clamp(torch.exp(w),
                                                        max=1.0), zero),
            div=st.div | (act & bad), q_b=q_b, p_b=p_b)
    return st


class ChEESLeaves:
    """``chees_leaves`` for fixed shapes and ``n_leaf`` as one CUDA graph
    that reads its inputs and state from static buffers and writes the
    state back into them, so a draw loads its inputs once (``load``) and
    replays the graph once a block (``run``). The constructor's arguments
    fix the shapes, dtype and the ``value_and_grad`` closure, whose own
    tensors must stay alive and in place (a progcache runner's
    buffers)."""

    def __init__(self, value_and_grad, n_leaf, max_e, st, inp):
        dev = inp.q.device
        if dev.type != "cuda":
            raise ValueError("ChEESLeaves runs on a CUDA device")
        self.n_leaf = n_leaf
        self._k0 = torch.zeros((), dtype=torch.long, device=dev)
        self._inp = LegInputs(*(t.clone() for t in inp))
        self._st = LegState(*(t.clone() for t in st))

        def run():
            out = chees_leaves(value_and_grad, self._k0, n_leaf, max_e,
                               self._st, self._inp)
            for dst, src in zip(self._st, out):
                dst.copy_(src)

        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):      # first use of every op off-graph
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with graph_capture(self._graph, dev):
            run()
        self.pool_id = self._graph.pool()

    def load(self, st, inp):
        for dst, src in zip(tuple(self._st) + tuple(self._inp),
                            tuple(st) + tuple(inp)):
            dst.copy_(src)

    def run(self, k0: int):
        self._k0.fill_(k0)
        self._graph.replay()

    def state(self) -> LegState:
        return LegState(*(t.clone() for t in self._st))


def chees_noise(generator, n_spec: int, rows: int, dim: int, max_steps: int,
                dtype, device, draws: int):
    """The default noise stream of ``sample_chees``: the step-size
    search's momentum normals (R, D) once, then per draw (z (R, D), uj
    (B,), u_back (max_steps, R), u_fwd (max_steps, R)) from
    ``generator``."""
    def stream():
        def u(*shape):
            return torch.rand(shape, generator=generator, dtype=dtype,
                              device=device)
        yield torch.randn((rows, dim), generator=generator, dtype=dtype,
                          device=device)
        for _ in range(draws):
            z = torch.randn((rows, dim), generator=generator, dtype=dtype,
                            device=device)
            yield z, u(n_spec), u(max_steps, rows), u(max_steps, rows)
    return stream


def sample_chees(value_and_grad, q0, warmup: int, samples: int,
                 cfg: ChEESConfig, chains: int, generator=None, noise=None,
                 init_step_size=1.0, metric=None, init_traj_time=None,
                 time_draws: bool = False, graphs=None):
    """ChEES-HMC on any batched posterior: rows q0 (B*chains, D),
    spectrum-major, and ``value_and_grad(q)`` returning (logp (R,), grad
    (R, D)); the JAX package's sample_chees run per spectrum.

    Per spectrum: the log trajectory time and its Adam state, the ChEES
    gradient over its chains, the clip of the new time to [mean eps, mean
    eps * max_steps], one split uniform a draw, the diagonal metric from
    per-chain Welford pooled within chain (with the dual-averaging reset
    at window ends) and the sampling step size, the min over its chains
    of exp(log_eps_bar). Per chain: the dual averaging, the leapfrog count
    clip(ceil(h T / eps), min_steps, max_steps), the split into j_back
    backward and n_steps - j_back forward leaves, the freeze on NaN or
    dH > max_energy_error and the streaming multinomial selection.

    ``noise`` is a zero-argument callable returning an iterator that
    yields the step-size search's normals (R, D) once and then per draw
    (z (R, D), uj (B,), u_back (max_steps, R), u_fwd (max_steps, R));
    by default it draws from ``generator`` (``chees_noise``).
    ``init_step_size`` (a float or per-spectrum (B,)) seeds the step-size
    search, ``metric`` ((D,) or (B, D)) the inverse metric (held with
    ``cfg.adapt_mass=False``), ``init_traj_time`` (a float or (B,)) the
    trajectory time (by default init_steps times the spectrum's mean
    searched step size).

    A draw reads the largest leapfrog count over the rows to the host and
    runs the leaves in blocks of ``min_steps`` (``chees_leaves``): on a
    CUDA device each block is a replay of one captured graph
    (``ChEESLeaves``, kept in ``graphs``, a progcache runner's dict, when
    given; ``value_and_grad`` must then be the runner's function), on the
    CPU it runs eagerly. ``time_draws`` records each draw's seconds,
    closed by a device synchronize (``info['draw_s']``), and the
    capture's (``info['capture_s']``). ``info['leaf_max']`` holds each
    draw's largest leapfrog count and ``info['replays']`` its blocks.

    Returns (draws (B, C, S, D), info with a leading B axis: logp,
    accept_prob, diverging, n_leapfrog, energy (B, C, S); step_size (B,
    C); inv_mass (B, D); traj_time (B,); warmup_diverging, warmup_accept,
    warmup_n_leapfrog, warmup_step_size (B, C, W); warmup_traj_time (B,
    W))."""
    from .nuts import (_da_init, _da_update, _window_flags,
                       find_reasonable_step_size)

    rt, dim = q0.shape
    nb = rt // chains
    dtype, dev = q0.dtype, q0.device
    total = warmup + samples
    max_e = cfg.max_energy_error
    n_leaf = max(1, min(cfg.min_steps, cfg.max_steps))
    n_pad = -(-cfg.max_steps // n_leaf) * n_leaf
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a noise stream")
        noise = chees_noise(generator, nb, rt, dim, cfg.max_steps, dtype,
                            dev, total)
    stream = noise()

    def rows(x):
        # (B, ...) per-spectrum values -> (B * chains, ...) rows
        return x.repeat_interleave(chains, dim=0)

    def per_spec(x):
        return x.reshape((nb, chains) + x.shape[1:])

    def t_(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    logp, grad = value_and_grad(q0)
    q = q0
    if metric is None:
        m_inv = torch.ones((nb, dim), dtype=dtype, device=dev)
    else:
        m_inv = t_(metric).expand(nb, dim).clone()
    eps_init = t_(init_step_size)
    if eps_init.ndim == 1:
        eps_init = rows(eps_init)
    eps0 = find_reasonable_step_size(value_and_grad, q0, logp, grad,
                                     next(stream), rows(m_inv),
                                     init_eps=eps_init)
    if init_traj_time is None:
        traj0 = per_spec(eps0).mean(dim=1) * cfg.init_steps
    else:
        traj0 = t_(init_traj_time).expand(nb).clone()
    log_traj = torch.log(traj0)
    adam = _adam_init(nb, dtype, dev)
    if cfg.adapt_mass:
        in_slow, win_end = _window_flags(warmup, cfg)
    else:
        in_slow = win_end = np.zeros(warmup, bool)
    halton = t_(_halton2(total))
    da = _da_init(eps0)
    wf = (torch.zeros((rt, dim), dtype=dtype, device=dev),
          torch.zeros((rt, dim), dtype=dtype, device=dev), 0.0)
    eps_samp = None

    draws = torch.empty((samples, rt, dim), dtype=dtype, device=dev)
    keep = {k: torch.empty((samples, rt), dtype=d, device=dev)
            for k, d in (("logp", dtype), ("accept_prob", dtype),
                         ("diverging", torch.bool),
                         ("n_leapfrog", torch.int32), ("energy", dtype))}
    warm = {k: torch.empty((warmup, rt), dtype=d, device=dev)
            for k, d in (("warmup_diverging", torch.bool),
                         ("warmup_accept", dtype),
                         ("warmup_n_leapfrog", torch.int32),
                         ("warmup_step_size", dtype))}
    warm_traj = torch.empty((warmup, nb), dtype=dtype, device=dev)
    leaf_max, replays = [], []
    clock = StageTimer(dev, on=time_draws)
    graphs = {} if graphs is None else graphs
    g_key = ("chees-leaves", rt, dim, str(dtype), str(dev), n_leaf, n_pad,
             float(max_e))
    u_pad = torch.ones((rt, n_pad), dtype=dtype, device=dev)

    for t in range(total):
        with clock.stage("draw"):
            is_warm = t < warmup
            if is_warm:
                eps = torch.exp(da.log_eps)
            else:
                if eps_samp is None:
                    eps_samp = rows(per_spec(torch.exp(da.log_eps_bar)).min(
                        dim=1).values)
                eps = eps_samp
            traj = torch.exp(log_traj)
            n_steps = torch.clamp(torch.nan_to_num(
                torch.ceil(halton[t] * rows(traj) / eps), nan=0.0),
                cfg.min_steps, cfg.max_steps).to(torch.long)
            z, uj, ub, uf = next(stream)
            m_rows = rows(m_inv)
            p0 = z / torch.sqrt(m_rows)
            kin0 = 0.5 * torch.sum(p0 * p0 * m_rows, dim=1, keepdim=True)
            lp0 = logp[:, None]
            j_back = torch.minimum(torch.clamp(torch.floor(
                rows(uj) * (n_steps + 1).to(dtype)).to(torch.long), min=0),
                n_steps)
            u_back = u_pad.clone()
            u_back[:, :cfg.max_steps] = ub.T
            u_fwd = u_pad.clone()
            u_fwd[:, :cfg.max_steps] = uf.T
            inp = LegInputs(q=q, p0=p0, grad=grad, lp0=lp0, H0=-lp0 + kin0,
                            eps=eps[:, None], m_inv=m_rows,
                            j_back=j_back[:, None], n_steps=n_steps[:, None],
                            u_back=u_back, u_fwd=u_fwd)
            st = leg_start(inp, kin0)
            n_max = int(n_steps.max())
            n_blocks = -(-n_max // n_leaf)
            if dev.type == "cuda":
                leaves = graphs.get(g_key)
                if leaves is None:
                    with clock.stage("capture"):
                        leaves = graphs[g_key] = ChEESLeaves(
                            value_and_grad, n_leaf, max_e, st, inp)
                        torch.cuda.synchronize(dev)
                leaves.load(st, inp)
                for blk in range(n_blocks):
                    leaves.run(blk * n_leaf)
                st = leaves.state()
            else:
                for blk in range(n_blocks):
                    st = chees_leaves(value_and_grad,
                                      torch.tensor(blk * n_leaf, device=dev),
                                      n_leaf, max_e, st, inp)
            leaf_max.append(n_max)
            replays.append(n_blocks)
            # a row whose backward leg took all its leaves never flipped
            end = inp.j_back >= n_blocks * n_leaf
            q_b = torch.where(end, st.qq, st.q_b)
            p_b = torch.where(end, st.pp, st.p_b)
            q_f = torch.where(end, q, st.qq)
            p_f = torch.where(end, p0, st.pp)
            q_next, logp_next, grad_next = st.pq, st.plp[:, 0], st.pg
            accept_prob = st.sacc[:, 0] / torch.clamp(n_steps, min=1).to(dtype)

            if is_warm:
                # the ChEES gradient on log T, pooled over the spectrum's
                # chains, through the longer leg's end (chees.py:296-327)
                n_fwd = n_steps - j_back
                use_fwd = (n_fwd >= j_back)[:, None]
                q_e = per_spec(torch.where(use_fwd, q_f, q_b))
                v_e = per_spec(torch.where(use_fwd, p_f, -p_b) * m_rows)
                t_e = per_spec(torch.maximum(n_fwd, j_back).to(dtype) * eps)
                acc = per_spec(accept_prob)
                qs, qn = per_spec(q), per_spec(q_next)
                m_cur = qs.mean(dim=1, keepdim=True)
                wsum = torch.clamp(acc.sum(dim=1), min=1e-6)
                m_prop = (torch.sum(acc[..., None] * qn, dim=1)
                          / wsum[:, None])[:, None]
                dsq = (torch.sum((qn - m_prop) ** 2, dim=2)
                       - torch.sum((qs - m_cur) ** 2, dim=2))
                dd = 2.0 * dsq * torch.sum((q_e - m_prop) * v_e, dim=2) * t_e
                fin = torch.isfinite(dd)
                w_c = torch.where(fin, acc, torch.zeros_like(acc))
                dd = torch.where(fin, dd, torch.zeros_like(dd))
                grad_c = (torch.sum(w_c * dd, dim=1)
                          / torch.clamp(w_c.sum(dim=1), min=1e-6))
                adam, step_t = _adam_update(adam, grad_c, cfg.adam_lr)
                eps_mean = per_spec(eps).mean(dim=1)
                log_traj = torch.minimum(
                    torch.maximum(log_traj + step_t, torch.log(eps_mean)),
                    torch.log(eps_mean * cfg.max_steps))
                da = _da_update(da, accept_prob, cfg)
                wf, m_inv, da = _pooled_mass_step(wf, q_next, in_slow[t],
                                                  win_end[t], m_inv, da,
                                                  chains)
                warm["warmup_diverging"][t] = st.div[:, 0]
                warm["warmup_accept"][t] = accept_prob
                warm["warmup_n_leapfrog"][t] = n_steps
                warm["warmup_step_size"][t] = eps
                warm_traj[t] = traj
            else:
                s = t - warmup
                draws[s] = q_next
                keep["logp"][s] = logp_next
                keep["accept_prob"][s] = accept_prob
                keep["diverging"][s] = st.div[:, 0]
                keep["n_leapfrog"][s] = n_steps
                keep["energy"][s] = -logp_next + st.pkin[:, 0]
            q, logp, grad = q_next, logp_next, grad_next

    def by_spec(x):
        # (T, rt, ...) -> (B, C, T, ...)
        return x.reshape((x.shape[0], nb, chains) + x.shape[2:]).movedim(0, 2)

    info = {k: by_spec(v) for k, v in {**keep, **warm}.items()}
    info.update(step_size=per_spec(torch.exp(da.log_eps_bar)),
                inv_mass=m_inv, traj_time=torch.exp(log_traj),
                warmup_traj_time=warm_traj.T, leaf_max=leaf_max,
                replays=replays)
    if time_draws:
        info["draw_s"] = clock.laps.get("draw", [])
        info["capture_s"] = clock.laps.get("capture", [])
    return by_spec(draws), info
