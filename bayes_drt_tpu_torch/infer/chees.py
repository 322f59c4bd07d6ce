"""Synchronous static multinomial HMC: its configuration, deterministic
schedules, trajectory and sampler (port of bayes_drt_tpu/infer/chees.py:98,
121,400,520).

``sample_shmc`` runs any batched ``value_and_grad`` over flat (B*C, D)
rows, B spectra of C chains each, with the JAX package's per-spectrum
pooling. Its adaptation loop (``run_shmc``) is shared with the flat-chain
sampler of infer/shmc_flat.py; only the trajectory differs: the
hand-written kernel there, ``shmc_trajectory`` (autograd, replayed as one
CUDA graph per draw on a CUDA device) here. ChEES is later work.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

_ITEM_12 = "is not ported yet (ROADMAP Queue 1 item 12)"


class SHMCConfig(NamedTuple):
    """Every draw of every chain runs exactly ``n_steps`` leapfrogs.

    The fields and defaults are the JAX package's. ``leaf_unroll``,
    ``draw_unroll`` and ``traj_block`` schedule the JAX package's compiled
    loops and Pallas grid and mean nothing here. ``pallas_traj`` and
    ``flat_chain`` pick the JAX package's flat-chain path; the port's
    single series DRT always runs its trajectory kernel, and both raise
    on any other model. ``recompute_grad`` recomputes the selected state's
    gradient once a draw instead of carrying it through the leaves (same
    posterior; the trajectory kernel always carries it). ``precision`` is
    "highest" (true fp32 products); the reduced-precision arm, the
    store-then-select trajectory (``traj_store``) and the rbg stream
    (``rng_impl``) are not ported and raise."""
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
        if self.precision != "highest":
            raise NotImplementedError(
                f"precision={self.precision!r} is not ported; the port runs "
                "true fp32 ('highest') until an A/B on the quality gates "
                "admits a reduced-precision arm")
        if self.traj_store:
            raise NotImplementedError("SHMCConfig(traj_store=True) "
                                      + _ITEM_12)
        if self.rng_impl != "threefry":
            raise NotImplementedError(
                f"SHMCConfig(rng_impl={self.rng_impl!r}) " + _ITEM_12)


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


class GraphedTrajectory:
    """``shmc_trajectory`` for fixed shapes and ``n_leap`` as one CUDA
    graph: the draw's every leaf (and the recompute) leave the host in one
    replay. The constructor's arguments fix the shapes, dtype and the
    ``value_and_grad`` closure, whose own tensors must stay alive and in
    place. A call copies the draw's inputs (q, p0, grad, logp, eps, m_inv,
    j, u_sel) into the graph's buffers, replays and returns copies of the
    outputs, equal to the eager form's."""

    def __init__(self, value_and_grad, n_leap, max_e, recompute_grad, q, p0,
                 grad, logp, eps, m_inv, j, u_sel, pool=None):
        if q.device.type != "cuda":
            raise ValueError("GraphedTrajectory runs on a CUDA device")
        self._j = torch.tensor(int(j), device=q.device)
        self._inp = [t.clone() for t in (q, p0, grad, logp, eps, m_inv)]
        self._u = u_sel.clone()

        def run():
            return shmc_trajectory(value_and_grad, n_leap, max_e,
                                   *self._inp, self._j, self._u,
                                   recompute_grad=recompute_grad)

        side = torch.cuda.Stream(device=q.device)
        side.wait_stream(torch.cuda.current_stream(q.device))
        with torch.cuda.stream(side):      # first use of every op off-graph
            run()
        torch.cuda.current_stream(q.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, pool=pool):
            self._out = run()
        self.pool_id = self._graph.pool()

    def __call__(self, q, p0, grad, logp, eps, m_inv, j, u_sel):
        for dst, src in zip(self._inp, (q, p0, grad, logp, eps, m_inv)):
            dst.copy_(src)
        self._u.copy_(u_sel)
        self._j.fill_(int(j))
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
             metric=None, time_traj: bool = False, time_draws: bool = False):
    """The adaptation loop of both SHMC samplers over (B*chains, D) rows,
    as the JAX package's sample_shmc runs it per spectrum: per-row dual
    averaging; Welford pooled within chain, then averaged per spectrum
    into that spectrum's diagonal metric; a per-spectrum pooled sampling
    step size (``_pool_eps``); the halton jitter and split schedules.

    ``traj(n_leap, q, p0, grad, logp, eps, m_inv_rows, j, u_sel)`` runs one
    draw's trajectory and returns (q, logp, grad, kin, sacc, diverging).
    ``noise`` is a zero-argument callable returning an iterator that yields
    the eps0 momentum normals (R, D) once and then (z (R, D), u_sel
    (n_leap, R)) per draw; by default it draws from ``generator``.
    ``init_step_size`` (a float or per-spectrum (B,)) seeds the step-size
    search, ``metric`` ((D,) or (B, D)) the inverse metric. ``time_traj``
    brackets each trajectory with CUDA events (``info['traj_ms']``);
    ``time_draws`` records each draw's host-clock seconds, closed by a
    device synchronize (``info['draw_s']``). Returns (draws (B, C, S, D),
    info with a leading B axis)."""
    from .nuts import (_da_init, _da_update, _regularized_variance,
                       _window_flags, find_reasonable_step_size)

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
        noise = generator_noise(generator, rt, dim, dtype, dev, nl_sched)
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
    wf_mean = torch.zeros((rt, dim), dtype=dtype, device=dev)
    wf_m2 = torch.zeros((rt, dim), dtype=dtype, device=dev)
    wf_n = 0.0
    eps_fixed = None
    draws = torch.empty((samples, rt, dim), dtype=dtype, device=dev)
    logp_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    acc_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    div_s = torch.empty((samples, rt), dtype=torch.bool, device=dev)
    en_s = torch.empty((samples, rt), dtype=dtype, device=dev)
    warm_div = torch.empty((warmup, rt), dtype=torch.bool, device=dev)
    events, draw_s = [], []

    for t in range(total):
        if time_draws:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        n_leap = int(nl_sched[t])
        if t < warmup:
            eps = torch.exp(da.log_eps)
        else:
            if eps_fixed is None:
                pooled = _pool_eps(torch.exp(da.log_eps_bar).reshape(
                    nb, chains), cfg)
                eps_fixed = (pooled if pooled.ndim == 2 else
                             pooled[:, None].expand(nb, chains)).reshape(rt)
            eps = eps_fixed
        eps = (eps * jit_mult[t]).contiguous()
        z, u_sel = next(stream)
        m_inv_rows = rows(m_inv).contiguous()
        p0 = z / torch.sqrt(m_inv_rows)
        if time_traj:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        q, logp, grad, kin, sacc, ever = traj(
            n_leap, q, p0, grad, logp, eps, m_inv_rows, int(j_split[t]),
            u_sel.contiguous())
        if time_traj:
            ev[1].record()
            events.append(ev)
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
            if cfg.adapt_mass:
                if in_slow[t]:
                    n1 = wf_n + 1.0
                    dlt = q - wf_mean
                    wf_mean = wf_mean + dlt / n1
                    wf_m2 = wf_m2 + dlt * (q - wf_mean)
                    wf_n = n1
                if win_end[t]:
                    if wf_n > 1:
                        var_within = (wf_m2 / max(wf_n - 1.0, 1.0)).reshape(
                            nb, chains, dim).mean(dim=1)
                        m_inv = _regularized_variance(var_within,
                                                      chains * wf_n)
                    wf_mean = torch.zeros_like(wf_mean)
                    wf_m2 = torch.zeros_like(wf_m2)
                    wf_n = 0.0
                    da = _da_init(torch.exp(da.log_eps))
        if time_draws:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            draw_s.append(time.perf_counter() - t0)

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
    if time_traj:
        torch.cuda.synchronize(dev)
        info["traj_ms"] = [a.elapsed_time(b) for a, b in events]
    if time_draws:
        info["draw_s"] = draw_s
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
    on their shapes, leapfrog count, ``recompute_grad`` and
    ``max_energy_error``; ``value_and_grad`` must then be the runner's
    function. With ``time_draws``, ``info['capture_s']`` holds the
    captures' seconds (none on a hit).
    Returns (draws (B, C, S, D), info with a leading B axis); ``inv_mass``
    is per spectrum (B, D), ``step_size`` per chain (B, C)."""
    max_e = cfg.max_energy_error
    rc = cfg.recompute_grad
    graphs = {} if graphs is None else graphs
    capture_s = []
    base = ("traj",) + tuple(q0.shape) + (str(q0.dtype), str(q0.device),
                                          float(max_e), bool(rc))

    def traj(n_leap, *args):
        if q0.device.type != "cuda":
            return shmc_trajectory(value_and_grad, n_leap, max_e, *args,
                                   recompute_grad=rc)
        key = base + (n_leap,)
        if key not in graphs:
            t0 = time.perf_counter()
            pool = next((g.pool_id for k, g in graphs.items()
                         if k[:len(base)] == base), None)
            graphs[key] = GraphedTrajectory(value_and_grad, n_leap, max_e,
                                            rc, *args, pool=pool)
            torch.cuda.synchronize(q0.device)
            capture_s.append(time.perf_counter() - t0)
        return graphs[key](*args)

    draws, info = run_shmc(value_and_grad, traj, q0, warmup, samples, cfg,
                           chains, generator=generator, noise=noise,
                           init_step_size=init_step_size, metric=metric,
                           time_draws=time_draws)
    if time_draws:
        info["capture_s"] = capture_s
    return draws, info
