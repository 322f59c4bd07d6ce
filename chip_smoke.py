"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result
line is printed):
  1. device and build: the card's name and power limit; both CUDA kernels
     of bayes_drt_tpu_torch/csrc built with nvcc (in parallel).
  2. the quadrature kernel (csrc/quad.cu) against its plain version at
     N=81, K=101, real and imaginary parts, Q=1000 and 1024.
  3. the trajectory kernel (csrc/traj.cu) against the plain trajectory at
     R=4096 rows, D=211, n_leap=32 in float64 from random-init rows, and
     at a ragged R=4092, j=0 and j=n_leap; then on longer sweeps that
     need two output passes, smaller stages, the main tile's edge
     (2n + 3K = 507 of 512, K = 121) and the wide tile (K = 141), the
     last in float64 and float32.
  4. the main path: fit_spectra_batch on B=1024 noisy ZARC spectra,
     4 chains x (150 warmup + 250 draws), SHMC n_steps=32, float32, with
     the five quality gates of the JAX package's bench and the launch
     counts (2 quadrature, 400 trajectory launches).
  5. the trajectory kernel against the plain trajectory in float32 at the
     main path's final sampler states, and its time per launch.
  6. one JSON line listing both kernels with their launches and times.
The last line of stdout is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --check-only   # phases 1-3, then stop
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

B = 1024
CHAINS = 4
WARMUP = 150
SAMPLES = 250
N_STEPS = 32
EPS_QUANTILE = 0.5
GATE_RMSE = 0.03          # of Rp, batch-mean gamma
GATE_P90 = 0.05           # of Rp, per-spectrum RMSE p90
GATE_COVERAGE = 0.93      # pointwise 95% band coverage
GATE_MIN_ESS = 3.5        # median per-spectrum min-ESS
GATE_LOGP_RHAT = 4.0      # median per-spectrum logp split-Rhat

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP64_S = 34e12
# fp64-pipe instructions per quadrature node, estimated from the
# algorithms rather than read from the binary: about 17 for exp (range
# reduction, a degree-11 polynomial, rebuilding the exponent, the
# special-value test), about 8 for the IEEE divide (Newton steps on a
# reciprocal estimate, the quotient and its correction), and about 5
# adds and multiply-adds around them
QUAD_FP64_PER_NODE = 30
# frequency grids of the shape cases of phase 3: (n, K) = (91, 111) and
# (101, 121) need two output passes of the forward product, the second
# also smaller stages in float64; (72, 121) is the main tile's edge (one
# 512-row pass, 226.5 KB of shared memory in float64); (121, 141) runs on
# the wide tile
SWEEPS = {"n91_K111": (6, -3, 91), "n101_K121": (7, -3, 101),
          "n72_K121": (7, -3, 72), "n121_K141": (8, -4, 121)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Device time per call from CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol} (max abs err {float(err.max()):.3e})")
    return float(err.max())


def phase_quad(card):
    import torch
    from bayes_drt_tpu_torch.ops.matrices import (_quad_grid, default_epsilon,
                                                  get_tau_basis)
    from bayes_drt_tpu_torch.ops.quad import drt_quad, drt_quad_plain
    freq = np.logspace(6, -2, 81)
    tau = get_tau_basis(freq)
    eps = default_epsilon(tau)
    s64 = torch.log(2 * math.pi * torch.as_tensor(freq, device="cuda")[:, None]
                    * torch.as_tensor(tau, device="cuda")[None, :])
    max_err = 0.0
    inputs = {}
    for nq in (1000, 1024):
        y, w = _quad_grid(nq, 20.0, torch.float64, "cuda")
        phiw = torch.exp(-((eps * y) ** 2)) * w
        inputs[nq] = (y, phiw)
        for part in ("real", "imag"):
            ref = drt_quad_plain(s64, y, phiw, part)
            got = drt_quad(s64, y, phiw, part)
            err = check_close(f"quad f64 {part} Q={nq}", got, ref, 1e-10,
                              1e-14)
            if nq == 1000:
                max_err = max(max_err, err)
            got32 = drt_quad(s64.float(), y.float(), phiw.float(), part)
            check_close(f"quad f32 {part} Q={nq}", got32.double(), ref,
                        2e-4, 1e-5)
    torch.cuda.synchronize()
    y, phiw = inputs[1000]
    ms = cuda_ms(lambda: drt_quad(s64, y, phiw, "imag"), 200)
    plain_ms = cuda_ms(lambda: drt_quad_plain(s64, y, phiw, "imag"), 20)
    n, k = s64.shape
    q = y.numel()
    # bound: every node's exp, divide and adds as fp64-pipe instructions,
    # at one instruction per fp64 unit and clock (half the FMA flop rate)
    ops_s = n * k * q * QUAD_FP64_PER_NODE / (PEAK_FP64_S / 2)
    bytes_s = 8.0 * (2 * n * k + 2 * q) / PEAK_BYTES_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    print(f"quad: f64 within rtol 1e-10, f32 within rtol 2e-4/atol 1e-5 of "
          f"f64 (Q=1000 and 1024); kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms per call at N={n} K={k} Q={q} float64; bound "
          f"{bound_ms:.4f} ms ({QUAD_FP64_PER_NODE} fp64 instructions per "
          f"node, estimated), kernel at {100 * bound_ms / ms:.1f}% of it "
          f"[{card}]")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                bound_ms=bound_ms,
                bound_by="operations" if ops_s >= bytes_s else "bytes")


def traj_inputs(dtype, state=None, R=B * CHAINS, n_leap=N_STEPS, seed=0,
                j=None, freq=None):
    """Rows of the main path's posterior with targets from the bench batch
    (on ``freq``, by default the bench's 81 points). Without ``state``, q
    comes from the port's init and eps and the metric from a numpy seed;
    with ``state`` (the main path's final positions, metric and step
    sizes) the rows sit where the sampler runs. p0, u_sel and j (unless
    given) come from the numpy seed."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.shmc_flat import (flat_shared_for,
                                                     flat_spec_for,
                                                     flat_value_and_grad)
    from bayes_drt_tpu_torch.models.build import z_scale_for
    from bayes_drt_tpu_torch.models.posterior import (init_unconstrained,
                                                      ravel)
    from bayes_drt_tpu_torch.parallel.batch import _build_shared
    freq, Zb = sim.make_benchmark_batch(R // CHAINS, freq=freq, seed=0)
    _, _, _, cfg, data = _build_shared(freq, ncp=True, dtype=dtype,
                                       device="cuda")
    spec = flat_spec_for(cfg, data)
    sh = flat_shared_for(cfg, data, dtype)
    Zb = Zb[:, np.argsort(freq)[::-1]]
    zs = z_scale_for({"DRT": {"dist_type": "series"}}, Zb)
    Zs = Zb / zs[:, None]
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               device="cuda").to(dtype).contiguous()

    tgt = t(np.repeat(np.concatenate([Zs.real, Zs.imag], axis=1), CHAINS,
                      axis=0))
    if state is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = ravel(cfg, init_unconstrained(cfg, data, gen,
                                          batch_shape=(R,))).contiguous()
        eps = t(np.exp(rng.uniform(-9.0, -7.0, R)))
        m_inv = t(np.exp(rng.uniform(-1.0, 1.0, (R, spec.D))))
    else:
        q = t(state["state_q"].reshape(R, spec.D))
        eps = t(state["state_step_size"].reshape(R))
        m_inv = t(state["state_inv_mass"].reshape(R, spec.D))
    lp, g = flat_value_and_grad(spec, sh.A, sh.L, sh.vecs, sh.scal, q, tgt)
    p0 = t(rng.standard_normal((R, spec.D))) / torch.sqrt(m_inv)
    u_sel = t(rng.uniform(size=(n_leap, R)))
    j_seed = int(rng.integers(0, n_leap + 1))
    j = j_seed if j is None else j
    return (spec, n_leap, 1000.0, sh, q, p0.contiguous(), g.contiguous(),
            lp.contiguous(), eps, m_inv, tgt, j, u_sel)


def phase_traj_f64(card):
    """The kernel against the plain trajectory in float64 from random-init
    rows: every output within rtol 1e-9 (no selection flips in float64).
    Cases: the main path's R with the seed's split j; a ragged R (4,092
    rows, not a multiple of the rows a block); j = 0 (no backward leg);
    j = n_leap (no forward leg); the SWEEPS shapes, the wide tile's with a
    ragged R. Then the wide tile in float32, every live leaf taken, and
    the float32 times of the two-pass and wide tiles."""
    import torch
    from bayes_drt_tpu_torch.infer.shmc_flat import _traj_plain, traj_fused
    R = B * CHAINS
    cases = [(R, None, None), (R - CHAINS, None, None), (R, 0, None),
             (R, N_STEPS, None)]
    cases += [(R - CHAINS if name == "n121_K141" else R, None,
               np.logspace(*grid)) for name, grid in SWEEPS.items()]
    for rows, j, freq in cases:
        args = traj_inputs(torch.float64, R=rows, j=j, freq=freq)
        spec = args[0]
        where = f"R={rows}, j={args[11]}, n={spec.n}, K={spec.K}"
        got = traj_fused(*args)
        want = _traj_plain(*args)
        torch.cuda.synchronize()
        for nm, a, b in zip(["q", "logp", "grad", "kin", "sacc"], got, want):
            check_close(f"traj f64 {nm} ({where})", a, b, 1e-9, 1e-9)
        if not torch.equal(got[5], want[5]):
            raise AssertionError(f"traj f64 ({where}): divergence flags "
                                 "differ")
        print(f"traj: f64 every output within rtol/atol 1e-9 at {where} "
              f"n_leap={args[1]} ({int(got[5].sum())} rows diverged in "
              f"both)")
    # float32: from random init logp is ~1e6, so float32 rounds H to ~0.1
    # and multinomial near-ties would flip selections; with u_sel = 0 every
    # live leaf is taken (log 0 = -inf), so the selection has no ties
    args = traj_inputs(torch.float32, R=R,
                       freq=np.logspace(*SWEEPS["n121_K141"]))
    args = args[:12] + (torch.zeros_like(args[12]),)
    got = traj_fused(*args)
    want = _traj_plain(*args)
    ok, counts = traj_f32_rows(got, want)
    print(f"traj: f32 wide tile (n={args[0].n}, K={args[0].K}, R={R}, "
          f"u_sel = 0): {int(ok.sum())}/{R} rows agree; outside by output "
          f"{counts}")
    if int((~ok).sum()) > 0.001 * R:
        raise AssertionError(f"traj f32 wide tile: {int((~ok).sum())} of "
                             f"{R} rows differ")
    # float32 times of the tiles the long sweeps take, beside their bound
    for name in ("n91_K111", "n121_K141"):
        args = traj_inputs(torch.float32, R=R,
                           freq=np.logspace(*SWEEPS[name]))
        ms = cuda_ms(lambda: traj_fused(*args), 5)
        ops_s = traj_bound_s(args[0], R, N_STEPS)[0]
        print(f"traj: f32 {name}: kernel {ms:.3f} ms per launch at R={R} "
              f"n_leap={N_STEPS}; bound {1e3 * ops_s:.3f} ms, kernel at "
              f"{100 * 1e3 * ops_s / ms:.1f}% of it [{card}]")


def traj_bound_s(spec, R, n_leap):
    """The trajectory's float32 bound: (seconds for its FMAs at the fp32
    CUDA-core peak, seconds for its bytes, FMAs a row and leaf)."""
    K, n2, D = spec.K, 2 * spec.n, spec.D
    fma = 2 * n2 * K + 6 * K * K
    ops_s = 2.0 * R * n_leap * fma / PEAK_FP32_S
    nbytes = 4.0 * (R * (4 * D + n2 + 2) + n_leap * R + n2 * K + 3 * K * K
                    + 3 * n2 + 8 + R * (2 * D + 4))
    return ops_s, nbytes / PEAK_BYTES_S, fma


def args_f64(args):
    """traj_fused arguments in float64 (the shared matrices rebuilt)."""
    import torch
    from bayes_drt_tpu_torch.infer.shmc_flat import make_flat_shared
    sh = args[3]
    sh64 = make_flat_shared(sh.A.double(), sh.L.double(), sh.vecs.double(),
                            sh.scal.double())
    a64 = [a.double() if isinstance(a, torch.Tensor) else a for a in args]
    a64[3] = sh64
    return tuple(a64)


def traj_f32_rows(got, want):
    """Rows where float32 kernel and plain trajectory agree: the selected
    q and kinetic energy within rtol/atol 1e-4 and the divergence flag
    equal. Returns (mask, count of rows outside by output)."""
    import torch
    R = got[0].shape[0]
    ok = torch.ones(R, dtype=torch.bool, device=got[0].device)
    counts = {}
    for name, i in (("q", 0), ("kin", 3)):
        close = (got[i] - want[i]).abs() <= 1e-4 + 1e-4 * want[i].abs()
        close = close.reshape(R, -1).all(dim=1)
        counts[name] = int((~close).sum())
        ok &= close
    same = got[5] == want[5]
    counts["diverging"] = int((~same).sum())
    return ok & same, counts


def phase_traj_f32(card, state):
    """The kernel against the plain trajectory in float32 at the main
    path's final sampler states. The selected q and kinetic energy must
    be within rtol/atol 1e-4 on >= 99.9% of rows (a multinomial near-tie
    can flip a selection) and the divergence flags equal everywhere.
    logp, grad and the accept sum carry sums of terms up to ~1e3 in size
    that cancel near the mode, so float32 rounding leaves them ~1e-3 off in
    either summation order; they are held to float64 references, and the
    kernel's largest error must not exceed twice the plain version's."""
    import torch
    from bayes_drt_tpu_torch.infer.shmc_flat import (_traj_plain,
                                                     flat_value_and_grad,
                                                     traj_fused)
    args = traj_inputs(torch.float32, state)
    got = traj_fused(*args)
    want = _traj_plain(*args)
    torch.cuda.synchronize()
    R = args[4].shape[0]
    ok, counts = traj_f32_rows(got, want)
    n_diff = int((~ok).sum())
    flags_equal = counts.pop("diverging") == 0
    # float64 references: logp/grad evaluated at each version's selected
    # point, sacc from the plain trajectory on the same inputs in float64
    # (the accept sum does not depend on the selection)
    a64 = args_f64(args)
    spec, sh64, tgt64 = a64[0], a64[3], a64[10]
    sacc64 = _traj_plain(*a64)[4]
    errs = {}
    for who, out in (("kernel", got), ("plain", want)):
        lp64, g64 = flat_value_and_grad(spec, sh64.A, sh64.L, sh64.vecs,
                                        sh64.scal, out[0].double(), tgt64)
        errs[who] = (float((out[1].double() - lp64).abs()[ok].max()),
                     float((out[2].double() - g64).abs()[ok].max()),
                     float((out[4].double() - sacc64).abs().max()))
    print(f"traj f32: rows outside rtol/atol 1e-4 by output {counts}; "
          f"flags equal {flags_equal}; max error vs float64 (logp, grad, "
          f"sacc): {errs}")
    if n_diff > 0.001 * R or not flags_equal:
        raise AssertionError(f"traj f32: {n_diff} of {R} rows differ")
    for k, name in enumerate(("logp", "grad", "sacc")):
        if errs["kernel"][k] > 2.0 * errs["plain"][k] + 1e-6:
            raise AssertionError(
                f"traj f32 {name}: kernel error {errs['kernel'][k]:.3e} vs "
                f"plain {errs['plain'][k]:.3e} against float64")
    per_out = {}
    for name, a, b in zip(("q", "logp", "grad", "kin", "sacc"), got[:5],
                          want[:5]):
        err = (a - b).abs().reshape(R, -1)[ok]
        at = int(err.argmax())
        per_out[name] = (float(err.max()),
                         float(b.reshape(R, -1)[ok].flatten()[at].abs()))
    print(f"traj f32: max |kernel - plain| on agreeing rows, with |plain| "
          f"there: {per_out}")
    max_err = max(e for e, _ in per_out.values())
    ms = cuda_ms(lambda: traj_fused(*args), 10)
    plain_ms = cuda_ms(lambda: _traj_plain(*args), 2)
    spec, n_leap = args[0], args[1]
    D = spec.D
    ops_s, bytes_s, fma = traj_bound_s(spec, R, n_leap)
    print(f"traj: f32 {R - n_diff}/{R} rows agree (q, kin within rtol/atol "
          f"1e-4), divergence flags equal; max error vs float64 "
          f"logp/grad/sacc: kernel {errs['kernel'][0]:.2e}/"
          f"{errs['kernel'][1]:.2e}/{errs['kernel'][2]:.2e}, plain "
          f"{errs['plain'][0]:.2e}/{errs['plain'][1]:.2e}/"
          f"{errs['plain'][2]:.2e}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms per launch at R={R} D={D} "
          f"n_leap={n_leap}; bound {1e3 * ops_s:.3f} ms ({fma} "
          f"FMA/row/leaf on fp32 CUDA cores), kernel at "
          f"{100 * 1e3 * ops_s / ms:.1f}% of it [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                bound_ms=1e3 * max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes")


def phase_main(card):
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.matrices import get_tau_basis
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import evaluate_gamma, fit_spectra_batch
    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     eps_quantile=EPS_QUANTILE)
    drt_quad.launches = 0
    traj_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_spectra_batch(freq, Zb, mode="sample", chains=CHAINS,
                            warmup=WARMUP, samples=SAMPLES, random_seed=1,
                            ncp=True, sampler="shmc", shmc_cfg=cfg,
                            gamma_eval_tau=tau, escalate=False,
                            dtype=np.float32, timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    if launches != {"quad": 2, "traj": WARMUP + SAMPLES}:
        raise AssertionError(f"main path launch counts {launches}, expected "
                             f"quad 2, traj {WARMUP + SAMPLES}")
    d = res.diagnostics
    g = evaluate_gamma(res, tau)
    rmse = float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2)))
    per = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    p90 = float(np.percentile(per, 90))
    cov = float(np.mean((gt[None, :] >= d["gamma_eval_lo"])
                        & (gt[None, :] <= d["gamma_eval_hi"])))
    ess_med = float(np.median(d["min_ess"]))
    ess_bulk_p10 = float(np.percentile(d["ess_bulk_min"], 10))
    rhat_med = float(np.median(d["logp_rhat"]))
    div = float(np.mean(d["divergence_rate"]))
    traj_ms = np.asarray(d["traj_ms"])
    for name, arr in (("coef", res.coef), ("gamma_lo", res.gamma_lo),
                      ("gamma_hi", res.gamma_hi)):
        if arr.shape != (B, len(tau)) or not np.isfinite(arr).all():
            raise AssertionError(f"main path {name}: bad shape or values")
    gates = {"rmse": bool(rmse < GATE_RMSE * rp),
             "p90": bool(p90 < GATE_P90 * rp),
             "coverage": bool(cov > GATE_COVERAGE),
             "min_ess_med": bool(ess_med > GATE_MIN_ESS),
             "logp_rhat_med": bool(rhat_med < GATE_LOGP_RHAT)}
    summary = {
        "B": B, "wall_s": wall, "spectra_per_min": B / (wall / 60.0),
        "traj_ms_per_draw_median": float(np.median(traj_ms)),
        "traj_ms_total": float(traj_ms.sum()), "phase_s": d["phase_s"],
        "rmse_over_rp": rmse / rp, "p90_over_rp": p90 / rp,
        "coverage": cov, "min_ess_median": ess_med,
        "ess_bulk_min_p10": ess_bulk_p10, "logp_rhat_median": rhat_med,
        "divergence_rate": div, "gates": gates, "launches": launches,
        "card": card}
    print("main path: " + json.dumps(summary))
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise AssertionError(f"main path quality gates failed: {failed}")
    return launches, {k: d[k] for k in ("state_q", "state_inv_mass",
                                        "state_step_size")}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from bayes_drt_tpu_torch import _build
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
          "(nvcc, sm_90a, in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    quad = phase_quad(card)
    phase_traj_f64(card)
    if "--check-only" in argv:
        return 0
    launches, state = phase_main(card)
    traj = phase_traj_f32(card, state)
    kernels = [
        dict(name="drt_quad", route="cuda",
             source="bayes_drt_tpu_torch/csrc/quad.cu",
             replaces="bayes_drt_tpu/ops/pallas_quad.py:57",
             launches=launches["quad"], library_ms=None, **quad),
        dict(name="traj_fused", route="cuda",
             source="bayes_drt_tpu_torch/csrc/traj.cu",
             replaces="bayes_drt_tpu/infer/shmc_flat.py:414",
             launches=launches["traj"], library_ms=None, **traj),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
