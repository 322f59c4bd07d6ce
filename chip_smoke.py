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
     the default escalation (the gate, then a ridge-seeded NUTS refit of
     any flagged spectra), the five quality gates of the JAX package's
     bench and the launch counts (2 quadrature launches, 4 more when a
     refit runs: its ridge and its setup; 400 trajectory launches).
  5. the trajectory kernel against the plain trajectory in float32 at the
     main path's final sampler states, and its time per launch.
  6. the escalation path at full width: B=64 noisy ZARC spectra through
     the same SHMC fit with every spectrum forced through the refit (NUTS
     max_depth=8, tree_scan, seeded from the batched hyper-lambda ridge);
     the splice, the gate figures of the 64 and the seconds of the ridge,
     the NUTS draws and the call.
  7. the default call, fit_spectra_batch(freq, Z) with no sampler
     arguments (NUTS max_depth 10, escalation on) on the main path's 1024
     spectra at a budget cut to 4 x (60 + 20): shape, values, mask,
     launches, and the seconds of the call, of a warmup draw and of a
     draw after warmup.
  8. NUTS draw times from the main path's final states at R=256 and
     R=4096 rows, eager and replayed as CUDA graphs: max_depth 8 static
     (the refit's tree_scan) and max_depth 10 with the early stop (the
     default NUTS path).
  9. device parity in float64: the batched ridge on 8 spectra and one NUTS
     transition (R=4096, D=211, max_depth=8; on the card replayed as CUDA
     graphs, as sample_nuts runs it there) against the CPU.
  10. MAP: fit_spectra_batch(mode="optimize") on the main path's 1024
     spectra in the default form (2 restarts, so 2048 L-BFGS rows, capped
     at 2000 iterations, then the Newton polish) and in the production
     form (ridge seed, cap 1500, polish), each gated on finite
     coefficients, batch-mean gamma RMSE and per-spectrum p90; their
     seconds, seconds per L-BFGS iteration and certificates;
     predict_Z_batch at the training grid and a 2x denser one; then
     float64 card-vs-CPU parity of run_lbfgs and newton_polish on 8
     spectra from the same numpy-made starts.
  11. the Series-Parallel configuration of the extended sweep (DRT +
     TP-DDT, x_scale 0.8, basis logspace(6, -2, 81) each, N=81, D=336,
     nonneg): MAP on 1024 spectra in the default form and NUTS md8
     (tree_scan, ncp) on 256 of them at 4 x (100 + 100), both through the
     autograd value and gradient replayed as CUDA graphs, gated on finite
     coefficients, the median impedance residual against the noiseless
     spectrum (<= 0.02), the median divergence rate (< 0.05) and the DRT
     part's RMSE (<= 1.5x the JAX package's MAP figure); two B=64 MAP fits
     (a single parallel blocking DDT; a ridge-seeded series DRT with
     outliers on spectra with three corrupted frequencies); the polish's
     Hessian and solve at D=336; float64 card-vs-CPU parity of the DDT A
     matrices, the autograd value and gradient and one NUTS transition.
  12. one JSON line listing both kernels with their launches (phases 4,
     6, 7, 10 and 11) and times; K2's bound counts the function's least
     fp64 work a node, and the count its compiled loop issues (cuobjdump
     -sass) is printed beside it.
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
# the escalation phase: spectra, and its budget (the bench's unless cut to
# keep the smoke's time; a cut is printed)
B_ESC = 64
ESC_WARMUP = WARMUP
ESC_SAMPLES = SAMPLES
NUTS_DEPTH = 8            # the refit's max_tree_depth
# the default call's phase: the main path's B, and a budget cut from the
# default 4 x (500 + 500) to keep the smoke's time
B_DEFAULT = B
DEFAULT_WARMUP = 60
DEFAULT_SAMPLES = 20

# the MAP phase: the default form's caps and restarts, the production
# form's cap, its gates (of Rp; p90 is the JAX MAP tests' per-spectrum
# bar) and the float64 parity's spectra and caps (the short cap holds
# the iterates themselves: L-BFGS amplifies the two devices' last-bit
# differences by ~1e2 every 10 iterations on this posterior)
MAP_ITER = 2000
MAP_RESTARTS = 2
MAP_RIDGE_ITER = 1500
MAP_GATE_RMSE = 0.03
MAP_GATE_P90 = 0.08
MAP_PARITY_B = 8
MAP_PARITY_ITER = 200
MAP_PARITY_SHORT = 25

# the Series-Parallel phase: DRT + TP-DDT (x_scale 0.8) of the extended
# sweep (benchmarks/paper_batch_ext.py:84-90), both on the basis
# logspace(6, -2, 81), nonneg, sigma_min 0.002; MAP at B=1024 in the
# default form, NUTS at B=256 with the sweep's settings (md8, tree_scan,
# ncp, no escalation) at a budget cut from 4 x (500 + 500); the two small
# B=64 MAP fits with their L-BFGS cap cut from 2000 (restarts) and 1500
# (ridge seed)
SP_SEED = 11
SP_B_MAP = 1024
SP_B_SAMPLE = 256
SP_WARMUP = 100
SP_SAMPLES = 100
SP_DEPTH = 8
SP_B_SMALL = 64
SP_SMALL_ITER = 1000
SP_GATE_Z = 0.02          # median |Z_hat - Z_true| / |Z_true|
SP_GATE_DIV = 0.05        # median divergence rate
# the JAX package's own MAP recovery of the DRT part on the first 8 of
# these spectra (mean per-spectrum RMSE, Rp = 1; float64 on the CPU, by
# scripts/jax_series_parallel_reference.py), and the bar, 1.5x of it
SP_JAX_DRT_RMSE = 0.022847870434669106
SP_GATE_DRT_RMSE = 1.5 * SP_JAX_DRT_RMSE

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP64_S = 34e12
# instructions that issue to the fp64 pipe (counted in K2's compiled loop)
FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")
# K2's least fp64-pipe work a node. The exps leave the node loop, since
# exp(+-(y_q + s)) = exp(+-y_q) exp(+-s): 2 (Q + N K) exps a call, under
# 0.4% of the nodes' work at the main path's shapes, left out. The
# imaginary part, -e / (1 + e^2) with e = min(e^y e^s, e^-y e^-s): 2 DMUL,
# 1 DMNMX, 1 DFMA (1 + e^2), one IEEE divide (7 DFMA and 1 DMUL refine its
# MUFU.RCP64H seed) and 1 DFMA into the sum. The real part, 1 / (1 +
# clip(e^2y e^2s, e^-80, e^80)): 1 DMUL, 2 DMNMX, 1 DADD, the divide and
# 1 DFMA. 13 either way.
QUAD_FP64_MIN_PER_NODE = 13
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


def sass_loop_counts(sass, kernel):
    """Instruction counts of the innermost node loop of ``kernel`` (a
    substring of its mangled name) in ``cuobjdump -sass`` text: the
    shortest backward branch's body that holds an MUFU.RCP64H (one per
    IEEE fp64 divide, so one per quadrature node); the grid-stride loop
    around it also holds the per-output reduction. Returns (nodes a trip,
    fp64-pipe instructions a trip, other fp64 conversions a trip)."""
    import re
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:] if kernel in f.split()[0]), None)
    if body is None:
        raise AssertionError(f"cuobjdump: no function matching {kernel}")
    instrs, labels = [], {}
    pending = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        text = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
        instrs.append((addr, text))
    best = None
    for addr, text in instrs:
        if not text.startswith("BRA"):
            continue
        t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", text)
        if t is None:
            continue
        tgt = (labels.get(t.group(1)) if t.group(1).startswith(".L")
               else int(t.group(1), 16))
        if tgt is None or tgt >= addr:
            continue
        loop = [x for a, x in instrs if tgt <= a <= addr]
        nodes = sum(x.startswith("MUFU.RCP64H") for x in loop)
        if nodes and (best is None or len(loop) < best[3]):
            fp64 = sum(x.split()[0].split(".")[0] in FP64_OPS for x in loop)
            conv = sum(x.split()[0].split(".")[0] in ("F2F", "F2I", "I2F")
                       and "F64" in x.split()[0] for x in loop)
            best = (nodes, fp64, conv, len(loop))
    if best is None:
        raise AssertionError(f"cuobjdump: no loop with an fp64 divide in "
                             f"{kernel}")
    return best[:3]


def quad_fp64_per_node():
    """fp64-pipe instructions a node of K2's float64 loops, read from the
    built library with cuobjdump -sass; prints both parts' counts and
    returns the imaginary part's (the one timed)."""
    import shutil
    from bayes_drt_tpu_torch import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.lib_path("quad"))],
                          capture_output=True, text=True, check=True).stdout
    per = {}
    for part, tag in (("real", "drt_quad_kernelIdLb0E"),
                      ("imag", "drt_quad_kernelIdLb1E")):
        nodes, fp64, conv = sass_loop_counts(sass, tag)
        per[part] = fp64 / nodes
        print(f"quad sass: f64 {part} loop: {nodes} nodes a trip, {fp64} "
              f"fp64-pipe instructions ({', '.join(FP64_OPS)}), {conv} "
              f"fp64 conversions: {per[part]:.2f} a node")
    return per["imag"]


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
    # bound: the function's least fp64-pipe work a node, at one instruction
    # per fp64 unit and clock (half the FMA flop rate); the compiled loop's
    # count is printed beside it
    compiled = quad_fp64_per_node()
    ops_s = n * k * q * QUAD_FP64_MIN_PER_NODE / (PEAK_FP64_S / 2)
    bytes_s = 8.0 * (2 * n * k + 2 * q) / PEAK_BYTES_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    print(f"quad: f64 within rtol 1e-10, f32 within rtol 2e-4/atol 1e-5 of "
          f"f64 (Q=1000 and 1024); kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms per call at N={n} K={k} Q={q} float64; bound "
          f"{bound_ms:.4f} ms ({QUAD_FP64_MIN_PER_NODE} fp64 instructions a "
          f"node, the function's least; the compiled loop issues "
          f"{compiled:.2f}), kernel at {100 * bound_ms / ms:.1f}% of it "
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
    _, _, _, cfg, data, _ = _build_shared(freq, ncp=True, dtype=dtype,
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
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
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
                            gamma_eval_tau=tau, dtype=np.float32,
                            timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    d = res.diagnostics
    rmse, p90, cov = gamma_figures(res, tau, gt, rp)
    flagged = int(d["escalated"].sum())
    want = {"quad": 2 + (4 if flagged else 0), "traj": WARMUP + SAMPLES}
    if launches != want:
        raise AssertionError(f"main path launch counts {launches}, expected "
                             f"{want} ({flagged} spectra refitted)")
    ess_med = float(np.median(d["min_ess"]))
    ess_bulk_p10 = float(np.percentile(d["ess_bulk_min"], 10))
    rhat_med = float(np.median(d["logp_rhat"]))
    div = float(np.mean(d["divergence_rate"]))
    traj_ms = np.asarray(d["traj_ms"])
    for name, arr in (("coef", res.coef), ("gamma_lo", res.gamma_lo),
                      ("gamma_hi", res.gamma_hi)):
        if arr.shape != (B, len(tau)) or not np.isfinite(arr).all():
            raise AssertionError(f"main path {name}: bad shape or values")
    gates = {"rmse": bool(rmse < GATE_RMSE),
             "p90": bool(p90 < GATE_P90),
             "coverage": bool(cov > GATE_COVERAGE),
             "min_ess_med": bool(ess_med > GATE_MIN_ESS),
             "logp_rhat_med": bool(rhat_med < GATE_LOGP_RHAT)}
    summary = {
        "B": B, "wall_s": wall, "spectra_per_min": B / (wall / 60.0),
        "traj_ms_per_draw_median": float(np.median(traj_ms)),
        "traj_ms_total": float(traj_ms.sum()), "phase_s": d["phase_s"],
        "rmse_over_rp": rmse, "p90_over_rp": p90,
        "coverage": cov, "min_ess_median": ess_med,
        "ess_bulk_min_p10": ess_bulk_p10, "logp_rhat_median": rhat_med,
        "divergence_rate": div, "escalated": flagged,
        "refit_s": d.get("refit_s"), "gates": gates, "launches": launches,
        "card": card}
    print("main path: " + json.dumps(summary))
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise AssertionError(f"main path quality gates failed: {failed}")
    return launches, {k: d[k] for k in ("state_q", "state_inv_mass",
                                        "state_step_size")}


def gamma_figures(res, tau, gt, rp):
    """(RMSE of the batch-mean gamma, p90 of per-spectrum RMSE, both over
    Rp; pointwise band coverage) of a fit with gamma_eval_tau=tau."""
    from bayes_drt_tpu_torch.parallel import evaluate_gamma
    d = res.diagnostics
    g = evaluate_gamma(res, tau)
    rmse = float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2)))
    per = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    cov = float(np.mean((gt[None, :] >= d["gamma_eval_lo"])
                        & (gt[None, :] <= d["gamma_eval_hi"])))
    return rmse / rp, float(np.percentile(per, 90)) / rp, cov


def phase_escalation(card):
    """The escalation path at full width: B_ESC spectra through the main
    path's SHMC fit with the gate forced to flag every spectrum, so all of
    them are refitted by NUTS (max_depth 8, tree_scan) from the batched
    ridge seed and spliced back. Checks the mask, that every spliced row
    is the refit's, the launch counts and the gates on RMSE, p90 and
    coverage."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.matrices import get_tau_basis
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import batch
    if (ESC_WARMUP, ESC_SAMPLES) != (WARMUP, SAMPLES):
        print(f"escalation: budget cut to {CHAINS}x({ESC_WARMUP}+"
              f"{ESC_SAMPLES}) from {CHAINS}x({WARMUP}+{SAMPLES})")
    freq, Zb = sim.make_benchmark_batch(B_ESC, circuit="ZARC",
                                        noise_level=0.0025, seed=2)
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     eps_quantile=EPS_QUANTILE)
    seen = {}
    splice = batch._splice_results

    def spy(result, sub, mask):
        seen.update(result=result, sub=sub, mask=mask)
        return splice(result, sub, mask)

    batch._splice_results = spy
    try:
        drt_quad.launches = 0
        traj_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batch.fit_spectra_batch(
            freq, Zb, mode="sample", chains=CHAINS, warmup=ESC_WARMUP,
            samples=ESC_SAMPLES, random_seed=3, ncp=True, sampler="shmc",
            shmc_cfg=cfg, gamma_eval_tau=tau, dtype=np.float32,
            escalate_gate=dict(ess_bulk_min=np.inf), timing=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        batch._splice_results = splice
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    want = {"quad": 6, "traj": ESC_WARMUP + ESC_SAMPLES}
    if launches != want:
        raise AssertionError(f"escalation launch counts {launches}, "
                             f"expected {want}")
    d, sub = res.diagnostics, seen["sub"]
    if not (d["escalated"].all() and seen["mask"].all()):
        raise AssertionError("escalation: not every spectrum was refitted")
    for name in ("coef", "r_inf", "inductance", "gamma_lo", "gamma_hi"):
        if not np.array_equal(getattr(res, name), getattr(sub, name)):
            raise AssertionError(f"escalation: spliced {name} is not the "
                                 "refit's")
    for k in ("gamma_eval_lo", "gamma_eval_hi", "ess_bulk_min",
              "n_leapfrog"):
        if not np.array_equal(d[k], sub.diagnostics[k]):
            raise AssertionError(f"escalation: spliced {k} is not the "
                                 "refit's")
    rmse, p90, cov = gamma_figures(res, tau, gt, rp)
    sd = sub.diagnostics
    draw_s = np.asarray(sd["draw_s"])
    summary = {
        "B": B_ESC, "budget": [CHAINS, ESC_WARMUP, ESC_SAMPLES],
        "wall_s": wall, "refit_s": d["refit_s"],
        "ridge_s": sd["phase_s"]["ridge"],
        "refit_phase_s": sd["phase_s"],
        "nuts_draw_s_median": float(np.median(draw_s)),
        "nuts_draw_s_total": float(draw_s.sum()),
        "rmse_over_rp": rmse, "p90_over_rp": p90, "coverage": cov,
        "divergence_rate": float(np.mean(d["divergence_rate"])),
        "n_leapfrog_mean": float(np.mean(d["n_leapfrog"])),
        "ess_bulk_min_median": float(np.median(d["ess_bulk_min"])),
        "launches": launches, "card": card}
    print("escalation: " + json.dumps(summary))
    gates = {"rmse": rmse < GATE_RMSE, "p90": p90 < GATE_P90,
             "coverage": cov > GATE_COVERAGE}
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise AssertionError(f"escalation quality gates failed: {failed}")
    return launches


def phase_default(card):
    """The default call, fit_spectra_batch(freq, Z) with no sampler
    arguments: NUTS max_depth 10 (the early stop replayed as CUDA graphs)
    with the default escalation, on B_DEFAULT spectra (R = 4096 rows) at
    a cut budget. Checks the result's shape and values, the recorded mask
    and the launch counts; prints its seconds, the median seconds of a
    warmup draw and of a draw after warmup, and its figures (no quality
    gate at this budget)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.matrices import get_tau_basis
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    print(f"default call: budget cut to {CHAINS}x({DEFAULT_WARMUP}+"
          f"{DEFAULT_SAMPLES}) from {CHAINS}x(500+500)")
    freq, Zb = sim.make_benchmark_batch(B_DEFAULT, circuit="ZARC",
                                        noise_level=0.0025, seed=6)
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    drt_quad.launches = 0
    traj_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_spectra_batch(freq, Zb, warmup=DEFAULT_WARMUP,
                            samples=DEFAULT_SAMPLES, gamma_eval_tau=tau,
                            timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = res.diagnostics
    flagged = int(d["escalated"].sum())
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    want = {"quad": 2 + (4 if flagged else 0), "traj": 0}
    if launches != want:
        raise AssertionError(f"default call launch counts {launches}, "
                             f"expected {want}")
    if res.coef.shape != (B_DEFAULT, len(tau)) or not np.isfinite(
            res.coef).all():
        raise AssertionError("default call: bad coefficients")
    rmse, p90, cov = gamma_figures(res, tau, gt, rp)
    draw_s = np.asarray(d["draw_s"])
    print("default call: " + json.dumps({
        "B": B_DEFAULT, "budget": [CHAINS, DEFAULT_WARMUP, DEFAULT_SAMPLES],
        "max_tree_depth": 10, "wall_s": wall, "phase_s": d["phase_s"],
        "nuts_draw_s_first": float(draw_s[0]),
        "nuts_warmup_draw_s_median": float(np.median(
            draw_s[1:DEFAULT_WARMUP])),
        "nuts_sample_draw_s_median": float(np.median(
            draw_s[DEFAULT_WARMUP:])),
        "n_leapfrog_mean": float(np.mean(d["n_leapfrog"])),
        "escalated": flagged, "refit_s": d.get("refit_s"),
        "rmse_over_rp": rmse, "p90_over_rp": p90, "coverage": cov,
        "launches": launches, "card": card}))
    return launches


def nuts_rows(dtype, state, R, device="cuda"):
    """The first R of the main path's final chain states as NUTS rows:
    (value_and_grad, q, logp, grad, eps, m_inv) on ``device``."""
    import torch
    from bayes_drt_tpu_torch.infer.shmc_flat import flat_value_and_grad
    args = traj_inputs(dtype, state)
    spec, sh, tgt = args[0], args[3], args[10]
    if device != "cuda":
        from bayes_drt_tpu_torch.infer.shmc_flat import make_flat_shared
        sh = make_flat_shared(*(t.to(device) for t in (sh.A, sh.L, sh.vecs,
                                                       sh.scal)))
    tgt = tgt[:R].to(device)

    def vg(q):
        return flat_value_and_grad(spec, sh.A, sh.L, sh.vecs, sh.scal, q,
                                   tgt)

    q = args[4][:R].to(device)
    lp, g = vg(q)
    return vg, q, lp, g, args[8][:R].to(device), args[9][:R].to(device)


def nuts_noise_np(R, D, depth, seed, dtype, device):
    """One draw's NUTSNoise from a numpy seed."""
    import torch
    from bayes_drt_tpu_torch.infer.nuts import NUTSNoise
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=device)

    return NUTSNoise(z=t(rng.standard_normal((R, D))).to(dtype),
                     go_right=t(rng.uniform(size=(depth, R)) < 0.5),
                     swap_u=t(rng.uniform(size=(depth, R))).to(dtype),
                     leaf_u=t(rng.uniform(size=((1 << depth) - 1,
                                                R))).to(dtype))


def phase_nuts_timing(card, state):
    """Seconds per NUTS draw in float32 from the main path's final states
    at R=256 and R=4096 rows, eager and replayed as CUDA graphs: max_depth
    8 with the static tree (the refit's form) and max_depth 10 stopping
    once no row is alive (the default NUTS path's form). The graphs'
    outputs must equal the eager ones on the same inputs."""
    import torch
    from bayes_drt_tpu_torch.infer.nuts import (GraphedTree,
                                                nuts_transition_flat)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps, res

    out = {}
    for R in (256, B * CHAINS):
        vg, q, lp, g, eps, m_inv = nuts_rows(torch.float32, state, R)
        for depth, scan in ((NUTS_DEPTH, True), (10, False)):
            noise = nuts_noise_np(R, q.shape[1], depth, 5, torch.float32,
                                  "cuda")
            e_s, e_out = timed(lambda: nuts_transition_flat(
                vg, q, lp, g, noise, eps, m_inv, max_depth=depth,
                tree_scan=scan), 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = GraphedTree(vg, q, lp, g, noise, eps, m_inv, depth,
                               1000.0, early_stop=not scan)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            g_s, g_out = timed(lambda: tree(q, lp, g, noise, eps, m_inv), 3)
            same = all(torch.equal(a, b) for a, b in
                       zip(e_out[:3] + tuple(e_out[3]),
                           g_out[:3] + tuple(g_out[3])))
            name = f"R{R}_md{depth}_{'static' if scan else 'early_stop'}"
            out[name] = dict(eager_s=e_s, graph_s=g_s, capture_s=capture_s,
                             identical=same, n_leapfrog_mean=float(
                                 e_out[3].n_leapfrog.float().mean()),
                             n_leapfrog_max=int(e_out[3].n_leapfrog.max()))
            del tree
            if not same:
                raise AssertionError(f"nuts {name}: graph replay differs "
                                     "from eager")
    print(f"nuts timing (float32, seconds per draw): {json.dumps(out)} "
          f"[{card}]")


def nuts_transition_parity(card, label, R, depth, seed, rows):
    """One float64 NUTS transition (max_depth ``depth``, noise from numpy
    ``seed``) of the rows ``rows(device)`` gives ((value_and_grad, q, logp,
    grad, eps, m_inv) on that device): on the card replayed as CUDA graphs
    (GraphedTree, the static tree), which must equal the eager early-stop
    form there bit for bit, against eager on the CPU. A row agrees when its
    tree (n_leapfrog, depth, divergence) is the same, its q is within 1e-9
    of the row's largest entry, and its logp and grad are within 1e-9 of
    the CPU's evaluation at the card's own selected point (after up to 255
    leapfrogs the two summation orders leave ~1e-12 relative differences
    in q, which a stiff posterior turns into ~1e-7 in grad; printed).
    Prints every differing row and returns their count."""
    import torch
    from bayes_drt_tpu_torch.infer.nuts import (GraphedTree,
                                                nuts_transition_flat)
    outs = {}
    for dev in ("cuda", "cpu"):
        vg, q, lp, g, eps, m_inv = rows(dev)
        noise = nuts_noise_np(R, q.shape[1], depth, seed, torch.float64, dev)
        t0 = time.perf_counter()
        if dev == "cuda":
            tree = GraphedTree(vg, q, lp, g, noise, eps, m_inv, depth, 1000.0)
            o = tree(q, lp, g, noise, eps, m_inv)
            eager = nuts_transition_flat(vg, q, lp, g, noise, eps, m_inv,
                                         max_depth=depth)
            torch.cuda.synchronize()
            del tree
            flat_o = o[:3] + tuple(o[3])
            flat_e = eager[:3] + tuple(eager[3])
            graph_eager = max(float((a.double() - b.double()).abs().max())
                              for a, b in zip(flat_o, flat_e))
            print(f"{label}: float64 graph replay vs eager on the card, "
                  f"largest difference {graph_eager:.3e}")
            if not all(torch.equal(a, b) for a, b in zip(flat_o, flat_e)):
                raise AssertionError(f"{label}: float64 graph replay "
                                     "differs from eager on the card")
        else:
            o = nuts_transition_flat(vg, q, lp, g, noise, eps, m_inv,
                                     max_depth=depth)
            vg_cpu = vg
        outs[dev] = [t.cpu() for t in o[:3]] + [t.cpu() for t in o[3]]
        print(f"{label}: {dev} transition {time.perf_counter() - t0:.2f} s"
              + (" (capture, replay and eager)" if dev == "cuda" else ""))
    c, h = outs["cuda"], outs["cpu"]
    same = (c[4] == h[4]) & (c[5] == h[5]) & (c[7] == h[7])

    def rel_rows(a, b):
        a, b = a.reshape(R, -1), b.reshape(R, -1)
        scale = torch.clamp(b.abs().max(dim=1).values, min=1.0)
        return (a - b).abs().max(dim=1).values / scale

    direct = [rel_rows(a, b) for a, b in zip(c[:3], h[:3])]
    lp_at, g_at = vg_cpu(c[0])
    rel = {"q": direct[0], "logp": rel_rows(c[1], lp_at),
           "grad": rel_rows(c[2], g_at)}
    for v in rel.values():
        same &= v <= 1e-9
    print(f"{label}: largest relative difference of the two selected "
          "points' q, logp, grad: "
          + ", ".join(f"{float(v.max()):.2e}" for v in direct))
    bad = torch.nonzero(~same).flatten().tolist()
    for r in bad:
        print(f"{label}: row {r} differs: n_leapfrog {int(c[5][r])}/"
              f"{int(h[5][r])}, depth {int(c[7][r])}/{int(h[7][r])}, "
              f"diverging {bool(c[4][r])}/{bool(h[4][r])}, relative error "
              + ", ".join(f"{k} {float(v[r]):.1e}" for k, v in rel.items()))
    print(f"{label}: largest relative error over rows (q; logp, grad at the "
          "card's point): "
          + ", ".join(f"{float(v.max()):.2e}" for v in rel.values()))
    print(f"{label}: {R - len(bad)}/{R} rows identical in tree and within "
          f"1e-9 (float64, md{depth}; mean n_leapfrog "
          f"{float(h[5].float().mean()):.1f}) [{card}]")
    return len(bad)


def phase_parity(card, state):
    """float64 on the card against the port on the CPU: the batched ridge
    on 8 spectra (coefficients within rtol 1e-8 of each spectrum's
    largest, iteration counts equal) and one NUTS transition at R=4096,
    D=211, max_depth 8 with the same noise, on the card as CUDA graphs
    (GraphedTree, the refit's static form, equal bit for bit to the eager
    form there) and on the CPU eagerly: n_leapfrog, depth and divergence
    identical, q within 1e-9 of the row's largest entry, and logp and grad
    within 1e-9 of the CPU's evaluation at the card's point, on at least
    99.9% of rows; every differing row is printed."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.parallel import ridge_fit_spectra_batch
    torch.set_num_threads(8)
    freq, Zb = sim.make_benchmark_batch(8, circuit="ZARC",
                                        noise_level=0.0025, seed=4)
    kw = dict(penalty="integral", hyper_lambda=True, lambda_0=1.0,
              hl_beta=5, weights="modulus", dtype=torch.float64)
    t0 = time.perf_counter()
    on_card = ridge_fit_spectra_batch(freq, Zb, device="cuda", **kw)
    card_s = time.perf_counter() - t0
    on_cpu = ridge_fit_spectra_batch(freq, Zb, device="cpu", **kw)
    full = lambda r: np.concatenate([r.coef, r.r_inf[:, None],
                                     r.inductance[:, None]], axis=1)
    a, b = full(on_card), full(on_cpu)
    scale = np.abs(b).max(axis=1, keepdims=True)
    rel = float((np.abs(a - b) / scale).max())
    it_a, it_b = on_card.diagnostics["n_iter"], on_cpu.diagnostics["n_iter"]
    print(f"parity ridge: 8 spectra float64, max |card - cpu| / max|coef| "
          f"{rel:.3e}, iterations card {it_a.tolist()} cpu {it_b.tolist()}"
          f"; card {card_s:.3f} s")
    if rel > 1e-8 or not np.array_equal(it_a, it_b):
        raise AssertionError("parity ridge: card and CPU differ")

    R = B * CHAINS
    bad = nuts_transition_parity(
        card, "parity nuts", R, NUTS_DEPTH, 6,
        lambda dev: nuts_rows(torch.float64, state, R, dev))
    if bad > 0.001 * R:
        raise AssertionError(f"parity nuts: {bad} of {R} rows differ")


def map_figures(res, tau, gt, rp):
    """(RMSE of the batch-mean gamma, p90 of per-spectrum RMSE), of Rp."""
    from bayes_drt_tpu_torch.parallel import evaluate_gamma
    g = evaluate_gamma(res, tau)
    rmse = float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2)))
    per = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    return rmse / float(rp), float(np.percentile(per, 90) / rp)


def phase_map(card):
    """MAP on the main path's 1024 spectra: (a) the default call
    fit_spectra_batch(freq, Z, mode="optimize") (2 restarts, 2048 L-BFGS
    rows, cap 2000, polish), (b) the production form (ridge seed, cap
    1500, polish); each gated on finite coefficients of the right shape,
    batch-mean gamma RMSE and per-spectrum p90; (c) predict_Z_batch at
    the training grid and a 2x denser one. Returns the K2 launches,
    checked against what the calls build (A at setup, the ridge's A, A at
    each prediction grid)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.matrices import get_tau_basis
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import batch, predict_Z_batch
    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    forms = {"default": {},
             "ridge": dict(init_from_ridge=True, max_iter=MAP_RIDGE_ITER)}
    out, results = {}, {}
    drt_quad.launches = 0
    traj_fused.launches = 0
    for name, kw in forms.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batch.fit_spectra_batch(freq, Zb, mode="optimize",
                                      timing=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = res
        if res.coef.shape != (B, len(tau)) or not np.isfinite(
                res.coef).all():
            raise AssertionError(f"map {name}: bad coefficients")
        rmse, p90 = map_figures(res, tau, gt, rp)
        d = res.diagnostics
        n_it, n_lbfgs = d["n_iter"], d["n_iter_lbfgs"]
        out[name] = {
            "B": B, "rows": B * (1 if kw else MAP_RESTARTS),
            "max_iter": kw.get("max_iter", MAP_ITER), "wall_s": wall,
            "phase_s": d["phase_s"], "lbfgs_iters": int(n_lbfgs.max()),
            "polish_iters_max": int((n_it - n_lbfgs).max()),
            "s_per_lbfgs_iter": d["phase_s"]["lbfgs"] / float(n_lbfgs.max()),
            "n_iter_q": [float(np.percentile(n_it, q))
                         for q in (0, 10, 50, 90, 100)],
            "converged_share": float(np.mean(d["converged"])),
            "grad_norm_median": float(np.median(d["grad_norm"])),
            "rmse_over_rp": rmse, "p90_over_rp": p90}
        gates = {"rmse": bool(rmse < MAP_GATE_RMSE),
                 "p90": bool(p90 < MAP_GATE_P90)}
        out[name]["gates"] = gates
        print(f"map {name}: " + json.dumps(out[name]) + f" [{card}]")
        failed = [k for k, v in gates.items() if not v]
        if failed:
            raise AssertionError(f"map {name}: gates failed: {failed}")
    res = results["default"]
    z_train = predict_Z_batch(res, freq)
    f_dense = np.logspace(np.log10(freq.max()), np.log10(freq.min()),
                          2 * len(freq) - 1)
    z_dense = predict_Z_batch(res, f_dense)
    if (z_train.shape != Zb.shape or z_dense.shape != (B, len(f_dense))
            or not np.isfinite(z_train).all()
            or not np.isfinite(z_dense).all()):
        raise AssertionError("map predict_Z_batch: bad shape or values")
    resid = float(np.median(np.abs(z_train - Zb) / np.abs(Zb)))
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    # K2: setup; setup and the ridge's A; the two prediction grids
    want = {"quad": 2 + 4 + 4, "traj": 0}
    print(f"map predict_Z_batch: median |Z_hat - Z| / |Z| at the training "
          f"grid {resid:.3e}; {len(f_dense)}-point grid finite; launches in "
          f"the MAP phase {launches} (expected {want}) [{card}]")
    if launches != want:
        raise AssertionError(f"map launch counts {launches}, expected {want}")
    polish_pieces(card, freq, Zb)
    return launches


def polish_pieces(card, freq, Zb):
    """Device time of one polish iteration's pieces at B=1024, float32,
    from CUDA events: the Hessian (autograd, reverse over reverse), the
    batched solve and one value and gradient."""
    import torch
    from bayes_drt_tpu_torch.models.posterior import (init_unconstrained,
                                                      ravel)
    from bayes_drt_tpu_torch.parallel import batch
    f_desc = np.sort(freq)[::-1]
    _, _, _, cfg, data, _ = batch._build_shared(f_desc, mode="optimize",
                                             device="cuda")
    _, tgt = batch._scaled_targets(
        np.ascontiguousarray(Zb[:, np.argsort(freq)[::-1]]), B, None,
        torch.float32, "cuda")
    obj = batch.MapObjective(cfg, data, tgt)
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = ravel(cfg, init_unconstrained(cfg, data, gen, batch_shape=(B,)))
    h = obj.hessian(q)
    h.diagonal(dim1=1, dim2=2).add_(1.0)
    g = obj.value_and_grad(q)[1]
    ms = {"hessian": cuda_ms(lambda: obj.hessian(q), 3),
          "solve": cuda_ms(lambda: torch.linalg.solve(h, g), 3),
          "value_and_grad": cuda_ms(lambda: obj.value_and_grad(q), 10)}
    print(f"map polish pieces (B={B}, D={q.shape[1]}, float32, ms a call): "
          f"{json.dumps(ms)} [{card}]")
    del h, obj
    torch.cuda.empty_cache()


def phase_map_parity(card):
    """float64, 8 spectra, from the same starts (numpy-made Stan-random
    rows, the x, R_inf and inductance entries from the batched ridge on the
    CPU). On the card, run_lbfgs replays CUDA graphs: over MAP_PARITY_ITER
    iterations it must equal the eager form there bit for bit. Card
    against CPU: run_lbfgs at MAP_PARITY_SHORT (value within 1e-9
    relative, parameters within 1e-6 of each row's largest entry, counts
    equal; at MAP_PARITY_ITER the two devices' iterates have drifted
    apart, and only their value gap is printed); newton_polish on both
    devices from the CPU's MAP_PARITY_ITER iterate (value within 1e-9
    relative, the coefficients, R_inf and inductance within 1e-6 of each
    row's largest; its iteration counts and certificates are printed, not
    held: the last accept/reject steps sit at the gradient's rounding
    floor). Every differing row is printed."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.map import _LBFGS, newton_polish, run_lbfgs
    from bayes_drt_tpu_torch.models.posterior import constrain, unravel
    from bayes_drt_tpu_torch.parallel import batch
    # LAPACK's threaded LU can stall on some CPU builds; one thread is
    # enough for 8 rows
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        freq, Zb = sim.make_benchmark_batch(MAP_PARITY_B, circuit="ZARC",
                                            noise_level=0.0025, seed=4)
        Zd = np.ascontiguousarray(Zb[:, np.argsort(freq)[::-1]])
        f_desc = np.sort(freq)[::-1]
        objs = {}
        for dev in ("cpu", "cuda"):
            _, _, _, cfg, data, _ = batch._build_shared(
                f_desc, mode="optimize", dtype=torch.float64, device=dev)
            z_scales, tgt = batch._scaled_targets(Zd, MAP_PARITY_B, None,
                                                  torch.float64, dev)
            objs[dev] = batch.MapObjective(cfg, data, tgt)
        spec = objs["cpu"].spec
        iv_x, iv_r, iv_l = batch._ridge_init_values(
            f_desc, Zd, MAP_PARITY_B, z_scales, spec.K, None, torch.float64,
            "cpu")
        q0 = np.random.default_rng(8).uniform(-2.0, 2.0,
                                              (MAP_PARITY_B, spec.D))
        q0[:, spec.off_x:spec.off_x + spec.K] = np.where(iv_x == 0.0, 1e-8,
                                                         iv_x)
        q0[:, spec.off_rinf] = np.log(np.maximum(iv_r, 1e-10))
        q0[:, spec.off_induc] = np.log(np.maximum(iv_l, 1e-10))
        runs = {}
        for dev in ("cuda", "cpu"):
            obj = objs[dev]
            x0 = torch.tensor(q0, device=dev)
            t0 = time.perf_counter()
            long = run_lbfgs(obj.value_and_grad, x0,
                             max_iter=MAP_PARITY_ITER)
            short = run_lbfgs(obj.value_and_grad, x0,
                              max_iter=MAP_PARITY_SHORT)
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = [long, short, time.perf_counter() - t0]
            if dev == "cuda":
                eager = _LBFGS(obj.value_and_grad, x0, MAP_PARITY_ITER, 1e-8,
                               1e-13, 10, 40, graphs=False).run()
                same = all(torch.equal(a, b) for a, b in zip(long, eager))
                gap = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(long, eager))
                print(f"parity map: float64 L-BFGS as CUDA graphs vs eager "
                      f"on the card over {MAP_PARITY_ITER} iterations, "
                      f"largest difference {gap:.3e}")
                if not same:
                    raise AssertionError("parity map: graph replay differs "
                                         "from eager on the card")
        start = runs["cpu"][0].params
        for dev in ("cuda", "cpu"):
            obj = objs[dev]
            t0 = time.perf_counter()
            pol = newton_polish(obj.value_and_grad, obj.hessian,
                                start.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] += [pol, time.perf_counter() - t0]
    finally:
        torch.set_num_threads(threads)
    cfg, data = objs["cpu"].cfg, objs["cpu"].data

    def host(r):
        return {k: getattr(r, k).cpu() for k in r._fields}

    def rel_rows(a, b):
        return ((a - b).abs().max(dim=1).values
                / b.abs().max(dim=1).values.clamp_min(1e-300))

    def coefs(params):
        c = constrain(cfg, data, unravel(cfg, params))
        return torch.cat([c["x_0"], c["Rinf"][:, None], c["induc"][:, None]],
                         dim=1)

    c, h = host(runs["cuda"][0]), host(runs["cpu"][0])
    report = {"lbfgs_long_value_gap_not_held": float(
        ((c["value"] - h["value"]).abs() / h["value"].abs()).max())}
    failed = []
    for i, name in ((1, "lbfgs_short"), (3, "polish")):
        c, h = host(runs["cuda"][i]), host(runs["cpu"][i])
        v_rel = (c["value"] - h["value"]).abs() / h["value"].abs()
        p_rel = (rel_rows(coefs(c["params"]), coefs(h["params"]))
                 if name == "polish" else rel_rows(c["params"], h["params"]))
        counts_ok = ((c["n_iter"] == h["n_iter"])
                     & (c["converged"] == h["converged"]))
        bars_ok = (v_rel <= 1e-9) & (p_rel <= 1e-6)
        report[name] = {"value_rel_max": float(v_rel.max()),
                        "params_rel_max": float(p_rel.max()),
                        "n_iter_cuda": c["n_iter"].tolist(),
                        "n_iter_cpu": h["n_iter"].tolist(),
                        "converged_cuda": int(c["converged"].sum()),
                        "converged_cpu": int(h["converged"].sum())}
        for r in torch.nonzero(~(counts_ok & bars_ok)).flatten().tolist():
            print(f"parity map {name}: row {r} differs: n_iter "
                  f"{int(c['n_iter'][r])}/{int(h['n_iter'][r])}, converged "
                  f"{bool(c['converged'][r])}/{bool(h['converged'][r])}, "
                  f"value rel {float(v_rel[r]):.2e}, params rel "
                  f"{float(p_rel[r]):.2e}")
        # the polish's last steps sit at the gradient's rounding floor, so
        # its counts and certificates are printed, not held
        held = bars_ok if name == "polish" else counts_ok & bars_ok
        if not bool(held.all()):
            failed.append(name)
    report["seconds"] = {dev: {"lbfgs": runs[dev][2], "polish": runs[dev][4]}
                         for dev in runs}
    print(f"parity map: float64, {MAP_PARITY_B} spectra, D={spec.D}: "
          + json.dumps(report) + f" [{card}]")
    if failed:
        raise AssertionError(f"parity map: card and CPU differ in {failed}")


def sp_setup():
    """The Series-Parallel check batch (numpy, seed SP_SEED), its
    distributions and truths."""
    from bayes_drt_tpu_torch import sim
    freq = np.logspace(6, -2, 81)
    basis = np.logspace(6, -2, 81)
    dists = {"DRT": {"kernel": "DRT", "basis_freq": basis},
             "TP-DDT": {"kernel": "DDT", "symmetry": "planar",
                        "bc": "transmissive", "dist_type": "parallel",
                        "basis_freq": basis, "x_scale": 0.8}}
    z_true = sim.series_parallel_circuit(freq)
    zb = sim.noisy_replicas(z_true, SP_B_MAP, 0.0025, SP_SEED)
    tau = 1.0 / (2 * np.pi * basis)
    truth = {"drt": sim.zarc_drt(tau, 1e-3, 0.8),
             "ddt": sim.cole_cole_rbf(np.log(tau / 0.1), 0.8)}
    return freq, dists, z_true, zb, tau, truth


def sp_figures(res, freq, z_true, tau, truth):
    """Mean per-spectrum RMSE of the DRT and TP-DDT parts against their
    truths, the median relative impedance residual at the training grid
    (predict_Z_batch: for a sampled fit the draws' mean prediction) and
    whether every coefficient is finite."""
    from bayes_drt_tpu_torch.parallel import evaluate_gamma, predict_Z_batch
    g = evaluate_gamma(res, tau)
    g1 = evaluate_gamma(res, tau, "coef_1")
    zhat = predict_Z_batch(res, freq)
    return {
        "drt_rmse": float(np.mean(np.sqrt(np.mean(
            (g - truth["drt"]) ** 2, axis=1)))),
        "ddt_rmse": float(np.mean(np.sqrt(np.mean(
            (g1 - truth["ddt"]) ** 2, axis=1)))),
        "z_resid_median": float(np.median(np.abs(zhat - z_true[None, :])
                                          / np.abs(z_true)[None, :])),
        "finite": bool(np.isfinite(res.coef).all()
                       and np.isfinite(res.diagnostics["coef_1"]).all()
                       and np.isfinite(zhat).all())}


def phase_multidist(card):
    """The Series-Parallel configuration of the extended sweep (DRT +
    TP-DDT, N=81, K=81 each, D=336, nonneg): (a) MAP on 1024 spectra in the
    default form (2 restarts, cap 2000, polish; the autograd value and
    gradient replayed as CUDA graphs), (b) NUTS md8 tree_scan ncp on 256
    of them at 4 x (SP_WARMUP + SP_SAMPLES), gated on finite coefficients,
    the median impedance residual against the noiseless spectrum, the
    median divergence rate (sampling) and the DRT part's RMSE against the
    bar from the JAX package's MAP; (c) two B=64 MAP fits: a single
    parallel blocking DDT (the Y* z-scale) and a ridge-seeded series DRT
    with outliers on ZARC spectra with three corrupted frequencies; (d)
    the polish's Hessian and solve at D=336; (e) float64 card-vs-CPU
    parity of the DDT A matrices, the autograd value and gradient at
    R=1024 and one NUTS transition at R=1024 (on the card as CUDA graphs,
    bit for bit equal to eager there). Returns the K2 launches of (a) to
    (c)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import batch, predict_Z_batch
    freq, dists, z_true, zb, tau, truth = sp_setup()
    kw = dict(distributions=dists, nonneg=True, sigma_min=0.002,
              timing=True)
    print(f"series-parallel: budget cut from 4 x (500 + 500) to 4 x "
          f"({SP_WARMUP} + {SP_SAMPLES}) for sampling at B={SP_B_SAMPLE}; "
          f"the B={SP_B_SMALL} fits' L-BFGS cap cut to {SP_SMALL_ITER} "
          f"(from 2000 and 1500) [{card}]")
    drt_quad.launches = 0
    traj_fused.launches = 0
    out, failed = {}, []
    fits = {}
    for name, call in (
            ("map", dict(mode="optimize")),
            ("sample", dict(mode="sample", chains=CHAINS, warmup=SP_WARMUP,
                            samples=SP_SAMPLES, max_tree_depth=SP_DEPTH,
                            tree_scan=True, ncp=True, escalate=False,
                            gamma_eval_tau=tau))):
        z_in = zb if name == "map" else zb[:SP_B_SAMPLE]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batch.fit_spectra_batch(freq, z_in, random_seed=3, **kw,
                                      **call)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fits[name] = res
        d = res.diagnostics
        fig = sp_figures(res, freq, z_true, tau, truth)
        gates = {"finite": fig["finite"],
                 "z_resid": fig["z_resid_median"] <= SP_GATE_Z,
                 "drt_rmse": fig["drt_rmse"] <= SP_GATE_DRT_RMSE}
        rec = dict(B=len(z_in), wall_s=wall, phase_s=d["phase_s"], **fig)
        if name == "map":
            n_l = d["n_iter_lbfgs"]
            rec.update(lbfgs_iters=int(n_l.max()),
                       s_per_lbfgs_iter=d["phase_s"]["lbfgs"]
                       / float(n_l.max()),
                       polish_iters_max=int((d["n_iter"] - n_l).max()),
                       converged_share=float(np.mean(d["converged"])))
        else:
            draw_s = np.asarray(d["draw_s"])
            div = float(np.median(d["divergence_rate"]))
            gates["divergence"] = div < SP_GATE_DIV
            cov = float(np.mean((truth["drt"][None, :]
                                 >= d["gamma_eval_lo"])
                                & (truth["drt"][None, :]
                                   <= d["gamma_eval_hi"])))
            rec.update(divergence_rate_median=div, drt_band_coverage=cov,
                       n_leapfrog_mean=float(np.mean(d["n_leapfrog"])),
                       first_draw_s=float(draw_s[0]),
                       draw_s_median=float(np.median(draw_s[1:])))
        rec.update(gates={k: bool(v) for k, v in gates.items()},
                   drt_rmse_bar=SP_GATE_DRT_RMSE)
        out[name] = rec
        print(f"series-parallel {name}: " + json.dumps(rec) + f" [{card}]")
        failed += [f"{name}.{k}" for k, v in gates.items() if not v]
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}

    # (c) the two small fits
    small = {}
    bp = {"DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "blocking",
                  "dist_type": "parallel",
                  "basis_freq": np.logspace(6, -3, 91)}}
    z_bp = 1 + sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc="blocking")
    zb_bp = sim.noisy_replicas(z_bp, SP_B_SMALL, 0.0025, SP_SEED + 1)
    _, zb_out = sim.make_benchmark_batch(SP_B_SMALL, circuit="ZARC",
                                         seed=SP_SEED + 2)
    z_zarc = sim.reference_circuit("ZARC", freq)
    bad = [12, 40, 66]
    zb_out[:, bad] += 0.25 * (1 + 1j)
    for name, z_in, z_ref, call in (
            ("parallel_bp_ddt", zb_bp, z_bp, dict(distributions=bp)),
            ("series_outliers_ridge", zb_out, z_zarc,
             dict(outliers=True, init_from_ridge=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batch.fit_spectra_batch(freq, z_in, mode="optimize",
                                      max_iter=SP_SMALL_ITER, timing=True,
                                      **call)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        zhat = predict_Z_batch(res, freq)
        keep = np.setdiff1d(np.arange(len(freq)), bad)
        resid = np.abs(zhat - z_ref[None, :]) / np.abs(z_ref)[None, :]
        finite = bool(np.isfinite(res.coef).all() and np.isfinite(zhat).all())
        rec = {"B": SP_B_SMALL, "wall_s": wall,
               "phase_s": res.diagnostics["phase_s"],
               "z_scale_median": float(np.median(res.z_scales)),
               "z_resid_median": float(np.median(resid[:, keep])),
               "converged_share": float(np.mean(
                   res.diagnostics["converged"])), "finite": finite}
        if name == "series_outliers_ridge":
            g = batch.evaluate_gamma(res, res.tau)
            rec["drt_rmse"] = float(np.mean(np.sqrt(np.mean(
                (g - sim.zarc_drt(res.tau, 1e-3, 0.8)) ** 2, axis=1))))
        small[name] = rec
        print(f"series-parallel small fit {name}: " + json.dumps(rec)
              + f" [{card}]")
        if not finite:
            failed.append(f"{name}.finite")
    launches["quad"] = drt_quad.launches
    launches["traj"] = traj_fused.launches
    # K2: SP setup twice (the DRT's A, re and im) and the MAP fit's
    # prediction at the training grid (the sampled fit serves its draws'
    # mean); the outlier fit's setup, ridge and prediction
    want = {"quad": 2 + 2 + 2 + 2 + 2 + 2, "traj": 0}
    print(f"series-parallel launches {launches} (expected {want}) [{card}]")
    if launches != want:
        failed.append("launches")
    sp_polish_pieces(card, freq, dists, zb)
    sp_parity(card, freq, dists, zb, fits["sample"])
    if failed:
        raise AssertionError(f"series-parallel gates failed: {failed}")
    return launches


def sp_polish_pieces(card, freq, dists, zb):
    """Device time of one polish iteration's pieces on the Series-Parallel
    posterior at B=1024, D=336, float32 (CUDA events): the Hessian
    (autograd, reverse over reverse), the batched solve and one value and
    gradient (autograd)."""
    import torch
    from bayes_drt_tpu_torch.models.posterior import (init_unconstrained,
                                                      ravel)
    from bayes_drt_tpu_torch.parallel import batch
    f_desc = np.sort(freq)[::-1]
    _, _, _, cfg, data, _ = batch._build_shared(
        f_desc, mode="optimize", distributions=dists, nonneg=True,
        device="cuda")
    _, tgt = batch._scaled_targets(
        np.ascontiguousarray(zb[:, np.argsort(freq)[::-1]]), len(zb), None,
        torch.float32, "cuda", dists)
    obj = batch.MapObjective(cfg, data, tgt)
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = ravel(cfg, init_unconstrained(cfg, data, gen, batch_shape=(len(zb),)))
    torch.cuda.reset_peak_memory_stats()
    h = obj.hessian(q)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    h.diagonal(dim1=1, dim2=2).add_(1.0)
    g = obj.value_and_grad(q)[1]
    ms = {"hessian": cuda_ms(lambda: obj.hessian(q), 3),
          "solve": cuda_ms(lambda: torch.linalg.solve(h, g), 3),
          "value_and_grad": cuda_ms(lambda: obj.value_and_grad(q), 10),
          "hessian_peak_gib": peak}
    print(f"series-parallel polish pieces (B={len(zb)}, D={q.shape[1]}, "
          f"float32, ms a call): {json.dumps(ms)} [{card}]")
    del h, obj
    torch.cuda.empty_cache()


def sp_parity(card, freq, dists, zb, sampled):
    """float64 on the card against the port on the CPU: (a) the DDT A
    matrices of all three bc/symmetry pairs, series and parallel, ct off
    and on (k_ct 2.5), both parts, within 1e-12 of the largest entry of
    the complex A' + j A''; (b)
    the Series-Parallel autograd value and gradient of R=1024 numpy-made
    rows (logp within 1e-10 relative, gradient normwise within 1e-9 a
    row); (c) one NUTS transition (md8) at R=1024 from the sampled fit's
    final states, by nuts_transition_parity (phase 9's criterion), on at
    least 99.9% of rows."""
    import torch
    from bayes_drt_tpu_torch.models.posterior import posterior_value_and_grad
    from bayes_drt_tpu_torch.ops.matrices import construct_A
    from bayes_drt_tpu_torch.parallel import batch
    torch.set_num_threads(8)
    failed = []
    basis = np.logspace(6, -2, 81)
    tau = 1.0 / (2 * np.pi * basis)
    worst, worst_part = 0.0, 0.0
    t0 = time.perf_counter()
    eps = 1.0 / np.mean(np.diff(np.log(tau)))
    for bc, sym in (("transmissive", "planar"), ("blocking", "planar"),
                    ("blocking", "spherical")):
        for dist_type in ("series", "parallel"):
            for ct in (False, True):
                a = {dev: [construct_A(
                    freq, part, tau=tau, epsilon=eps, kernel="DDT",
                    dist_type=dist_type, symmetry=sym, bc=bc, ct=ct,
                    k_ct=2.5 if ct else None, dtype=torch.float64,
                    device=dev).cpu() for part in ("real", "imag")]
                    for dev in ("cuda", "cpu")}
                # held to the largest |A' + j A''|: a series blocking DDT's
                # A' is the O(1) real part of an integrand whose imaginary
                # part reaches ~1e8 at the lowest frequencies, so both
                # devices round A' to ~1e-8 absolute
                big = float(torch.complex(*a["cpu"]).abs().max())
                for c_, h_ in zip(a["cuda"], a["cpu"]):
                    err = float((c_ - h_).abs().max())
                    worst = max(worst, err / big)
                    worst_part = max(worst_part, err / float(h_.abs().max()))
    print(f"parity ddt A: 12 configurations x 2 parts, N=81, K=81, float64,"
          f" largest |card - cpu| / max|A' + j A''| {worst:.3e} (of the "
          f"part's own largest entry: {worst_part:.3e}) "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    if worst > 1e-12:
        failed.append("ddt_A")

    f_desc = np.sort(freq)[::-1]
    zd = np.ascontiguousarray(zb[:SP_B_SAMPLE, np.argsort(freq)[::-1]])
    vgs, data = {}, {}
    for dev in ("cuda", "cpu"):
        _, _, _, cfg, dat, _ = batch._build_shared(
            f_desc, mode="sample", distributions=dists, nonneg=True,
            ncp=True, dtype=torch.float64, device=dev)
        _, tgt = batch._scaled_targets(zd, SP_B_SAMPLE, None, torch.float64,
                                       dev, dists)
        tgt = tgt.repeat_interleave(CHAINS, dim=0)
        vgs[dev] = posterior_value_and_grad(cfg, dat, tgt)
    R = SP_B_SAMPLE * CHAINS
    q_np = np.random.default_rng(12).uniform(-2.0, 2.0, (R, 4 * 81 + 12))
    res = {dev: [t.cpu() for t in vgs[dev](torch.tensor(q_np, device=dev))]
           for dev in ("cuda", "cpu")}
    lp_rel = float(((res["cuda"][0] - res["cpu"][0]).abs()
                    / res["cpu"][0].abs()).max())
    g_rel = float((torch.linalg.norm(res["cuda"][1] - res["cpu"][1], dim=1)
                   / torch.linalg.norm(res["cpu"][1], dim=1)).max())
    print(f"parity sp value and grad: R={R}, D={q_np.shape[1]}, float64, "
          f"logp largest relative difference {lp_rel:.3e}, grad largest "
          f"normwise relative difference {g_rel:.3e} [{card}]")
    if lp_rel > 1e-10 or g_rel > 1e-9:
        failed.append("value_and_grad")

    d = sampled.diagnostics
    q0 = np.asarray(d["state_q"], np.float64).reshape(R, -1)
    m0 = np.asarray(d["state_inv_mass"], np.float64).reshape(R, -1)
    e0 = np.asarray(d["state_step_size"], np.float64).reshape(R)

    def rows(dev):
        q = torch.tensor(q0, device=dev)
        return (vgs[dev], q, *vgs[dev](q), torch.tensor(e0, device=dev),
                torch.tensor(m0, device=dev))

    bad = nuts_transition_parity(card, "parity sp nuts", R, SP_DEPTH, 13,
                                 rows)
    if bad > 0.001 * R:
        failed.append("nuts")
    if failed:
        raise AssertionError(f"series-parallel parity failed: {failed}")


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
    esc = phase_escalation(card)
    dflt = phase_default(card)
    phase_nuts_timing(card, state)
    phase_parity(card, state)
    mp = phase_map(card)
    phase_map_parity(card)
    sp = phase_multidist(card)
    launches = {k: launches[k] + esc[k] + dflt[k] + mp[k] + sp[k]
                for k in launches}
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
