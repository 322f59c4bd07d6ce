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
     the same SHMC fit at 4 x (100 + 100) with every spectrum forced
     through the refit (NUTS
     max_depth=8, tree_scan, seeded from the batched hyper-lambda ridge);
     the splice, the gate figures of the 64 and the seconds of the ridge,
     the NUTS draws and the call.
  7. the default call, fit_spectra_batch(freq, Z) with no sampler
     arguments (NUTS max_depth 10, escalation on) on the main path's 1024
     spectra at a budget cut to 4 x (20 + 10): shape, values, mask,
     launches, and the seconds of the call, of a warmup draw and of a
     draw after warmup.
  8. NUTS draw times from the main path's final states at R=4096 rows,
     eager and replayed as CUDA graphs: max_depth 8 static
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
     (tree_scan, ncp) on 256 of them at 4 x (100 + 25), both through the
     autograd value and gradient replayed as CUDA graphs, gated on finite
     coefficients, the median impedance residual against the noiseless
     spectrum (<= 0.02), the median divergence rate (< 0.05) and the DRT
     part's RMSE (<= 1.5x the JAX package's MAP figure); two B=64 MAP fits
     (a single parallel blocking DDT; a ridge-seeded series DRT with
     outliers on spectra with three corrupted frequencies); the polish's
     Hessian and solve at D=336; float64 card-vs-CPU parity of the DDT A
     matrices, the autograd value and gradient and one NUTS transition.
  12. the generic SHMC sampler and fit_spectra_ragged: (a)
     fit_spectra_batch(sampler="shmc", ncp, recompute_grad) on phase 11's
     256 Series-Parallel spectra at 4 x (150 + 250), each draw's autograd
     trajectory one CUDA graph replay, with phase 11's gates but the
     divergence bar (1.5x the JAX package's own SHMC figure); (b) float64
     parity of the generic trajectory: a Series-Parallel trajectory
     replayed as a graph on the card (bit for bit its eager form) against
     the CPU, and the trajectory kernel against the generic trajectory on
     its hand-written gradient at the main path's final states; (c)
     fit_spectra_ragged on the ragged bench's fleet (512 ZARC spectra on
     different grids, n 57 to 97, padded to 112, K=101): generic SHMC at
     the bench's configuration and 4 x (150 + 250), and MAP in the default
     form (2 restarts, cap 2000, no polish), gated on RMSE and p90; (d)
     float64 card-vs-CPU parity of the ragged density and gradient and of
     the ragged DRT A, and K2's time at the fleet's ragged launch.
  13. the Inverter: (a) Inverter.ridge_fit on one noisy ZARC spectrum
     (N=81) for each option family (the presets, part fits, L1, dZ,
     hyper-a/b, LM, hyper-weights, ordinary, x0, Cholesky, no inductance,
     the phase-offset correction) and a blocking-DDT admittance ridge, each
     held in float64 to the CPU, and the default fit gated as the JAX
     package's ridge quick-start; (b) ridge_fit_spectra_batch on the main
     path's 1024 spectra with the Re-Im CV (31 lambdas; its bars from
     the JAX package's own CV on the same spectra) and the hyper-weights
     ridge, gated, with float64 card-vs-CPU parity on 8, and the box QP's
     CUDA-graph tail held to its eager loop in float64 on CV rows that
     pivot to their iteration cap;
     (c) the single-parallel ridge seed: 16 blocking-DDT spectra through
     the default escalation, the gate forced, so each is refitted by NUTS
     md8 from the Inverter's admittance ridge; (d) Inverter.fit: MAP
     twice, NUTS md10 at a cut budget on a second same-shape spectrum,
     then at the JAX package's Inverter test warmup, 2 x (120 + 60), on
     the first, a cache hit whose first draw captures nothing (there
     also rhat_max < 5), SHMC, each gated as
     the JAX package's Inverter tests, check_outliers and a save/load
     round trip.
  14. drift, peaks and ECM: (a) the drift bench's fleet (64 cells, N=93,
     K=81, x1, 2 restarts, cap 1500, float32) through
     drift_fit_spectra_batch once, gated on finite coefficients, every
     cell's median relative Z residual (< 0.05), tau_1 within its bounds
     and the median over cells (<= 1.5x the JAX package's own), then the
     bench's serial line (Inverter.drift_map_fit of one cell, once) and
     the fleet's speedup; (b) Inverter.drift_map_fit on the JAX drift
     test's three-sweep spectrum (RQ with 63 restarts: at its 8 the gates
     hold on 7 of 10 seeds in the JAX package; x1) in float64 with its
     gates
     and the time-routed predictions; (c) HN peaks on a MAP fit of a
     noisy 2ZARC spectrum (every peak method, the JAX peak workflow
     test's gates) and fit_ecm on the JAX ECM tests' circuits with their
     gates; (d) float64 card-vs-CPU parity of the drift density and
     gradient (all eight models, series and parallel), run_lbfgs on drift
     rows, bounded_lm on a peak residual, and K2 against its plain
     version on the fleet's unsorted, repeated grid.
  15. simulation-based calibration and the command line: (a) SBC at the
     JAX package's production configuration (benchmarks/sbc.py): 256
     exact prior-predictive Series datasets (the (ups_raw, ds) marginal by
     NUTS md7 at warmup 500 on the card, x by Cholesky), one production
     fit (SHMC 4 x (150 + 250), z_scale 1, no escalation, unthinned
     monitors), the stride from the monitors' measured ESS, and the 10
     monitors' ranks, each gated on a 16-bin chi-square p > 0.005 and no
     DKW ECDF violation; float64 card-vs-CPU parity of the marginal's
     value and gradient and of one NUTS transition of it as CUDA graphs;
     (b) the CLI as a user runs it (python -m bayes_drt_tpu_torch fit, a
     subprocess each, the five at once) on 1,024 noisy ZARC CSVs on two
     grids, four Gamry
     .DTA files and a corrupt file: sample mode (the defaults), optimize,
     ridge with and without --ridge-cv, --peaks on 8 files, gated on exit
     codes, one Gout file a spectrum, the corrupt file's load_error row
     and the recovered gamma against the analytic ZARC DRT; one
     sample-mode bucket under profiling.trace, whose Chrome trace must
     name the trajectory kernel once a draw.
  16. resumed and preconditioned sampling and the cross-call cache: (a)
     progcache cleared, then Inverter.fit (NUTS md8, SHMC, MAP),
     Inverter.drift_map_fit and fit_spectra_batch's NUTS refit form each
     fitted on X, on another same-shape Y and on X again, the last a
     counted hit with no capture whose output equals the first bit for
     bit; (b) warm_start on spectra scaled by 1.03: the main path (K1)
     resumed from phase 4 at 4 x (75 + 250) with the five gates and 325
     K1 launches, NUTS md8 resumed from phase 6's 64 spectra with the JAX
     chained-refit test's gates, and a ragged resume of 64 fleet spectra;
     (c) precondition="pooled" on 64 main-path spectra (NUTS md8, a 50 +
     25 pilot, warmup 150, 100 draws) with the JAX pooled test's gates;
     (d) dense_mass and a fixed dense metric on the JAX tests' correlated
     Gaussians as 256 rows of CUDA-graph trees, and the per-row dense
     metric's memory at R=4096, D=211; (e) float64 card-vs-CPU parity of
     one NUTS transition with a shared dense metric at D=211.
     The cache's stats are printed after every phase.
  17. ChEES-HMC (sampler="chees", the default ChEESConfig) on the main
     path's posterior: (a) the 1024 spectra at 4 x (150 + 250), float32,
     through the autograd value and gradient, each draw's leaves replayed
     as CUDA graph blocks; its seconds a draw, captures, mean leapfrogs a
     row and the batch's largest a draw, replays a draw, divergence,
     trajectory times and the five gate figures printed; RMSE, p90 and
     divergence within 1.5x the JAX package's own ChEES on the same
     spectra (scripts/jax_chees_reference.py 1024), min-ESS > 0, finite
     coefficients; (b) a warm start of (a) on the
     spectra x 1.03 at a short warmup, the JAX chained-refit rule; (c)
     float64 card-vs-CPU parity of a few draws resumed from (a)'s state
     with the same noise, 256 rows on the card, 64 of them on the CPU; (d) Inverter.fit(sampler="chees")
     on phase 13's spectrum over 8 seeds, every JAX Inverter sampled
     gate's figure printed, ess_min > 2 a fit, the medians of the rest
     within the JAX package's own 90th percentiles over 32 seeds.
  18. the mesh and the remaining sampler arms: (a) the main path (B=1024, nothing cut)
     through make_mesh() over the one card, its shard_layout printed,
     the five gates and 400 K1 launches, bit for bit phase 4's meshless
     fit; (b) MAP, ridge, the Re-Im CV, drift and ragged MAP at small
     sizes on the one-card mesh against their meshless results, bit for
     bit; (c) SHMCConfig(traj_store=True) on phase 12's 256
     Series-Parallel spectra at 4 x (150 + 100) with phase 12's gates,
     its one shard run in the mesh's worker thread (a tagged shard on
     cuda:0: thread-local captures, the device set in the thread), as is
     a second run of (a), bit for bit phase 4 too;
     (d) NUTSConfig(fused_draws=True) md8 on 256 of the main path's rows
     without adaptation: it runs the flat form, so the same trees and
     draws; (e) the precision A/B: phase 12's fit at precision='high'
     (tf32x3) against phase 12's own run, phase 12's gates, seconds a
     draw and bf16x3_grad_err (the 'fast' preset stays at 'highest').
  19. one JSON line listing both kernels with their launches (phases 4,
     6, 7, 10 to 18) and times; K2's bound counts the function's
     least fp64 work a node, and the count its compiled loop issues
     (cuobjdump -sass) is printed beside it.
The last line of stdout is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --check-only   # phases 1-3, then stop
"""

import json
import math
import os
import subprocess
import sys
import time
import warnings

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
# keep the smoke's time; a cut is printed): 4 x (100 + 150) since the SBC
# and CLI phase came, 4 x (100 + 100) since the resume phase came
B_ESC = 64
ESC_WARMUP = 100
ESC_SAMPLES = 100
NUTS_DEPTH = 8            # the refit's max_tree_depth
# phase 9's float64 NUTS transition: the card runs the main path's 4,096
# rows, the CPU reference 64 of them (rows 64 i + i % 64, every chain
# index alike) since the CLI commands run one after another (128 since
# the mesh phase came, their CPU side 11.70 s on a fast host; 512 since
# the ChEES phase, 1,024 before, one a spectrum, whose CPU side took 8.70
# s on a slow host; all 4,096 until the SBC and CLI phase came, 26.4 s)
PARITY_CPU_ROWS = 64
# the default call's phase: the main path's B, and a budget cut from the
# default 4 x (500 + 500) to keep the smoke's time (4 x (60 + 20) until
# the generic SHMC and ragged phase came, 4 x (30 + 10) until the SBC
# and CLI phase came, 4 x (20 + 10) until the resume phase came)
B_DEFAULT = B
DEFAULT_WARMUP = 6          # 4 x (10+5) until the mesh phase came
DEFAULT_SAMPLES = 4

# the MAP phase: the default form's caps and restarts, the production
# form's cap, its gates (of Rp; p90 is the JAX MAP tests' per-spectrum
# bar) and the float64 parity's spectra and caps (the short cap holds
# the iterates themselves: L-BFGS amplifies the two devices' last-bit
# differences by ~1e2 every 10 iterations on this posterior)
MAP_ITER = 2000
# phase 10's caps since the mesh phase came: the default form's 2000 and
# the production form's 1500 halved (their figures read 0.40% and 0.34%
# Rp against the 3% bar, the polish running its 100 iterations either way)
MAP_DEFAULT_ITER = 1000
MAP_RESTARTS = 2
MAP_RIDGE_ITER = 750
MAP_GATE_RMSE = 0.03
MAP_GATE_P90 = 0.08
MAP_PARITY_B = 4            # 8 until the mesh phase came
MAP_PARITY_ITER = 100       # 200 until the mesh phase came
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
# 100 draws until the resume phase came (its NUTS md8 fit then 63 to 73
# s of the smoke's 1,200)
SP_SAMPLES = 25
SP_DEPTH = 8
SP_B_SMALL = 64
# the float64 NUTS transition parity's spectra (of SP_B_SAMPLE; 128 rows:
# the CPU side of 1,024 rows was most of the phase's ~65 s of parity; 256
# rows until the ChEES phase came, the whole smoke then 1,149.5 s on a
# slow host)
SP_PARITY_NUTS_B = 16       # 32 until the mesh phase came
SP_SMALL_ITER = 1000
SP_GATE_Z = 0.02          # median |Z_hat - Z_true| / |Z_true|
SP_GATE_DIV = 0.05        # median divergence rate
# the JAX package's own MAP recovery of the DRT part on the first 8 of
# these spectra (mean per-spectrum RMSE, Rp = 1; float64 on the CPU, by
# scripts/jax_series_parallel_reference.py), and the bar, 1.5x of it
SP_JAX_DRT_RMSE = 0.022847870434669106
SP_GATE_DRT_RMSE = 1.5 * SP_JAX_DRT_RMSE
# the generic SHMC fit's divergence bar: SHMC at eps_quantile 0.5 samples
# half the chains above their own adapted step size, and the legs that
# diverge are never selected (the JAX package documents ~12% for its
# 'fast' preset, docs/PERFORMANCE.md:227-230), so phase 11's NUTS bar
# (0.05) does not apply; the bar is 1.5x the JAX package's own median on
# the first 16 of these spectra at the same configuration and budget
# (float64 on the CPU, scripts/jax_series_parallel_reference.py 16 shmc)
SP_JAX_SHMC_DIV = 0.14149999618530273
SP_GATE_SHMC_DIV = 1.5 * SP_JAX_SHMC_DIV
# the ragged phase: the fleet of the JAX package's ragged bench
# (benchmarks/bench_ragged.py:26-42, made by sim.make_ragged_fleet) at its
# B and seed
RG_B = 512
RG_SEED = 0
# the Inverter phase: one noisy ZARC spectrum of the main path's grid
# (N=81); the ridge option families of Inverter.ridge_fit, each held in
# float64 card vs CPU (coefficients within 1e-8 of the largest; 1e-7 with
# the hyper-a update, whose golden-section search resolves a only to
# ~sqrt(eps)); the batched ridge's default CV grid, its gates (of Rp) and
# parity spectra; the forced single-parallel escalation's spectra and cut
# budget; the NUTS md10 fit's budget cut from the default 2 x (200+200);
# both sampled fits run non-centered (ncp), as the JAX package's Inverter
# recommends for mixing
INV_SEED = 13
INV_TOL = 1e-8
INV_TOL_HYPER_A = 1e-7
# float64 parity of the Re-Im CV runs on the default grid's values from
# 1e-7: in float64 the QPs of the smallest lambdas pivot to their
# 2,000-iteration cap (about 70 s a spectrum on the CPU side)
# one point a decade since the mesh phase came (25 points before)
INV_CV_PARITY_GRID = np.logspace(-7, 5, 13)
INV_RIDGE_CASES = {
    "default": {}, "huang": dict(preset="Huang"),
    "ciucci_cv": dict(preset="Ciucci", cv_lambdas=INV_CV_PARITY_GRID),
    "part_real": dict(part="real"), "part_imag": dict(part="imag"),
    "L1": dict(L1_penalty=0.1), "dZ": dict(dZ=True),
    "hyper_a_b": dict(hyper_a=True, hyper_b=True),
    "lm": dict(hl_solution="lm"),
    "hyper_weights": dict(hyper_lambda=False, hyper_weights=True),
    "ordinary": dict(hyper_lambda=False, lambda_0=0.1),
    "x0": dict(x0=np.full(103, 0.01)), "cholesky": dict(penalty="cholesky"),
    "no_inductance": dict(fit_inductance=False)}
INV_CV_GRID = np.logspace(-10, 5, 31)
INV_GATE_RMSE = 0.03
INV_GATE_P90 = 0.08
# the CV fit's gates: in float32 the CV curve is flat below lambda ~1e-6
# and its selections there are noise in both packages (on the CPU their
# curves agree within 1.1% above it, and 47 of the first 64 spectra
# select the same lambda; scripts/jax_ridge_cv_reference.py --port 64).
# The JAX package's own float32 CV on the same 1024 spectra (on the CPU,
# scripts/jax_ridge_cv_reference.py 1024) misses the 3% and 8% bars of
# the other ridge fits; the bars are 1.15x its figures
INV_JAX_CV = {"rmse_over_rp": 0.05187158297986887,
              "p90_over_rp": 0.12908255622976486, "boundary_low": 40}
INV_GATE_CV_RMSE = 1.15 * INV_JAX_CV["rmse_over_rp"]
INV_GATE_CV_P90 = 1.15 * INV_JAX_CV["p90_over_rp"]
# the box QP's graphed tail against its eager loop: the CV's first QP on
# 2 spectra at lambdas 1e-10 to 1e-8 in float64, whose rows all pivot to
# the iteration cap. The graph pads its batch (10 rows to 16) and the
# batched float64 solves of these ill-conditioned systems round apart at
# different batch sizes: the same final active sets give x 3.9e-10 apart
# (H100 80GB HBM3, 700 W), so x is held within 1e-8 of the largest, and
# the replays bit for bit to the same steps run eagerly
INV_QP_B = 2
INV_QP_GRID = np.logspace(-10, -8, 5)
INV_QP_TOL = 1e-8
INV_PARITY_B = 4            # 8 until the mesh phase came
# the forced single-parallel escalation at 4 x (100+100): the JAX
# package's own median Z residual on these 16 spectra reads 0.0347 at
# 4 x (50+50), over the 0.02 bar, and 0.0155 at 4 x (100+100) (float32
# on the CPU, scripts/jax_escalation_reference.py)
INV_ESC_B = 16
INV_ESC_WARMUP = 100
INV_ESC_SAMPLES = 100
INV_JAX_ESC_RESID = 0.015545151922947986
INV_NUTS_WARMUP = 30
INV_NUTS_SAMPLES = 20
# the mixing gates of the JAX package's Inverter test (rhat_max < 5,
# ess_min > 2 at its 2 x (120+120)): one NUTS md10 fit at that budget is
# gated on both; at the cut budget the JAX package's own fits of this
# spectrum read rhat_max 35 to 74 and ess_min 2.01 to 2.11 (float64 on the
# CPU, scripts/jax_inverter_reference.py), so there ess_min is gated and
# rhat_max printed
INV_NUTS_TEST_WARMUP = 120
# the JAX test's 120 draws until the resume phase came (the fit then 107
# to 129 s of the smoke's 1,200), 60 until the mesh phase came (68.85 s);
# its warmup, which sets the adaptation the gates read, is kept: the
# port's own fits of this spectrum on the CPU (float32) read rhat_max
# 2.71 at 2 x (120+40), 4.05 to 4.46 at (120+30) and 3.60 to 7.39 at
# (90+30), against 2.85 at (120+60)
INV_NUTS_TEST_SAMPLES = 40
INV_GATE_RHAT_MAX = 5.0
INV_GATE_ESS_MIN = 2.0

# the drift phase: the drift bench's configuration
# (benchmarks/bench_drift.py: make_fleet(64, seed=0), x1, 2 restarts,
# min_tau_drift 100, max_iter 1500; float32), each cell's median relative
# Z residual gated as the JAX package's drift tests gate it
# (tests/test_round3.py:555-583), the fleet's median of them at 1.5x the
# JAX package's own on the same cells (float32 on the CPU, random_seed 1,
# scripts/jax_drift_reference.py); the LM parity's iteration cap
DRIFT_B = 64
DRIFT_KW = dict(drift_model="x1", n_restarts=2, min_tau_drift=100.0,
                max_iter=1500)
DRIFT_GATE_RESID = 0.05
DRIFT_JAX_P50 = 0.0017872425960376859
DRIFT_GATE_P50 = 1.5 * DRIFT_JAX_P50
DRIFT_LM_CAP = 20
# the Inverter's RQ drift fit: 63 restarts (64 starts, one batch of rows)
# in place of the JAX test's 8, whose best start reaches the drifting
# element's basin on 7 of 10 seeds in the JAX package
# (scripts/jax_drift_reference.py rq)
DRIFT_RQ_RESTARTS = 63

# phase 15 (a): simulation-based calibration at the JAX package's
# production SBC configuration (benchmarks/sbc.py:44-60, 82-84, 126-134):
# the Series model on logspace(6, -2, 81), K=101; the prior marginal by
# NUTS at warmup 500, max depth 7; the production SHMC fit at 4 x
# (150+250), z_scale 1, no escalation, unthinned monitors, then the
# stride from the measured monitor ESS (benchmarks/sbc.py's auto-thin); the
# JAX package's criterion: 16-bin chi-square p > 0.005 and no DKW ECDF
# violation on each of the 10 monitors. 256 datasets, the documented
# alternative of benchmarks/sbc.py:24, not 512: at 512 the
# whole smoke would pass ~1,150 s of its 1,200 (phase 15 alone took
# 267.5 s, 512 datasets calibrating 10/10, on an NVIDIA H100 80GB HBM3 at
# 700 W)
SBC_SETS = 256
SBC_PRIOR_WARMUP = 500
SBC_PRIOR_DEPTH = 7
SBC_GE_TAU = np.array([1e-4, 1e-2, 1.0, 1e2])
SBC_MONITORS = ("Rinf", "induc", "sigma_res", "alpha_prop", "alpha_re",
                "alpha_im", "gamma(1e-4)", "gamma(1e-2)", "gamma(1)",
                "gamma(1e2)")
SBC_BINS = 16
SBC_P_MIN = 0.005
SBC_PARITY_ROWS = 64
SBC_PARITY_NUTS_ROWS = 16
# phase 15 (b): the CLI on a directory of noisy ZARC spectra on two grids
# (CSV), four Gamry .DTA files on the first grid and a corrupt file: 384 +
# 128 spectra since the sample command runs alone (768 + 256 before) and
# the optimize command's L-BFGS cap 500 (the CLI's default 1500: its
# figures read 0.35% and 0.84% Rp against the 3% and 8% bars at 1500)
CLI_GRIDS = ((384, (6, -2, 81)), (128, (5, -1, 61)))
CLI_MAP_ITER = 500
CLI_DTA = 4
CLI_PEAK_FILES = 8
CLI_GATE_MAP_P90 = 0.08     # the JAX MAP tests' bar
CLI_GATE_RIDGE_RP = 0.15    # tests/test_cli.py:44-45, every spectrum's Rp
CLI_GATE_CV_RMSE = 0.10     # tests/test_cli.py:98-101
CLI_PEAK_RMSE_REL = 0.15    # tests/test_cli.py:136

# phase 16: (a) the cross-call cache on Inverter.fit (NUTS md8 and SHMC
# at short budgets, MAP and drift capped without polish: what is checked
# is the cache, not the fit) and on fit_spectra_batch's NUTS refit form
# on CACHE_REFIT_B spectra; (b) warm starts on spectra scaled by
# WARM_SCALE at WARM_WARMUP warmup draws (the JAX package's chained-refit
# test scales by 1.03 and resumes at a fifth of its warmup), NUTS at
# WARM_NUTS_SAMPLES draws, the ragged resume on RG_WARM_B spectra of the
# fleet; (c) the pooled preconditioner at the JAX package's test
# settings but md8, on POOL_B of the main path's spectra; (d) the dense
# Gaussians as DENSE_ROWS rows; (e) the dense transition's float64 parity
# rows
CACHE_SEED = 21
CACHE_NUTS = (10, 5)
CACHE_REFIT = (5, 3)
CACHE_SHMC = (20, 20)
CACHE_MAP_ITER = 200
CACHE_REFIT_B = 8
WARM_SCALE = 1.03
WARM_WARMUP = 30
# the main path's resume at 4 x (30 + 250) read a median logp split-Rhat
# of 4.18, over the 4.0 gate, the other four gates green (NVIDIA H100
# 80GB HBM3, 700 W): thirty dual-averaging steps from the re-searched
# step size leave it small (divergence 0.04% against the cold fit's
# 13%), so the chains move less a draw; it resumes at 75, half the cold
# warmup
WARM_MAIN_WARMUP = 75
# 100 draws until the ChEES phase came (the resume then 15.95 s, 0.122 s
# a draw, RMSE 1.39% Rp against the 5% bar)
WARM_NUTS_SAMPLES = 60
RG_WARM_B = 64
# the cold ragged fit the resume starts from ((100, 150) until the mesh
# phase came)
RG_WARM_COLD = (100, 100)
POOL_B = 64
# warmup 150 and 100 draws until the ChEES phase came (the pooled fit then
# 45.6 s of the smoke's 1,200, its trees saturated at 255 leaves, RMSE
# 1.57% Rp and divergence 0.02% against the 6% and 0.05 bars)
POOL_WARMUP = 100
POOL_PILOT = (50, 25)
POOL_SAMPLES = 30
POOL_GATE_RMSE = 0.06       # tests/test_parallel.py:216
POOL_GATE_DIV = 0.05
DENSE_ROWS = 256
# the Gaussians' trees: md8, not the JAX tests' default md10 (their mean
# trees read 7 to 23 leaves on an NVIDIA H100 80GB HBM3 at 700 W, and
# capturing md10's 1,023-leaf graphs cost more than the draws); the
# longest tree of each run is printed
DENSE_DEPTH = 8
DENSE_PARITY_ROWS = 128     # 256 until the mesh phase came

# phase 17: ChEES-HMC on the main path's posterior (B, N=81, K=101,
# D=211, ncp, 4 chains, the main path's 150 + 250, the default
# ChEESConfig, float32). (a) is gated against the JAX package's own ChEES
# fit of the same 1,024 spectra at the same configuration and budget
# (float32 on the CPU, scripts/jax_chees_reference.py 1024, 512.4 s):
# RMSE, p90 and divergence each within CH_GATE_X of its figure (phase 12's
# rule for generic SHMC), min-ESS > 0 and finite coefficients as
# tests/test_round3.py:161-178 checks; not the main path's five gates (the
# JAX package measured ChEES weaker than NUTS and SHMC on this funnel,
# bayes_drt_tpu/experiments/__init__.py:13-22). (b) resumes at
# CH_WARM_WARMUP warmup draws; (c) CH_PARITY_DRAWS (warmup, samples) draws
# of CH_PARITY_ROWS rows; (d) the Inverter at the JAX Inverter test's
# warmup, phase 13's 2 x (120 + 60), over CH_INV_SEEDS seeds
CH_JAX = {"rmse_over_rp": 0.0459281175531848,
          "p90_over_rp": 0.0780571484535161,
          "divergence_rate": 0.29493555426597595}
CH_GATE_X = 1.5
CH_WARM_WARMUP = 30
# the warm fit's draws: at the main path's 250 it took 24.4 s, its draws
# paying the batch's largest leapfrog count, 87 a draw on average against
# a row's 19.4 (NVIDIA H100 80GB HBM3, 700 W), and its RMSE 2.5% Rp
# against the chained-refit bar of 9.2%; 100 draws in the first whole
# smoke with this phase (1,149.5 s on a slow host), 60 until the mesh
# phase came
CH_WARM_SAMPLES = 30
CH_PARITY_ROWS = 256
# the spectra the CPU side reruns: 64 of the 256 rows (all 256 took 14.4
# s on the CPU side of a slow host, the whole smoke then 1,108.8 s)
CH_PARITY_CPU_B = 16
# resumed from (a)'s adapted state (3 + 2 draws from its final positions
# with the default ChEESConfig's fresh adaptation took 24.5 s on the CPU
# side of a slow host, their leapfrog counts up to 128 a draw at R=256)
CH_PARITY_DRAWS = (3, 2)
CH_INV_BUDGET = (120, 60)
CH_INV_SEEDS = 8
# phase 18: the mesh (one card), traj_store, fused_draws, precision='high'
MESH_B = 16                 # (b): the small mesh-vs-meshless fits
MESH_MAP_ITER = 100         # MAP without the polish
MESH_RIDGE_B = 64
MESH_CV_GRID = np.logspace(-6, 0, 5)   # the CV on MESH_B spectra
MESH_DRIFT_B = 8
MESH_DRIFT_ITER = 150
STORE_BUDGET = (150, 100)   # (c): traj_store on phase 12's 256 spectra
FUSED_B = 64                # (d): NUTS md8 rows = FUSED_B * CHAINS
FUSED_NOADAPT = 5           # draws of the warmup=0 comparison
# the JAX package's own Inverter ChEES fits of phase 13's spectrum at 2 x
# CH_INV_BUDGET over random_seed 0 to 31 (float32 on the CPU,
# scripts/jax_chees_reference.py inverter) miss the JAX Inverter tests'
# rmse, R_inf and rhat_max bars (medians 0.103 Rp, 0.263, 23.8; ess_min >
# 2 holds). Phase 17 (d) holds the port's medians over its CH_INV_SEEDS
# fits to the JAX package's 90th percentiles over its 32: a sampler of
# the same distribution fails one in at most 200 runs (it takes four of
# the 8 above the 90th percentile), a port whose median sits at the JAX
# 90th percentile about half its runs. (1.5x the JAX package's 8-seed
# medians failed the port's 5-seed rhat_max median, 56.1 against 35.2,
# though 32 fits of each package on the CPU read medians of 26.8 and
# 23.8, Mann-Whitney p = 0.12.)
CH_JAX_INV_Q90 = {"rmse_over_rp": 0.11415603941405111,
                  "R_inf_err": 0.5140631079673768,
                  "rhat_max": 46.15640640258792}

# results of earlier phases that phase 16 resumes from (filled by
# phase_main and phase_escalation; a script running phase 16 alone runs
# them first)
KEEP = {}

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
    state = {k: d[k] for k in ("state_q", "state_inv_mass",
                               "state_step_size")}
    KEEP["main"] = (freq, Zb, res, tau, gt, rp)
    KEEP["state"] = state
    return launches, state


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
    KEEP["esc"] = (freq, Zb, res, tau, gt, rp, rmse)
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


def nuts_rows(dtype, state, R, device="cuda", idx=None):
    """The first R of the main path's final chain states (those at the
    indices ``idx`` if given) as NUTS rows: (value_and_grad, q, logp,
    grad, eps, m_inv) on ``device``."""
    import torch
    from bayes_drt_tpu_torch.infer.shmc_flat import flat_value_and_grad
    args = traj_inputs(dtype, state)
    spec, sh, tgt = args[0], args[3], args[10]
    if device != "cuda":
        from bayes_drt_tpu_torch.infer.shmc_flat import make_flat_shared
        sh = make_flat_shared(*(t.to(device) for t in (sh.A, sh.L, sh.vecs,
                                                       sh.scal)))
    sel = slice(R) if idx is None else torch.as_tensor(idx)
    tgt = tgt[sel].to(device)

    def vg(q):
        return flat_value_and_grad(spec, sh.A, sh.L, sh.vecs, sh.scal, q,
                                   tgt)

    q = args[4][sel].to(device)
    lp, g = vg(q)
    return vg, q, lp, g, args[8][sel].to(device), args[9][sel].to(device)


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
    at R=4096 rows, eager and replayed as CUDA graphs: max_depth 8 with
    the static tree (the refit's form) and max_depth 10 stopping once no
    row is alive (the default NUTS path's form). The graphs' outputs must
    equal the eager ones on the same inputs. (R=256 ran too until the SBC
    and CLI phase came: 0.150 / 0.489 s a graphed draw, md8 / md10, on
    an NVIDIA H100 80GB HBM3 at 700 W; phase 6's refit times md8 at that
    R.)"""
    import torch
    from bayes_drt_tpu_torch.infer.nuts import (GraphedTree,
                                                nuts_transition_flat)

    def timed(fn, reps, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps, res

    print("nuts timing: GraphedTree built directly, outside the cross-call "
          "cache, so that every capture here is timed")
    out = {}
    for R in (B * CHAINS,):
        vg, q, lp, g, eps, m_inv = nuts_rows(torch.float32, state, R)
        for depth, scan in ((NUTS_DEPTH, True), (10, False)):
            noise = nuts_noise_np(R, q.shape[1], depth, 5, torch.float32,
                                  "cuda")
            # eager: no warm-up run, its ops ran in phases 4 to 7
            e_s, e_out = timed(lambda: nuts_transition_flat(
                vg, q, lp, g, noise, eps, m_inv, max_depth=depth,
                tree_scan=scan), 1, warm=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = GraphedTree(vg, q, lp, g, noise, eps, m_inv, depth,
                               1000.0, early_stop=not scan)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            g_s, g_out = timed(lambda: tree(q, lp, g, noise, eps, m_inv), 2)
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


def nuts_transition_parity(card, label, R, depth, seed, rows, cpu_idx=None,
                           metric=None):
    """One float64 NUTS transition (max_depth ``depth``, noise from numpy
    ``seed``) of the rows ``rows(device)`` gives ((value_and_grad, q, logp,
    grad, eps, m_inv) on that device): on the card replayed as CUDA graphs
    (GraphedTree, the static tree), which must equal the eager early-stop
    form there bit for bit, against eager on the CPU. With ``cpu_idx``
    the card runs all R rows and the CPU (whose ``rows`` gives those rows
    only) the rows at ``cpu_idx``, which are compared: rows are
    independent, each its own tree and noise. A row agrees when its
    tree (n_leapfrog, depth, divergence) is the same, its q is within 1e-9
    of the row's largest entry, and its logp and grad are within 1e-9 of
    the CPU's evaluation at the card's own selected point (after up to 255
    leapfrogs the two summation orders leave ~1e-12 relative differences
    in q, which a stiff posterior turns into ~1e-7 in grad; printed).
    ``metric(device)``, when given, is a dense metric's (m_inv, chol) in
    place of the rows' diagonal one. Prints every differing row and
    returns their count."""
    import torch
    from bayes_drt_tpu_torch.infer.nuts import (GraphedTree, NUTSNoise,
                                                nuts_transition_flat)
    outs = {}
    for dev in ("cuda", "cpu"):
        vg, q, lp, g, eps, m_inv = rows(dev)
        chol = None
        if metric is not None:
            m_inv, chol = metric(dev)
        noise = nuts_noise_np(R, q.shape[1], depth, seed, torch.float64, dev)
        if dev == "cpu" and cpu_idx is not None:
            i = torch.as_tensor(cpu_idx)
            noise = NUTSNoise(noise.z[i], noise.go_right[:, i],
                              noise.swap_u[:, i], noise.leaf_u[:, i])
        t0 = time.perf_counter()
        if dev == "cuda":
            tree = GraphedTree(vg, q, lp, g, noise, eps, m_inv, depth, 1000.0,
                               mass_chol=chol)
            o = tree(q, lp, g, noise, eps, m_inv, chol)
            eager = nuts_transition_flat(vg, q, lp, g, noise, eps, m_inv,
                                         max_depth=depth, mass_chol=chol)
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
                                     max_depth=depth, mass_chol=chol)
            vg_cpu = vg
        outs[dev] = [t.cpu() for t in o[:3]] + [t.cpu() for t in o[3]]
        print(f"{label}: {dev} transition {time.perf_counter() - t0:.2f} s"
              + (" (capture, replay and eager)" if dev == "cuda" else ""))
    c, h = outs["cuda"], outs["cpu"]
    if cpu_idx is not None:
        c = [t[torch.as_tensor(cpu_idx)] for t in c]
        R = len(cpu_idx)
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
    form there) and on the CPU eagerly on PARITY_CPU_ROWS of those rows
    (rows 8 i + i % 8): n_leapfrog, depth and divergence identical, q within
    1e-9 of the row's largest entry, and logp and grad within 1e-9 of the
    CPU's evaluation at the card's point, on at least 99.9% of the rows
    compared; every differing row is printed."""
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
    step = R // PARITY_CPU_ROWS
    idx = np.arange(PARITY_CPU_ROWS) * step + np.arange(PARITY_CPU_ROWS) % step
    bad = nuts_transition_parity(
        card, "parity nuts", R, NUTS_DEPTH, 6,
        lambda dev: nuts_rows(torch.float64, state, R, dev,
                              None if dev == "cuda" else idx), idx)
    if bad > 0.001 * PARITY_CPU_ROWS:
        raise AssertionError(f"parity nuts: {bad} of {PARITY_CPU_ROWS} "
                             "rows differ")


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
    forms = {"default": dict(max_iter=MAP_DEFAULT_ITER),
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
            "B": B,
            "rows": B * (1 if kw.get("init_from_ridge") else MAP_RESTARTS),
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
          f"(from 2000 and 1500); the float64 NUTS transition parity on "
          f"{SP_PARITY_NUTS_B * CHAINS} rows (256 until the ChEES phase "
          f"came, the smoke then 1,149.5 s on a slow host) [{card}]")
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
    row); (c) one NUTS transition (md8) of the first SP_PARITY_NUTS_B
    spectra's chains (R=256) from the sampled fit's final states, by
    nuts_transition_parity (phase 9's criterion), on at least 99.9% of
    rows."""
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
    f_ddt = freq[::2]       # all 81 points until the mesh phase came
    eps = 1.0 / np.mean(np.diff(np.log(tau)))
    for bc, sym in (("transmissive", "planar"), ("blocking", "planar"),
                    ("blocking", "spherical")):
        for dist_type in ("series", "parallel"):
            for ct in (False, True):
                a = {dev: [construct_A(
                    f_ddt, part, tau=tau, epsilon=eps, kernel="DDT",
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
    print(f"parity ddt A: 12 configurations x 2 parts, N={len(f_ddt)}, "
          f"K=81, float64,"
          f" largest |card - cpu| / max|A' + j A''| {worst:.3e} (of the "
          f"part's own largest entry: {worst_part:.3e}) "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    if worst > 1e-12:
        failed.append("ddt_A")

    f_desc = np.sort(freq)[::-1]
    zd = np.ascontiguousarray(zb[:SP_B_SAMPLE, np.argsort(freq)[::-1]])
    vgs, vgs_nuts = {}, {}
    r_nuts = SP_PARITY_NUTS_B * CHAINS
    for dev in ("cuda", "cpu"):
        _, _, _, cfg, dat, _ = batch._build_shared(
            f_desc, mode="sample", distributions=dists, nonneg=True,
            ncp=True, dtype=torch.float64, device=dev)
        _, tgt = batch._scaled_targets(zd, SP_B_SAMPLE, None, torch.float64,
                                       dev, dists)
        tgt = tgt.repeat_interleave(CHAINS, dim=0)
        vgs[dev] = posterior_value_and_grad(cfg, dat, tgt)
        vgs_nuts[dev] = posterior_value_and_grad(cfg, dat, tgt[:r_nuts])
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
    q0 = np.asarray(d["state_q"], np.float64).reshape(R, -1)[:r_nuts]
    m0 = np.asarray(d["state_inv_mass"], np.float64).reshape(R, -1)[:r_nuts]
    e0 = np.asarray(d["state_step_size"], np.float64).reshape(R)[:r_nuts]

    def rows(dev):
        q = torch.tensor(q0, device=dev)
        return (vgs_nuts[dev], q, *vgs_nuts[dev](q),
                torch.tensor(e0, device=dev), torch.tensor(m0, device=dev))

    bad = nuts_transition_parity(card, "parity sp nuts", r_nuts, SP_DEPTH,
                                 13, rows)
    if bad > 0.001 * r_nuts:
        failed.append("nuts")
    if failed:
        raise AssertionError(f"series-parallel parity failed: {failed}")


def phase_generic(card, state):
    """The generic SHMC sampler and fit_spectra_ragged: (1) generic SHMC on
    phase 11's Series-Parallel posterior at B=SP_B_SAMPLE; (2) float64
    parity of the generic trajectory (card graph replay against CPU eager
    on that posterior; the flat-chain kernel against the generic
    trajectory on its hand-written gradient); (3) fit_spectra_ragged on
    the ragged fleet in sample and MAP mode; (4) float64 card-vs-CPU
    parity of the ragged density and of the ragged DRT A. Returns the K2
    launches of (1) and (3)."""
    import torch
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    freq, dists, z_true, zb, tau, truth = sp_setup()
    failed = []
    launches = {"quad": 0, "traj": 0}

    def counted(fn, *args):
        drt_quad.launches = 0
        traj_fused.launches = 0
        out = fn(*args)
        launches["quad"] += drt_quad.launches
        launches["traj"] += traj_fused.launches
        return out

    sampled = counted(generic_sp_fit, card, freq, dists, z_true, zb, tau,
                      truth, failed)
    generic_traj_parity(card, freq, dists, zb, sampled, state, failed)
    counted(ragged_fits, card, failed)
    # K2: the Series-Parallel setup (the DRT's A, real and imaginary) and
    # one launch a part for each ragged fit
    want = {"quad": 2 + 2 + 2, "traj": 0}
    print(f"generic/ragged launches {launches} (expected {want}) [{card}]")
    if launches != want:
        failed.append("launches")
    ragged_parity(card, failed)
    if failed:
        raise AssertionError(f"generic SHMC / ragged phase failed: {failed}")
    return launches


def generic_sp_fit(card, freq, dists, z_true, zb, tau, truth, failed):
    """fit_spectra_batch(sampler='shmc') on the Series-Parallel posterior
    (the generic sampler: autograd, each draw's trajectory one CUDA graph
    replay) at B=SP_B_SAMPLE and the 'fast' preset's budget, with phase
    11's gates but SHMC's own divergence bar (SP_GATE_SHMC_DIV)."""
    import torch
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.parallel import batch
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     recompute_grad=True, eps_quantile=EPS_QUANTILE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = batch.fit_spectra_batch(
        freq, zb[:SP_B_SAMPLE], distributions=dists, nonneg=True,
        sigma_min=0.002, chains=CHAINS, warmup=WARMUP, samples=SAMPLES,
        ncp=True, sampler="shmc", shmc_cfg=cfg, escalate=False,
        gamma_eval_tau=tau, random_seed=3, timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    d = res.diagnostics
    fig = sp_figures(res, freq, z_true, tau, truth)
    div = float(np.median(d["divergence_rate"]))
    cov = float(np.mean((truth["drt"][None, :] >= d["gamma_eval_lo"])
                        & (truth["drt"][None, :] <= d["gamma_eval_hi"])))
    draw_s = np.asarray(d["draw_s"])
    flagged = int(batch.escalation_mask(
        d, SP_B_SAMPLE, n_draws=CHAINS * SAMPLES).sum())
    gates = {"finite": fig["finite"],
             "z_resid": fig["z_resid_median"] <= SP_GATE_Z,
             "divergence": div <= SP_GATE_SHMC_DIV,
             "drt_rmse": fig["drt_rmse"] <= SP_GATE_DRT_RMSE}
    rec = dict(B=SP_B_SAMPLE, budget=[CHAINS, WARMUP, SAMPLES],
               n_steps=N_STEPS, recompute_grad=True, wall_s=wall,
               phase_s=d["phase_s"], **fig, divergence_rate_median=div,
               drt_band_coverage=cov,
               min_ess_median=float(np.median(d["min_ess"])),
               min_ess_p10=float(np.percentile(d["min_ess"], 10)),
               logp_rhat_median=float(np.median(d["logp_rhat"])),
               capture_s=[float(x) for x in d["capture_s"]],
               draw_s_median=float(np.median(draw_s)),
               draw_s_warmup_median=float(np.median(draw_s[1:WARMUP])),
               fit_peak_gib=peak, escalation_flags=flagged,
               gates={k: bool(v) for k, v in gates.items()},
               drt_rmse_bar=SP_GATE_DRT_RMSE,
               divergence_bar=SP_GATE_SHMC_DIV,
               divergence_under_nuts_bar=div < SP_GATE_DIV)
    print("generic shmc series-parallel: " + json.dumps(rec) + f" [{card}]")
    failed += [f"generic_sp.{k}" for k, v in gates.items() if not v]
    KEEP["generic_sp"] = rec
    return res


def traj_rows_parity(card, label, got, want, vg_cpu, R):
    """Rows where a card trajectory and the CPU's agree: the same
    divergence flag, q within 1e-9 of the row's largest entry, logp and
    grad within 1e-9 of the CPU's evaluation at the card's selected point
    (phase 9's criterion). Prints the figures; returns the count that
    differ."""
    import torch
    c = [t.cpu() for t in got]
    h = [t.cpu() for t in want]

    def rel_rows(a, b):
        a, b = a.reshape(R, -1), b.reshape(R, -1)
        scale = torch.clamp(b.abs().max(dim=1).values, min=1.0)
        return (a - b).abs().max(dim=1).values / scale

    lp_at, g_at = vg_cpu(c[0])
    rel = {"q": rel_rows(c[0], h[0]), "logp": rel_rows(c[1], lp_at),
           "grad": rel_rows(c[2], g_at)}
    same = c[5] == h[5]
    for v in rel.values():
        same &= v <= 1e-9
    print(f"{label}: largest relative error over rows (q; logp, grad at "
          "the card's point): "
          + ", ".join(f"{k} {float(v.max()):.2e}" for k, v in rel.items())
          + f"; {int(same.sum())}/{R} rows agree ({int(c[5].sum())} "
          f"diverged on the card) [{card}]")
    return int((~same).sum())


def generic_traj_parity(card, freq, dists, zb, sampled, state, failed):
    """float64: (a) one Series-Parallel trajectory (n_leap = N_STEPS,
    recompute_grad) at R = SP_B_SAMPLE x CHAINS from the generic fit's
    final states with numpy-made p0, u_sel and split, replayed as a CUDA
    graph on the card (bit for bit the eager form there) against eager on
    the CPU, with the graph capture's memory; (b) the flat-chain kernel
    against the generic trajectory on its hand-written gradient (as a
    graph) at the main path's R and final states."""
    import torch
    from bayes_drt_tpu_torch.infer.chees import (GraphedTrajectory,
                                                 shmc_trajectory)
    from bayes_drt_tpu_torch.infer.shmc_flat import (flat_value_and_grad,
                                                     traj_fused)
    from bayes_drt_tpu_torch.models.posterior import posterior_value_and_grad
    from bayes_drt_tpu_torch.parallel import batch
    torch.set_num_threads(8)
    R = SP_B_SAMPLE * CHAINS
    d = sampled.diagnostics
    q_np = np.asarray(d["state_q"], np.float64).reshape(R, -1)
    m_np = np.asarray(d["state_inv_mass"], np.float64).reshape(R, -1)
    e_np = np.asarray(d["state_step_size"], np.float64).reshape(R)
    rng = np.random.default_rng(21)
    p_np = rng.standard_normal(q_np.shape) / np.sqrt(m_np)
    u_np = rng.uniform(size=(N_STEPS, R))
    j = int(rng.integers(0, N_STEPS + 1))
    f_desc = np.sort(freq)[::-1]
    zd = np.ascontiguousarray(zb[:SP_B_SAMPLE, np.argsort(freq)[::-1]])
    outs, vgs = {}, {}
    for dev in ("cuda", "cpu"):
        _, _, _, cfg, dat, _ = batch._build_shared(
            f_desc, mode="sample", distributions=dists, nonneg=True,
            ncp=True, dtype=torch.float64, device=dev)
        _, tgt = batch._scaled_targets(zd, SP_B_SAMPLE, None, torch.float64,
                                       dev, dists)
        vg = posterior_value_and_grad(cfg, dat, tgt.repeat_interleave(
            CHAINS, dim=0))
        vgs[dev] = vg

        def t(a):
            return torch.tensor(a, device=dev)

        q = t(q_np)
        lp, g = vg(q)
        args = (q, t(p_np), g, lp, t(e_np), t(m_np), j, t(u_np))
        t0 = time.perf_counter()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tr = GraphedTrajectory(vg, N_STEPS, 1000.0, True, *args)
            torch.cuda.synchronize()
            cap_s = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            o = tr(*args)
            eager = shmc_trajectory(vg, N_STEPS, 1000.0, *args,
                                    recompute_grad=True)
            torch.cuda.synchronize()
            replay_ms = cuda_ms(lambda: tr(*args), 3)
            del tr
            if not all(torch.equal(a, b) for a, b in zip(o, eager)):
                failed.append("generic_traj.graph_vs_eager")
            print(f"generic traj sp: R={R}, D={q_np.shape[1]}, n_leap="
                  f"{N_STEPS}, j={j}, float64: capture {cap_s:.2f} s, "
                  f"graph pool peak {peak:.3f} GiB, replay {replay_ms:.2f}"
                  f" ms; replay equals eager bit for bit: "
                  f"{'generic_traj.graph_vs_eager' not in failed} [{card}]")
        else:
            o = shmc_trajectory(vg, N_STEPS, 1000.0, *args,
                                recompute_grad=True)
            print(f"generic traj sp: cpu eager {time.perf_counter() - t0:.1f}"
                  " s")
        outs[dev] = o
    bad = traj_rows_parity(card, "generic traj sp card vs cpu", outs["cuda"],
                           outs["cpu"], vgs["cpu"], R)
    if bad > 0.001 * R:
        failed.append("generic_traj.card_vs_cpu")

    # (b) K1 against the generic trajectory on flat_value_and_grad
    args = args_f64(traj_inputs(torch.float32, state=state))
    spec, n_leap, max_e, sh, q, p0, g, lp, eps, m_inv, tgt, j, u = args

    def vg_flat(x):
        return flat_value_and_grad(spec, sh.A, sh.L, sh.vecs, sh.scal, x,
                                   tgt)

    lp, g = vg_flat(q)
    args = (spec, n_leap, max_e, sh, q, p0, g, lp, eps, m_inv, tgt, j, u)
    k1 = traj_fused(*args)
    tr = GraphedTrajectory(vg_flat, n_leap, max_e, False, q, p0, g, lp, eps,
                           m_inv, j, u)
    gen = tr(q, p0, g, lp, eps, m_inv, j, u)
    g_at = vg_flat(k1[0])[1]
    torch.cuda.synchronize()
    del tr
    where = f"R={q.shape[0]}, D={spec.D}, j={j}"
    try:
        for nm, a, b in zip(["q", "logp", "kin", "sacc"],
                            (k1[0], k1[1], k1[3], k1[4]),
                            (gen[0], gen[1], gen[3], gen[4])):
            check_close(f"K1 vs generic traj f64 {nm} ({where})", a, b,
                        1e-9, 1e-9)
        # the gradient at the kernel's own selected point: from these
        # stiff states the two summation orders' ~1e-16 in q become ~1e-9
        # relative in the gradient (phase 9's note)
        g_err = check_close(f"K1 grad at its point ({where})", k1[2], g_at,
                            1e-9, 1e-9)
        g_gap = float((k1[2] - gen[2]).abs().max())
        if not torch.equal(k1[5], gen[5]):
            raise AssertionError("K1 vs generic traj: divergence flags "
                                 "differ")
        print(f"K1 vs generic trajectory (graph) f64 at the main path's "
              f"final states: q, logp, kin, sacc within rtol/atol 1e-9, "
              f"K1's grad within {g_err:.2e} of the gradient at its point "
              f"(of the generic run's grad: {g_gap:.2e}) at {where} "
              f"[{card}]")
    except AssertionError as e:
        print(str(e))
        failed.append("generic_traj.k1")


def ragged_fits(card, failed):
    """fit_spectra_ragged on the ragged fleet (RG_B spectra, numpy seed
    RG_SEED): sample mode with generic SHMC at the ragged bench's
    configuration and budget, and MAP in the default form (2 restarts, cap
    2000, no polish), gated on finite coefficients, ordered bands, the
    batch-mean gamma RMSE and the per-spectrum p90 against the analytic
    ZARC DRT."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.parallel import (evaluate_gamma,
                                              fit_spectra_ragged)
    fleet = sim.make_ragged_fleet(RG_B, RG_SEED)
    lens = np.array([len(f) for f, _ in fleet])
    # the fit's default basis (10 ppd over the union, a decade each side)
    f_all = np.concatenate([f for f, _ in fleet])
    tmin = np.log10(1 / (2 * np.pi * f_all.max())) - 1
    tmax = np.log10(1 / (2 * np.pi * f_all.min())) + 1
    tau = np.logspace(tmin, tmax, int(10 * (tmax - tmin) + 1))
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    print(f"ragged fleet: B={RG_B}, n in [{lens.min()}, {lens.max()}] (mean "
          f"{lens.mean():.1f}), K={len(tau)}")
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS, leaf_unroll=2,
                     draw_unroll=2, recompute_grad=True,
                     eps_quantile=EPS_QUANTILE)
    for name, kw in (("sample", dict(mode="sample", chains=CHAINS,
                                     warmup=WARMUP, samples=SAMPLES,
                                     ncp=True, sampler="shmc",
                                     shmc_cfg=cfg, gamma_eval_tau=tau)),
                     ("map", dict(mode="optimize"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_spectra_ragged(fleet, random_seed=1, timing=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = res.diagnostics
        g = evaluate_gamma(res, tau)
        per = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
        rmse = float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2))) / rp
        p90 = float(np.percentile(per, 90)) / rp
        finite = bool(np.isfinite(res.coef).all())
        rec = dict(B=RG_B, wall_s=wall, spectra_per_min=RG_B / (wall / 60),
                   phase_s=d["phase_s"], rmse_over_rp=rmse, p90_over_rp=p90,
                   K=len(res.tau), n_max=int(d["z_hat_mean"].shape[1] // 2)
                   if "z_hat_mean" in d else None)
        if name == "sample":
            ordered = bool((res.gamma_lo <= res.gamma_hi).all()
                           and (d["gamma_eval_lo"] <= d["gamma_eval_hi"])
                           .all())
            draw_s = np.asarray(d["draw_s"])
            rec.update(
                budget=[CHAINS, WARMUP, SAMPLES],
                coverage=float(np.mean((gt[None, :] >= d["gamma_eval_lo"])
                                       & (gt[None, :]
                                          <= d["gamma_eval_hi"]))),
                min_ess_median=float(np.median(d["min_ess"])),
                logp_rhat_median=float(np.median(d["logp_rhat"])),
                divergence_rate=float(np.mean(d["divergence_rate"])),
                capture_s=[float(x) for x in d["capture_s"]],
                draw_s_median=float(np.median(draw_s)))
            gates = {"finite": finite, "ordered": ordered,
                     "rmse": rmse < GATE_RMSE, "p90": p90 < GATE_P90}
        else:
            n_it = float(np.max(d["n_iter"]))
            rec.update(restarts=MAP_RESTARTS, cap=MAP_ITER,
                       lbfgs_iters=int(n_it),
                       s_per_lbfgs_iter=d["phase_s"]["lbfgs"] / n_it,
                       converged_share=float(np.mean(d["converged"])))
            gates = {"finite": finite, "rmse": rmse < MAP_GATE_RMSE,
                     "p90": p90 < MAP_GATE_P90}
        rec["gates"] = {k: bool(v) for k, v in gates.items()}
        print(f"ragged {name}: " + json.dumps(rec) + f" [{card}]")
        failed += [f"ragged_{name}.{k}" for k, v in gates.items() if not v]


def ragged_parity(card, failed):
    """float64 on the card against the CPU: (a) the masked per-spectrum
    log density and gradient of R = 64 x CHAINS numpy-made rows of the
    ragged fleet's first 64 spectra (the card's data copied to the CPU;
    logp within 1e-10 relative, gradient normwise within 1e-9 a row); (b)
    the ragged DRT A from the quadrature kernel against its plain version
    on the first 8 spectra's padded grids, within 1e-12 of the largest
    entry; and K2's time at the fleet's whole ragged launch beside its
    bound."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.models.posterior import posterior_value_and_grad
    from bayes_drt_tpu_torch.ops.matrices import _quad_grid, construct_A
    from bayes_drt_tpu_torch.ops.quad import drt_quad, drt_quad_plain
    from bayes_drt_tpu_torch.parallel import batch
    fleet = sim.make_ragged_fleet(RG_B, RG_SEED)
    cfg, dat, tgt, _, _, (tau, eps, _) = batch._ragged_setup(
        fleet, "sample", None, None, False, False, None, "gaussian", 0.002,
        True, torch.float64, "cuda")
    nb, n_max = 64, dat.freq.shape[1]
    R = nb * CHAINS
    q = np.random.default_rng(31).uniform(-2.0, 2.0, (R, 2 * len(tau) + 9))
    res = {}
    first = dat._replace(A=tuple(a[:nb] for a in dat.A),
                         freq=dat.freq[:nb], lik_mask=dat.lik_mask[:nb])
    for dev in ("cuda", "cpu"):
        d_dev = type(dat)(*(
            tuple(a.to(dev) for a in f) if isinstance(f, tuple)
            else f.to(dev) if isinstance(f, torch.Tensor) else f
            for f in first))
        vg = posterior_value_and_grad(cfg, d_dev, tgt[:nb].to(dev)
                                      .repeat_interleave(CHAINS, dim=0))
        res[dev] = [x.cpu() for x in vg(torch.tensor(q, device=dev))]
    lp_rel = float(((res["cuda"][0] - res["cpu"][0]).abs()
                    / res["cpu"][0].abs()).max())
    g_rel = float((torch.linalg.norm(res["cuda"][1] - res["cpu"][1], dim=1)
                   / torch.linalg.norm(res["cpu"][1], dim=1)).max())
    print(f"parity ragged density: {nb} spectra (padded grids of {n_max}), "
          f"R={R}, D={q.shape[1]}, float64: logp largest relative "
          f"difference {lp_rel:.3e}, grad largest normwise relative "
          f"difference {g_rel:.3e} [{card}]")
    if lp_rel > 1e-10 or g_rel > 1e-9:
        failed.append("ragged_parity.density")

    fp = dat.freq[:8].reshape(-1).cpu().numpy()
    worst = 0.0
    for part in ("real", "imag"):
        a = construct_A(fp, part, tau=tau, epsilon=eps, device="cuda").cpu()
        h = construct_A(fp, part, tau=tau, epsilon=eps, device="cpu")
        worst = max(worst, float((a - h).abs().max() / h.abs().max()))
    print(f"parity ragged A: 8 spectra x {n_max} padded frequencies, K="
          f"{len(tau)}, float64, largest |card - cpu| / max|A| {worst:.3e}"
          f" [{card}]")
    if worst > 1e-12:
        failed.append("ragged_parity.A")

    # K2 at the whole fleet's ragged launch: every spectrum's padded grid
    # as one (B * n_max, K) block of log-offsets
    f_all = dat.freq.reshape(-1)
    s = torch.log(2 * math.pi * f_all[:, None]
                  * torch.as_tensor(tau, device="cuda")[None, :])
    y, w = _quad_grid(1000, 20.0, torch.float64, "cuda")
    phiw = torch.exp(-((eps * y) ** 2)) * w
    before = drt_quad.launches
    ms = cuda_ms(lambda: drt_quad(s, y, phiw, "imag"), 5)
    drt_quad.launches = before
    rows, k = s.shape
    sub = s[:8 * n_max]
    plain_ms = cuda_ms(lambda: drt_quad_plain(sub, y, phiw, "imag"), 3) \
        * rows / sub.shape[0]
    ops_s = rows * k * 1000 * QUAD_FP64_MIN_PER_NODE / (PEAK_FP64_S / 2)
    bytes_s = 8.0 * (2 * rows * k + 2 * 1000) / PEAK_BYTES_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    print(f"quad ragged launch: rows={rows} (B={RG_B} x n_max="
          f"{n_max}), K={k}, Q=1000, float64 imag: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms (timed on 8 spectra, "
          f"scaled by rows), bound {bound_ms:.3f} ms (operations), kernel "
          f"at {100 * bound_ms / ms:.1f}% of it [{card}]")


def inverter_gamma(inv, tau_gt, rp):
    """gamma RMSE of an Inverter fit against the ZARC truth, of Rp."""
    from bayes_drt_tpu_torch import sim
    g = inv.predict_distribution(eval_tau=tau_gt)
    return float(np.sqrt(np.mean((g - sim.zarc_drt(tau_gt, 1e-3, 0.8))
                                 ** 2)) / rp)


def inverter_ridge_options(card, freq, z, tau_gt, rp, failed):
    """(a) Inverter.ridge_fit on the card for each option family, each held
    in float64 to the same fit on the CPU (coefficients within INV_TOL of
    the largest; INV_TOL_HYPER_A with the hyper-a update; the phase-offset
    search to its stopping rule), its seconds printed; the default fit in
    the default float32 gated as the JAX package's ridge quick-start."""
    import torch
    from bayes_drt_tpu_torch import Inverter, sim
    ie = np.repeat([0, 1, 2], [27, 27, 27])
    off = np.where(ie == 1, 2.0, np.where(ie == 2, -1.5, 0.0))
    z_off = np.abs(z) * np.exp(1j * np.radians(np.angle(z, deg=True) + off))
    bp = {"DDT": {"kernel": "DDT", "bc": "blocking",
                  "basis_freq": np.logspace(6, -3, 91)}}
    z_bp = sim.noisy_replicas(
        1 + sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc="blocking"), 1, 0.0025,
        SP_SEED + 1)[0]
    cases = {name: (None, z, kw) for name, kw in INV_RIDGE_CASES.items()}
    cases["phase_offset"] = (None, z_off, dict(correct_phase_offset=True,
                                               IERange=ie))
    cases["blocking_ddt_admittance"] = (bp, z_bp, dict(
        penalty="integral", lambda_0=1.0, hl_beta=5, weights="modulus"))
    out = {}
    for name, (dists, z_in, kw) in cases.items():
        kw = dict(kw)
        fi = kw.pop("fit_inductance", True)
        fits = {}
        for dev in ("cuda", "cpu"):
            inv = Inverter(distributions=dists, fit_inductance=fi,
                           device=dev, dtype=torch.float64)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inv.ridge_fit(freq, z_in, **kw)
                torch.cuda.synchronize()
            fits[dev] = (inv, time.perf_counter() - t0)
        (g, t_card), (w, t_cpu) = fits["cuda"], fits["cpu"]
        nm = list(g.distribution_fits)[0]
        cg, cw = g.distribution_fits[nm]["coef"], w.distribution_fits[nm][
            "coef"]
        err = float(np.abs(cg - cw).max() / np.abs(cw).max())
        tol = INV_TOL_HYPER_A if kw.get("hyper_a") else INV_TOL
        ok = err <= tol and abs(g.R_inf - w.R_inf) <= tol * np.abs(cw).max()
        if name == "phase_offset":
            # the alternation stops at xtol = 1e-3 degrees, scipy's BFGS at
            # an L1 kink: held to the stopping rule
            tol = 1e-2
            ok = bool(np.abs(g.phase_offsets - w.phase_offsets).max()
                      <= tol and err <= tol)
        out[name] = {"card_s": t_card, "cpu_s": t_cpu, "coef_err": err,
                     "tol": tol}
        if not ok:
            failed.append(f"ridge.{name}")
    # the default call: float32 on the card
    inv = Inverter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inv.ridge_fit(freq, z)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    zhat = inv.predict_Z(freq)
    fig = {"card_s": wall, "rmse_over_rp": inverter_gamma(inv, tau_gt, rp),
           "z_resid_median": float(np.median(np.abs(zhat - z) / np.abs(z))),
           "r2": inv.score(freq, z, metric="r2")}
    gates = {"rmse": fig["rmse_over_rp"] < 0.05,
             "z_resid": fig["z_resid_median"] < 0.02, "r2": fig["r2"] > 0.99}
    fig["gates"] = gates
    out["default_float32"] = fig
    failed += [f"ridge.default.{k}" for k, v in gates.items() if not v]
    print("inverter ridge options (card float64 vs CPU float64): "
          + json.dumps(out) + f" [{card}]")


def inverter_batch_ridge(card, failed):
    """(b) ridge_fit_spectra_batch on the main path's 1024 spectra with the
    Re-Im cross-validation over the default 31-lambda grid and with the
    hyper-weights ridge (float32), gated on batch-mean RMSE and p90 (the
    CV fit against the JAX package's own CV figures); then float64
    card-vs-CPU parity of both on 8 spectra (the CV over
    INV_CV_PARITY_GRID)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.parallel import ridge_fit_spectra_batch
    freq, zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    modes = {"cv": dict(cv_lambdas=INV_CV_GRID),
             "hyper_weights": dict(hyper_lambda=False, hyper_weights=True)}
    parity = dict(modes, cv=dict(cv_lambdas=INV_CV_PARITY_GRID))
    out = {}
    for name, kw in modes.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ridge_fit_spectra_batch(freq, zb, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        gt = sim.reference_gamma("ZARC", res.tau)
        rmse, p90 = map_figures(res, res.tau, gt,
                                np.trapezoid(gt, np.log(res.tau)))
        rec = {"B": B, "wall_s": wall, "rmse_over_rp": rmse,
               "p90_over_rp": p90,
               "finite": bool(np.isfinite(res.coef).all())}
        if name == "cv":
            # the figures of scripts/jax_ridge_cv_reference.py: over the
            # 1024 and over the first 16
            lam = res.diagnostics["cv_lambda"]
            grid = np.asarray(INV_CV_GRID, np.float32)
            rec["first16"] = dict(zip(("rmse_over_rp", "p90_over_rp"),
                                      map_figures(
                                          res._replace(coef=res.coef[:16]),
                                          res.tau, gt, np.trapezoid(
                                              gt, np.log(res.tau)))))
            rec["boundary_low"] = int(np.sum(lam == grid[0]))
            rec["boundary_high"] = int(np.sum(lam == grid[-1]))
            rec["cv_lambda_median"] = float(np.median(lam))
            rec["jax_cpu"] = INV_JAX_CV
            rec["warnings"] = [str(w.message) for w in caught]
        bars = ((INV_GATE_CV_RMSE, INV_GATE_CV_P90) if name == "cv"
                else (INV_GATE_RMSE, INV_GATE_P90))
        gates = {"finite": rec["finite"], "rmse": rmse < bars[0],
                 "p90": p90 < bars[1]}
        rec["bars"] = bars
        rec["gates"] = gates
        out[name] = rec
        failed += [f"batch_ridge.{name}.{k}" for k, v in gates.items()
                   if not v]
    # float64 parity on 8 spectra
    for name, kw in parity.items():
        got = ridge_fit_spectra_batch(freq, zb[:INV_PARITY_B],
                                      dtype=torch.float64, **kw)
        want = ridge_fit_spectra_batch(freq, zb[:INV_PARITY_B],
                                       dtype=torch.float64, device="cpu",
                                       **kw)
        err = float(np.abs(got.coef - want.coef).max()
                    / np.abs(want.coef).max())
        rec = {"coef_err": err}
        ok = err <= INV_TOL
        if name == "cv":
            same = bool(np.array_equal(got.diagnostics["cv_lambda"],
                                       want.diagnostics["cv_lambda"]))
            rec["cv_index_equal"] = same
            ok = ok and same
        else:
            w_err = float(np.abs(got.diagnostics["weights_re"]
                                 - want.diagnostics["weights_re"]).max()
                          / np.abs(want.diagnostics["weights_re"]).max())
            rec["weights_err"] = w_err
            ok = ok and w_err <= INV_TOL
        out[name]["parity_f64"] = rec
        if not ok:
            failed.append(f"batch_ridge.{name}.parity")
    print("inverter batched ridge: " + json.dumps(out) + f" [{card}]")


def inverter_qp_tail(card, failed):
    """(b) The box QP's CUDA-graph tail against its eager loop: the first
    QP of the Re-Im CV on the main path's first INV_QP_B spectra over
    INV_QP_GRID in float64 on the card, whose rows all pivot to their
    iteration cap, solved again with the tail graphed (the default past
    nnls._QP_GRAPH_AFTER iterations) and eagerly (_QP_GRAPH_AFTER past
    the cap): equal iteration counts and final active sets, x within
    INV_QP_TOL of the largest; and the graph's replays bit for bit the
    tail's own steps run eagerly from the state the tail was handed; the
    seconds of both solves."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer import nnls, ridge
    from bayes_drt_tpu_torch.parallel import ridge_fit_spectra_batch
    freq, zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    solve = ridge.solve_qp_box
    seen = []

    class Cycling(Exception):
        pass

    def spy(P, q, lb, ub, max_iter=100, tol=1e-10, warm_sets=None):
        res = solve(P, q, lb, ub, max_iter=max_iter, tol=tol,
                    warm_sets=warm_sets)
        if int(res.n_iter.max()) > nnls._QP_GRAPH_AFTER:
            seen.append((P, q, lb, ub, max_iter, tol, warm_sets))
            raise Cycling
        return res

    ridge.solve_qp_box = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ridge_fit_spectra_batch(freq, zb[:INV_QP_B],
                                    cv_lambdas=INV_QP_GRID,
                                    dtype=torch.float64)
    except Cycling:
        pass
    finally:
        ridge.solve_qp_box = solve
    if not seen:
        failed.append("qp_tail.no_cycling_rows")
        return
    P, q, lb, ub, max_iter, tol, warm = seen[0]
    tails = []
    graphed_tail = nnls._graphed_tail

    def tail_spy(*args):
        out = graphed_tail(*args)
        tails.append((args[:-1], nnls._PivotState(
            *(t.clone() for t in args[-1])), out))
        return out

    def run(args, warm_sets):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = nnls.solve_qp_box(*args, max_iter=max_iter, tol=tol,
                              warm_sets=warm_sets)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    nnls._graphed_tail = tail_spy
    try:
        graphed, t_graphed = run((P, q, lb, ub), warm)
    finally:
        nnls._graphed_tail = graphed_tail
    after = nnls._QP_GRAPH_AFTER
    nnls._QP_GRAPH_AFTER = max_iter + 1
    try:
        eager, t_eager = run((P, q, lb, ub), warm)
    finally:
        nnls._QP_GRAPH_AFTER = after
    # the tail's own steps run eagerly from the state it was handed
    args, sub, out = tails[0]
    n, st, step = nnls._padded_tail(*args, sub)
    while bool(((st.it[:n] < max_iter) & ~st.done[:n]).any()):
        step()
    tail_bitwise = all(bool(torch.equal(a, b[:n])) for a, b in zip(out, st))

    def same(a, b):
        return bool(torch.equal(a.n_iter, b.n_iter)
                    and torch.equal(a.at_lb, b.at_lb)
                    and torch.equal(a.at_ub, b.at_ub))

    err = float((graphed.x - eager.x).abs().max() / eager.x.abs().max())
    gates = {"n_iter_and_sets": same(graphed, eager),
             "x": err <= INV_QP_TOL, "tail_replay_bitwise": tail_bitwise}
    rec = {"rows": int(q.shape[0]), "tail_rows": int(sub.x.shape[0]),
           "tail_padded_rows": int(st.x.shape[0]), "K": int(q.shape[1]),
           "max_iter": max_iter, "tail_start_iter": int(sub.it.min()),
           "n_iter_max": int(eager.n_iter.max()), "x_err": err,
           "graphed_s": t_graphed, "eager_s": t_eager, "gates": gates}
    print("inverter QP tail (float64, graphed vs eager): "
          + json.dumps(rec) + f" [{card}]")
    failed += [f"qp_tail.{k}" for k, v in gates.items() if not v]


def inverter_parallel_escalation(card, failed):
    """(c) The repaired fault: phase 11's single parallel blocking-DDT
    spectra (INV_ESC_B of them) through fit_spectra_batch's default
    escalation with sampler='shmc' at a cut budget, the gate forced to
    flag every spectrum, so each is refitted by NUTS md8 from the
    Inverter's admittance ridge seed (run on the card); gated on finite
    coefficients, every row spliced and the median Z residual."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.parallel import batch, predict_Z_batch
    freq = np.logspace(6, -2, 81)
    bp = {"DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "blocking",
                  "dist_type": "parallel",
                  "basis_freq": np.logspace(6, -3, 91)}}
    z_bp = 1 + sim.z_ddt_cole_cole(freq, 0.1, 0.8, bc="blocking")
    zb = sim.noisy_replicas(z_bp, SP_B_SMALL, 0.0025,
                            SP_SEED + 1)[:INV_ESC_B]
    print(f"inverter escalation: B={INV_ESC_B} of phase 11's blocking-DDT "
          f"spectra, budget cut to {CHAINS}x({INV_ESC_WARMUP}+"
          f"{INV_ESC_SAMPLES}) from the default {CHAINS}x(500+500) "
          f"[{card}]")
    seen = {}
    splice = batch._splice_results

    def spy(result, sub, mask):
        seen.update(sub=sub, mask=mask)
        return splice(result, sub, mask)

    batch._splice_results = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = batch.fit_spectra_batch(
                freq, zb, distributions=bp, sampler="shmc", chains=CHAINS,
                warmup=INV_ESC_WARMUP, samples=INV_ESC_SAMPLES,
                random_seed=3, escalate_gate=dict(ess_bulk_min=np.inf),
                timing=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        batch._splice_results = splice
    sub = seen["sub"]
    zhat = predict_Z_batch(res, freq)
    resid = float(np.median(np.abs(zhat - z_bp[None, :])
                            / np.abs(z_bp)[None, :]))
    spliced = bool(seen["mask"].all() and res.diagnostics["escalated"].all()
                   and np.array_equal(res.coef, sub.coef))
    gates = {"finite": bool(np.isfinite(res.coef).all()
                            and np.isfinite(zhat).all()),
             "spliced": spliced, "z_resid": resid <= SP_GATE_Z}
    draw_s = np.asarray(sub.diagnostics["draw_s"])
    rec = {"B": INV_ESC_B, "budget": [CHAINS, INV_ESC_WARMUP,
                                      INV_ESC_SAMPLES],
           "wall_s": wall, "refit_s": res.diagnostics["refit_s"],
           "ridge_seed_s": sub.diagnostics["phase_s"]["ridge"],
           "refit_phase_s": sub.diagnostics["phase_s"],
           "nuts_first_draw_s": float(draw_s[0]),
           "nuts_draw_s_median": float(np.median(draw_s[1:])),
           "z_resid_median": resid, "jax_cpu_z_resid_median":
               INV_JAX_ESC_RESID, "gates": gates}
    print("inverter escalation: " + json.dumps(rec) + f" [{card}]")
    failed += [f"escalation.{k}" for k, v in gates.items() if not v]


def inverter_fits(card, freq, z, tau_gt, rp, failed):
    """(d) Inverter.fit on the card (float32): the default MAP (2
    restarts, cap 4000, polish) twice on two same-shape spectra, NUTS
    md10 at a cut budget on the second spectrum, then at the JAX
    package's Inverter test warmup on the first (so the second NUTS fit
    has the first one's shape and other data: a cache hit, its first draw
    within 2x its median, no capture), SHMC at the default budget (both
    samplers non-centered);
    each gated as the JAX package's Inverter tests gate them (ess_min >
    INV_GATE_ESS_MIN; rhat_max < INV_GATE_RHAT_MAX at the test warmup);
    check_outliers on a corrupted point; a save/load round trip through
    pickle predicting the same Z bit for bit."""
    import pickle
    from bayes_drt_tpu_torch import Inverter, progcache, sim
    _, zb2 = sim.make_benchmark_batch(2, circuit="ZARC", noise_level=0.0025,
                                      seed=INV_SEED + 1)
    print(f"inverter fits: NUTS md10 budget cut to 2x({INV_NUTS_WARMUP}+"
          f"{INV_NUTS_SAMPLES}) and, once, to the JAX package's Inverter "
          f"test warmup 2x({INV_NUTS_TEST_WARMUP}+{INV_NUTS_TEST_SAMPLES}) "
          f"(the test's 2x(120+120) until the resume phase came), from "
          f"2x(200+200); SHMC at the default 2x(200+200) [{card}]")
    out = {}
    runs = (("map", z, {}), ("map_second", zb2[0], {}),
            ("nuts", zb2[0], dict(mode="sample", warmup=INV_NUTS_WARMUP,
                                  samples=INV_NUTS_SAMPLES, ncp=True)),
            ("nuts_test_budget", z, dict(mode="sample",
                                         warmup=INV_NUTS_TEST_WARMUP,
                                         samples=INV_NUTS_TEST_SAMPLES,
                                         ncp=True)),
            ("shmc", z, dict(mode="sample", sampler="shmc", ncp=True)))
    fits = {}
    for name, z_in, kw in runs:
        inv = Inverter()
        misses = progcache.stats()["misses"]
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inv.fit(freq, z_in, **kw)
        wall = time.perf_counter() - t0
        fits[name] = inv
        rec = {"wall_s": wall, "stages_s": inv.timings.summary(),
               "rmse_over_rp": inverter_gamma(inv, tau_gt, rp),
               "R_inf": inv.R_inf}
        gates = {"rmse": rec["rmse_over_rp"] < 0.08,
                 "R_inf": abs(inv.R_inf - 1.0) < 0.05}
        if inv.fit_type == "map":
            m = inv._map_result
            rec.update(polish_iters=int(m.n_iter) - inv._map_n_iter_lbfgs,
                       lbfgs_iters=inv._map_n_iter_lbfgs,
                       converged=bool(m.converged),
                       grad_norm=float(m.grad_norm))
        else:
            sd = inv.sample_diagnostics
            draw_s = np.asarray(sd["draw_s"])
            lo = inv.predict_distribution(eval_tau=tau_gt, percentile=2.5)
            hi = inv.predict_distribution(eval_tau=tau_gt, percentile=97.5)
            gates["bands_ordered"] = bool(np.all(hi >= lo - 1e-12))
            rec.update(first_draw_s=float(draw_s[0]),
                       draw_s_median=float(np.median(draw_s[1:])),
                       capture_s=sd["capture_s"],
                       rhat_max=sd["rhat_max"], ess_min=sd["ess_min"],
                       divergence_rate=sd["divergence_rate"],
                       n_leapfrog=sd["n_leapfrog"])
            gates["ess_min"] = sd["ess_min"] > INV_GATE_ESS_MIN
            if name == "nuts_test_budget":
                # the second same-shape NUTS fit: a cache hit, whose first
                # draw captures nothing
                gates["rhat_max"] = sd["rhat_max"] < INV_GATE_RHAT_MAX
                gates["cache_hit"] = progcache.stats()["misses"] == misses
                gates["no_capture"] = float(sd["capture_s"]) == 0.0
                gates["first_draw_within_2x_median"] = bool(
                    draw_s[0] <= 2.0 * np.median(draw_s))
        rec["gates"] = {k: bool(v) for k, v in gates.items()}
        out[name] = rec
        failed += [f"fit.{name}.{k}" for k, v in gates.items() if not v]
    # check_outliers on the card: the JAX package's test corrupts index 25
    zc = z.copy()
    zc[25] *= 1.0 + 0.5j
    idx = Inverter().check_outliers(freq, zc, threshold=3.5)
    out["check_outliers"] = {"flagged": idx.ravel().tolist()}
    if 25 not in set(idx.ravel()):
        failed.append("check_outliers")
    # save/load round trip through pickle
    inv = fits["map"]
    restored = Inverter()
    restored.load_fit_data(pickle.loads(pickle.dumps(inv.save_fit_data())))
    same = bool(np.array_equal(restored.predict_Z(freq), inv.predict_Z(freq))
                and np.array_equal(restored.predict_sigma(freq)[0],
                                   inv.predict_sigma(freq)[0]))
    out["save_load_bitwise"] = same
    if not same:
        failed.append("save_load")
    print("inverter fits: " + json.dumps(out) + f" [{card}]")


def phase_inverter(card):
    """The Inverter (phase 13): (a) ridge options, (b) the batched ridge's
    CV and hyper-weights modes, (c) the single-parallel ridge seed through
    the default escalation, (d) MAP and sampled fits, outliers and
    save/load. Returns the kernels' launches on its driven paths (K2 in
    every DRT A that the Inverter and the batched ridge build on the card;
    no K1: the Inverter samples with the generic samplers)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    freq, zb = sim.make_benchmark_batch(1, circuit="ZARC",
                                        noise_level=0.0025, seed=INV_SEED)
    z = zb[0]
    tau_gt = np.logspace(-7, 2, 200)
    rp = float(np.trapezoid(sim.zarc_drt(np.logspace(-9, 4, 2000), 1e-3,
                                         0.8), np.log(np.logspace(-9, 4,
                                                                  2000))))
    failed = []
    drt_quad.launches = 0
    traj_fused.launches = 0
    t0 = time.perf_counter()
    inverter_ridge_options(card, freq, z, tau_gt, rp, failed)
    t_a = time.perf_counter()
    inverter_batch_ridge(card, failed)
    inverter_qp_tail(card, failed)
    t_b = time.perf_counter()
    inverter_parallel_escalation(card, failed)
    t_c = time.perf_counter()
    inverter_fits(card, freq, z, tau_gt, rp, failed)
    t_d = time.perf_counter()
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    print("inverter phase: " + json.dumps({
        "seconds": {"ridge_options": t_a - t0, "batch_ridge": t_b - t_a,
                    "escalation": t_c - t_b, "fits": t_d - t_c,
                    "total": t_d - t0},
        "launches": launches}) + f" [{card}]")
    if launches["quad"] == 0 or launches["traj"] != 0:
        failed.append("launches")
    if failed:
        raise AssertionError(f"inverter phase failed: {failed}")
    return launches


def drift_fleet(card, failed):
    """(a) the drift bench's fleet through drift_fit_spectra_batch, once
    (random_seed 1, whose median the JAX package's own figure is taken
    at; random_seed 0 ran too until the SBC and CLI phase came, 21 s on
    an NVIDIA H100 80GB HBM3 at 700 W), gated; then its serial line: one
    Inverter.drift_map_fit of cell 0 with the same arguments, once (twice
    until the resume phase came: 11.18 and 11.00 s, its L-BFGS graphs
    costing ~0.2 s to capture, on an NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch
    from bayes_drt_tpu_torch import Inverter, sim
    from bayes_drt_tpu_torch.parallel import drift_fit_spectra_batch
    freq, times, zb = sim.make_drift_fleet(DRIFT_B, seed=0)
    out, walls = {}, []
    for seed in (1,):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = drift_fit_spectra_batch(freq, times, zb, random_seed=seed,
                                      timing=True, **DRIFT_KW)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        d = res.diagnostics
        resid = d["median_rel_resid"]
        tau_1 = d["drift"]["tau_1"]
        rows_it = d["n_iter_rows"]
        p50 = float(np.median(resid))
        gates = {"finite": bool(np.isfinite(res.coef).all()
                                and res.coef.shape == (DRIFT_B,
                                                       len(res.tau))),
                 "resid": bool((resid < DRIFT_GATE_RESID).all()),
                 "tau_1": bool(((tau_1 >= DRIFT_KW["min_tau_drift"])
                                & (tau_1 <= 1e4)).all())}
        if seed == 1:
            gates["p50"] = bool(p50 <= DRIFT_GATE_P50)
        out[f"seed{seed}"] = {
            "wall_s": walls[-1], "phase_s": d["phase_s"],
            "s_per_lbfgs_iter": d["phase_s"]["lbfgs"] / float(rows_it.max()),
            "lbfgs_rows": int(rows_it.size),
            "n_iter_q": [float(np.percentile(d["n_iter"], q))
                         for q in (0, 10, 50, 90, 100)],
            "rows_n_iter_q": [float(np.percentile(rows_it, q))
                              for q in (0, 50, 100)],
            "resid_p50": p50, "resid_max": float(resid.max()),
            "tau_1_range": [float(tau_1.min()), float(tau_1.max())],
            "gates": gates}
        failed += [f"fleet seed{seed} {k}" for k, v in gates.items() if not v]
    out["bars"] = {"resid_each": DRIFT_GATE_RESID, "p50": DRIFT_GATE_P50,
                   "jax_p50": DRIFT_JAX_P50}
    print("drift fleet: " + json.dumps(out) + f" [{card}]")
    serial = []
    for _ in range(1):
        inv = Inverter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inv.drift_map_fit(freq, zb[0], times, random_seed=0, **DRIFT_KW)
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
        z_hat = inv.predict_Z_drift(freq, times)
        resid0 = float(np.median(np.abs(z_hat - zb[0]) / np.abs(zb[0])))
        if not resid0 < DRIFT_GATE_RESID:
            failed.append("serial resid")
    best, s_best = min(walls), min(serial)
    print("drift serial: " + json.dumps({
        "seconds": serial, "timings": inv.timings.summary(),
        "lbfgs_iters": inv._map_n_iter_lbfgs,
        "polish_iters": int(inv._map_result.n_iter) - inv._map_n_iter_lbfgs,
        "resid": resid0, "fleet_best_s": best,
        "fleet_ms_per_cell": 1e3 * best / DRIFT_B,
        "speedup": s_best * DRIFT_B / best}) + f" [{card}]")


def drift_inverter(card, failed):
    """(b) Inverter.drift_map_fit on the JAX drift test's three-sweep
    spectrum: RQ and x1, with that test's gates, and the time routing of
    predict_Rp / predict_sigma / predict_distribution. In float64, as
    that test runs: in float32 L-BFGS's stagnation rule (floored at 10
    eps) stops the restarts early. The RQ fit's gates ask that the best
    start land in the drifting element's basin: at the test's 8 restarts
    that holds on 7 of 10 seeds in the JAX package itself and on 4 of 10
    in the port on the CPU (its draws differ; scripts/
    jax_drift_reference.py rq [--port]), so the fit here runs
    DRIFT_RQ_RESTARTS restarts."""
    import torch
    from bayes_drt_tpu_torch import Inverter, sim
    out = {}
    tau_eval = np.logspace(-6, 1, 100)
    slow = tau_eval > 1e-2
    for model, kw in (("RQ", dict(n_restarts=DRIFT_RQ_RESTARTS)),
                      ("x1", dict(n_restarts=2, min_tau_drift=100.0))):
        freq, Z, times = sim.make_drifting_spectrum(model)
        inv = Inverter(dtype=torch.float64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inv.drift_map_fit(freq, Z, times, drift_model=model, random_seed=0,
                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fits = inv.distribution_fits["DRT"]
        resid = float(np.median(np.abs(inv.predict_Z_drift(freq, times) - Z)
                                / np.abs(Z)))
        mass = [float(np.trapezoid(inv.predict_distribution(
            eval_tau=tau_eval, time=t)[slow], np.log(tau_eval[slow])))
            for t in (0.0, 1800.0)]
        s_re, s_im = inv.predict_sigma(freq, times=times)
        rp = inv.predict_Rp(time=1800.0)
        gates = {"resid": resid < DRIFT_GATE_RESID,
                 "routing": bool(np.isfinite(s_re).all()
                                 and np.isfinite(s_im).all()
                                 and np.isfinite(rp))}
        if model == "RQ":
            gates["tau_rq"] = abs(np.log10(fits["tau_rq"] / 0.05)) < 1.0
            gates["R_rq"] = 0.2 < fits["R_rq"] < 1.0
            gates["slow_mass_grows"] = mass[1] > mass[0]
        gates = {k: bool(v) for k, v in gates.items()}
        out[model] = {"wall_s": wall, "restarts": kw["n_restarts"],
                      "timings": inv.timings.summary(),
                      "lbfgs_iters": inv._map_n_iter_lbfgs,
                      "value": float(inv._map_result.value),
                      "resid": resid, "slow_mass_t0_t1800": mass,
                      "Rp": rp, "gates": gates,
                      **{k: fits[k] for k in ("tau_rq", "R_rq", "tau_x1")
                         if k in fits}}
        failed += [f"inverter {model} {k}" for k, v in gates.items() if not v]
    print("drift inverter: " + json.dumps(out) + f" [{card}]")


def peaks_ecm(card, failed):
    """(c) HN peaks on a MAP Inverter fit of a noisy 2ZARC spectrum with
    the JAX peak workflow test's gates, the other peak methods, and
    fit_ecm on the JAX ECM tests' circuits with their gates."""
    import torch
    from bayes_drt_tpu_torch import Inverter, ecm, sim
    freq = np.logspace(6, -2, 81)
    Z = sim.add_model_noise(sim.reference_circuit("2ZARC", freq), 3,
                            0.0025, 0.0025, "Macdonald")[0]
    inv = Inverter()
    inv.fit(freq, Z, random_seed=0)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inv.fit_peaks()
    torch.cuda.synchronize()
    out["fit_peaks_s"] = time.perf_counter() - t0
    info = inv.extract_peak_info()
    tau = inv.distributions["DRT"]["tau"]
    g_peaks = inv.predict_peak_distribution(eval_tau=tau)
    g_drt = inv.predict_distribution()
    z_resid = float(np.median(np.abs(inv.predict_peak_Z(freq) - Z)
                              / np.abs(Z)))
    dist_err = float(np.max(np.abs(g_peaks - g_drt)) / np.max(g_drt))
    t_main = float(info["tau_0"][np.argmax(np.abs(info["R"]))])
    gates = {"sum_R": abs(float(np.sum(info["R"])) - 2.0) < 0.3,
             "tau_main": 1e-4 < t_main < 1e-1, "distribution": dist_err < 0.3,
             "Z": z_resid < 0.05}
    out.update(num_peaks=int(info["num_peaks"]),
               sum_R=float(np.sum(info["R"])), tau_main=t_main,
               dist_err_over_max=dist_err, z_resid=z_resid,
               chi_sq=float(inv.score_peak_fit()))
    t0 = time.perf_counter()
    inv.fit_peaks_constrained([1e-3, 1e-2])
    out["constrained_s"] = time.perf_counter() - t0
    out["constrained_tau"] = np.exp(inv.distribution_fits["DRT"][
        "peak_params"][1::4]).tolist()
    t0 = time.perf_counter()
    inv.fit_peaks(fit_data=True, frequencies=freq, Z=Z)
    out["fit_data_s"] = time.perf_counter() - t0
    zf = inv.predict_peak_Z(freq)
    out["fit_data_z_resid"] = float(np.median(np.abs(zf - Z) / np.abs(Z)))
    gates["fit_data"] = bool(np.isfinite(zf).all()
                             and out["fit_data_z_resid"] < 0.05)
    # the ECM tests' circuits and gates
    rng = np.random.default_rng(0)
    f2 = np.logspace(6, -2, 81)
    z2 = sim.reference_circuit("2ZARC", f2) + 0.002 * (
        rng.standard_normal(81) + 1j * rng.standard_normal(81))
    t0 = time.perf_counter()
    r2 = ecm.fit_ecm(f2, z2, [("R", {"R": 0.5}),
                              ("ZARC", {"R": 0.5, "tau": 3e-3, "phi": 0.7}),
                              ("ZARC", {"R": 0.5, "tau": 3e-2, "phi": 0.7})])
    out["ecm_2zarc_s"] = time.perf_counter() - t0
    p = [q for _, q in r2["circuit"]]
    taus = sorted([p[1]["tau"], p[2]["tau"]])
    gates["ecm_2zarc"] = bool(
        abs(p[0]["R"] - 1.0) < 0.05 and abs(np.log10(taus[0] / 1e-3)) < 0.2
        and abs(np.log10(taus[1] / 1e-2)) < 0.2
        and all(abs(p[i]["phi"] - 0.8) < 0.05
                and abs(p[i]["R"] - 1.0) < 0.1 for i in (1, 2))
        and r2["chi_sq"] < 1e-4)
    fg = np.logspace(5, -1, 61)
    t0 = time.perf_counter()
    rg = ecm.fit_ecm(fg, sim.reference_circuit("Gerischer", fg),
                     [("R", {"R": 0.5}), ("Gerischer", {"R": 0.5,
                                                        "tau": 1e-3})])
    out["ecm_gerischer_s"] = time.perf_counter() - t0
    pg = dict(rg["circuit"])
    gates["ecm_gerischer"] = bool(
        abs(pg["Gerischer"]["tau"] - 1e-2) / 1e-2 < 0.1
        and abs(pg["R"]["R"] - 1.0) < 0.02)
    # one LM solve on its own: a two-ZARC peak residual from a perturbed
    # start, at the peak fits' cap (300) and the Inverter's dtype; the
    # host checks once an iteration
    out["lm_solve"] = lm_solve_seconds()
    gates = {k: bool(v) for k, v in gates.items()}
    out.update(ecm_2zarc_chi_sq=r2["chi_sq"],
               ecm_gerischer_tau=pg["Gerischer"]["tau"], gates=gates)
    print("peaks and ecm: " + json.dumps(out) + f" [{card}]")
    failed += [f"peaks {k}" for k, v in gates.items() if not v]


def peak_residual(dev, dt):
    """(residual function, start, lb, ub) of a two-ZARC peak fit on
    logspace(-8, 2, 101), the start 10-20% off the truth."""
    import torch
    from bayes_drt_tpu_torch import peaks
    ptau = np.logspace(-8, 2, 101)
    x_true = np.array([1.0, np.log(1e-4), 1.0, 0.8,
                       2.0, np.log(1e-1), 1.0, 0.7])
    f = dict(device=dev, dtype=dt)
    t_t = torch.as_tensor(ptau, **f)
    g_t = peaks.evaluate_fit_distribution(x_true, ptau, **f)
    w_t = 1.0 / (g_t + 0.05)

    def resid(x):
        return peaks.peak_fit_residuals(x, t_t, g_t, 3.0, w_t, 0.0, 0.01)

    x0 = torch.as_tensor(x_true * np.array([1.2, 1.0, 0.9, 1.1] * 2),
                         **f)[None]
    lb = np.array([0, x_true[1] - 0.25, 0, 0, 0, x_true[5] - 0.25, 0, 0])
    ub = np.array([np.inf, x_true[1] + 0.25, 1, 1, np.inf,
                   x_true[5] + 0.25, 1, 1])
    return resid, x0, lb, ub


def lm_solve_seconds():
    """Seconds, iterations and ms an iteration of one bounded_lm solve of
    the peak residual on the card in float32 at the peak fits' cap."""
    import torch
    from bayes_drt_tpu_torch.infer.lsq import bounded_lm
    resid, x0, lb, ub = peak_residual("cuda", torch.float32)
    bounded_lm(resid, x0, lb, ub, max_iter=3)     # first-use warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bounded_lm(resid, x0, lb, ub, max_iter=300)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = int(res.n_iter[0])
    return {"seconds": sec, "n_iter": n, "ms_per_iter": 1e3 * sec / n,
            "grad_norm": float(res.grad_norm[0])}


def drift_parity(card, failed):
    """(d) float64, card against CPU: the drift density and gradient of
    every model, series and parallel, on 8 fleet cells from numpy-made
    rows (1e-10 of the largest entry); run_lbfgs on x1 drift rows at
    MAP_PARITY_SHORT iterations (value within 1e-9 relative, parameters
    within 1e-6 of each row's largest); bounded_lm on the two-ZARC peak
    residual at DRIFT_LM_CAP iterations (1e-10); K2 against its plain
    version on the fleet's unsorted, repeated grid (rtol 1e-10), and its
    time there."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.lsq import bounded_lm
    from bayes_drt_tpu_torch.infer.map import run_lbfgs
    from bayes_drt_tpu_torch.models import drift
    from bayes_drt_tpu_torch.ops.matrices import (_quad_grid, construct_A,
                                                  construct_L,
                                                  default_epsilon,
                                                  get_tau_basis)
    from bayes_drt_tpu_torch.ops.quad import drt_quad, drt_quad_plain
    from bayes_drt_tpu_torch.parallel.batch import drift_data
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        freq, times, zb = sim.make_drift_fleet(8, seed=0)
        tau = get_tau_basis(np.sort(freq)[::-1])
        eps = default_epsilon(tau)
        zs = np.std(np.abs(zb), axis=1) / np.sqrt(len(freq) / 81)
        T = np.concatenate([(zb / zs[:, None]).real,
                            (zb / zs[:, None]).imag], axis=1)
        rng = np.random.default_rng(7)
        worst = 0.0
        datas = {}
        for dist_type in ("series", "parallel"):
            akw = ({} if dist_type == "series" else
                   dict(kernel="DDT", dist_type="parallel", bc="blocking"))
            for dev in ("cpu", "cuda"):
                f64 = dict(dtype=torch.float64, device=dev)
                A = [construct_A(freq, part, tau=tau, epsilon=eps, **akw,
                                 **f64) for part in ("real", "imag")]
                L = torch.stack([1.5 * s * construct_L(
                    1 / (2 * np.pi * tau), tau=tau, epsilon=eps, order=o,
                    **f64) for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])
                datas[dist_type, dev] = drift_data(
                    freq, times, A[0], A[1], L, T, tau, 0.002, 1.0,
                    DRIFT_KW["min_tau_drift"], 1e4, torch.float64,
                    torch.device(dev))
            for model in drift.DRIFT_MODELS:
                cfg = drift.DriftConfig(model, dist_type, False, len(tau))
                q = rng.uniform(-2.0, 2.0, (8, drift.drift_flat_dim(cfg)))
                got = {dev: drift.drift_value_and_grad(
                    cfg, datas[dist_type, dev])(torch.as_tensor(q,
                                                                device=dev))
                    for dev in ("cpu", "cuda")}
                for i, what in enumerate(("value", "grad")):
                    want = got["cpu"][i]
                    err = float((got["cuda"][i].cpu() - want).abs().max()
                                / want.abs().max())
                    worst = max(worst, err)
        out["density_worst_rel"] = worst
        if not worst <= 1e-10:
            failed.append("parity density")
        # run_lbfgs on x1 rows (series) from the same numpy starts
        cfg = drift.DriftConfig("x1", "series", False, len(tau))
        q0 = rng.uniform(-2.0, 2.0, (8, drift.drift_flat_dim(cfg)))
        res = {}
        for dev in ("cpu", "cuda"):
            vg = drift.drift_value_and_grad(cfg, datas["series", dev])

            def loss(q, vg=vg):
                lp, g = vg(q)
                return -lp, -g

            res[dev] = run_lbfgs(loss, torch.as_tensor(q0, device=dev),
                                 max_iter=MAP_PARITY_SHORT)
        v_rel = float(((res["cuda"].value.cpu() - res["cpu"].value).abs()
                       / res["cpu"].value.abs()).max())
        p = res["cpu"].params
        p_rel = float(((res["cuda"].params.cpu() - p).abs().amax(dim=1)
                       / p.abs().amax(dim=1)).max())
        same_it = bool(torch.equal(res["cuda"].n_iter.cpu(),
                                   res["cpu"].n_iter))
        out["lbfgs"] = {"value_rel": v_rel, "params_rel": p_rel,
                        "n_iter_equal": same_it}
        if not (v_rel <= 1e-9 and p_rel <= 1e-6 and same_it):
            failed.append("parity lbfgs")
        # bounded_lm on the two-ZARC peak residual
        lm = {}
        for dev in ("cpu", "cuda"):
            resid, x0, lb, ub = peak_residual(dev, torch.float64)
            lm[dev] = bounded_lm(resid, x0, lb, ub, max_iter=DRIFT_LM_CAP)
        x_err = float((lm["cuda"].x.cpu() - lm["cpu"].x).abs().max()
                      / lm["cpu"].x.abs().max())
        out["lm_x_rel"] = x_err
        if not (x_err <= 1e-10 and int(lm["cuda"].n_iter[0])
                == int(lm["cpu"].n_iter[0])):
            failed.append("parity lm")
        # K2 on the fleet's unsorted grid, each frequency three times
        s64 = torch.log(2 * math.pi * torch.as_tensor(freq, device="cuda")[
            :, None] * torch.as_tensor(tau, device="cuda")[None, :])
        y, w = _quad_grid(1000, 20.0, torch.float64, "cuda")
        phiw = torch.exp(-((eps * y) ** 2)) * w
        k2 = 0.0
        for part in ("real", "imag"):
            k2 = max(k2, check_close(f"quad drift grid {part}",
                                     drt_quad(s64, y, phiw, part),
                                     drt_quad_plain(s64, y, phiw, part),
                                     1e-10, 1e-14))
        out["k2_max_abs_err"] = k2
        out["k2_ms"] = cuda_ms(lambda: drt_quad(s64, y, phiw, "imag"), 100)
        out["k2_shape"] = list(s64.shape)
    finally:
        torch.set_num_threads(threads)
    print("drift parity: " + json.dumps(out) + f" [{card}]")


def phase_drift(card):
    """Drift, peaks and ECM (phase 14): (a) the drift fleet and its serial
    line, (b) the Inverter's drift fits, (c) HN peaks and ECM fits; their
    K2 launches are read before (d), the float64 card-vs-CPU parity.
    Returns the launches of (a) to (c) (K2 in every DRT A and ridge A they
    build; no K1)."""
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    failed = []
    drt_quad.launches = 0
    traj_fused.launches = 0
    t0 = time.perf_counter()
    drift_fleet(card, failed)
    t_a = time.perf_counter()
    drift_inverter(card, failed)
    t_b = time.perf_counter()
    peaks_ecm(card, failed)
    t_c = time.perf_counter()
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    drift_parity(card, failed)
    t_d = time.perf_counter()
    print("drift phase: " + json.dumps({
        "seconds": {"fleet": t_a - t0, "inverter": t_b - t_a,
                    "peaks_ecm": t_c - t_b, "parity": t_d - t_c,
                    "total": t_d - t0},
        "launches": launches}) + f" [{card}]")
    if launches["quad"] == 0 or launches["traj"] != 0:
        failed.append("launches")
    if failed:
        raise AssertionError(f"drift phase failed: {failed}")
    return launches


def sbc_setup(dtype, device):
    """The SBC model (the Series model on logspace(6, -2, 81), K=101) on
    ``device``: (frequencies, tau, epsilon, cfg, data)."""
    from bayes_drt_tpu_torch.parallel.batch import _build_shared
    frequencies, tau, eps, cfg, data, _ = _build_shared(
        np.logspace(6, -2, 81), mode="sample", dtype=dtype, device=device)
    return frequencies, tau, eps, cfg, data


def sbc_calibration(card, failed):
    """(a) SBC of the production sampler: the prior marginal by NUTS on the
    card, the exact datasets, the production fit with unthinned monitors,
    the auto-thinning stride, then each monitor's ranks, chi-square and
    ECDF band. Returns its seconds."""
    import torch
    from bayes_drt_tpu_torch import sbc
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    n_sets = SBC_SETS
    frequencies, tau, eps, cfg, data = sbc_setup(torch.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ups_raw, ds, pdiag = sbc.sample_prior_marginal(
        cfg, data, n_sets, seed=0, warmup=SBC_PRIOR_WARMUP,
        max_tree_depth=SBC_PRIOR_DEPTH)
    prior_s = time.perf_counter() - t0
    print(f"sbc prior marginal: {n_sets} draws (NUTS md{SBC_PRIOR_DEPTH}, "
          f"warmup {SBC_PRIOR_WARMUP}) in {prior_s:.1f} s "
          f"{json.dumps(pdiag)} [{card}]")
    if not (pdiag.get("rank_rhat_max", np.inf) < 1.1
            and np.isfinite(ups_raw).all() and np.isfinite(ds).all()):
        failed.append("sbc prior marginal")
    phi = np.exp(-(eps * np.log(SBC_GE_TAU[:, None] / tau[None, :])) ** 2)
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds, phi, seed=1)
    shmc = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS, leaf_unroll=2,
                      draw_unroll=2, recompute_grad=True,
                      eps_quantile=EPS_QUANTILE)
    k1 = traj_fused.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_spectra_batch(frequencies, z, mode="sample", chains=CHAINS,
                            warmup=WARMUP, samples=SAMPLES, random_seed=2,
                            ncp=True, gamma_eval_tau=SBC_GE_TAU, z_scale=1.0,
                            monitor_thin=1, escalate=False, sampler="shmc",
                            shmc_cfg=shmc, dtype=np.float32)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1 = traj_fused.launches - k1
    d = res.diagnostics
    md = d["monitor_draws"]
    ess_med = np.median(sbc.monitor_ess(md, CHAINS), axis=0)
    total = md.shape[1]
    s_per = total // CHAINS
    stride = min(int(np.ceil(total / max(float(ess_med.min()), 4.0))), s_per)
    md = md.reshape(n_sets, CHAINS, s_per, -1)[:, :, stride - 1::stride]
    md = md.reshape(n_sets, -1, md.shape[-1])
    ranks = sbc.sbc_ranks(truths, md)
    pvals, chi2 = sbc.rank_uniformity(ranks, md.shape[1], n_bins=SBC_BINS)
    viol = sbc.ecdf_envelope_violations(ranks, md.shape[1])
    ok = (pvals > SBC_P_MIN) & ~viol
    print(f"sbc fit: {n_sets} x {CHAINS}x({WARMUP}+{SAMPLES}) in "
          f"{fit_s:.2f} s, K1 launches {k1}, divergence "
          f"{float(np.mean(d['divergence_rate'])):.4f}, logp-Rhat(med) "
          f"{float(np.median(d['logp_rhat'])):.3f}; monitor ESS(med) "
          f"{np.array2string(ess_med, precision=1)} -> stride {stride}, "
          f"L={md.shape[1]} [{card}]")
    for j, name in enumerate(SBC_MONITORS):
        print(f"  sbc {'OK  ' if ok[j] else 'FAIL'} {name:<12} "
              f"chi2={chi2[j]:7.2f} p={pvals[j]:.4f} "
              f"ecdf_viol={bool(viol[j])}")
    print(f"sbc: {int(ok.sum())}/{len(SBC_MONITORS)} monitors calibrated "
          f"({SBC_BINS}-bin chi2 p > {SBC_P_MIN} and inside the DKW band)")
    if md.shape[-1] != len(SBC_MONITORS) or not ok.all():
        failed.append("sbc calibration")
    if k1 != WARMUP + SAMPLES:
        failed.append("sbc K1 launches")
    return {"prior_s": prior_s, "fit_s": fit_s, "stride": stride,
            "n_sets": n_sets}


def sbc_parity(card, failed):
    """(a) float64, card against CPU: the prior marginal's value and
    gradient on SBC_PARITY_ROWS rows (within 1e-9 of each row's largest
    gradient entry), and one NUTS transition of the first
    SBC_PARITY_NUTS_ROWS of them (md7), on the card as CUDA graphs, under
    phase 9's criterion."""
    import torch
    from bayes_drt_tpu_torch import sbc
    rng = np.random.default_rng(3)
    k = 101
    u = np.concatenate([np.log(0.2) + rng.normal(0, 0.3, (SBC_PARITY_ROWS,
                                                         1))
                        + rng.normal(0, 0.05, (SBC_PARITY_ROWS, k)),
                        rng.normal(0, 0.3, (SBC_PARITY_ROWS, 3))], axis=1)
    vgs = {}
    for dev in ("cuda", "cpu"):
        _, _, _, cfg, data = sbc_setup(torch.float64, dev)
        logp, _ = sbc._marginal_logdensity(cfg, data)
        vgs[dev] = sbc.marginal_value_and_grad(logp)
    out = {dev: [t.cpu() for t in vgs[dev](torch.as_tensor(u, device=dev))]
           for dev in vgs}
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    rel_v = float(((lc - lh).abs() / lh.abs()).max())
    rel_g = float(((gc - gh).abs().max(1).values
                   / gh.abs().max(1).values).max())
    print(f"sbc parity: marginal value and gradient on {SBC_PARITY_ROWS} "
          f"rows, float64, largest relative difference {rel_v:.2e} / "
          f"{rel_g:.2e}")
    if not (rel_v <= 1e-9 and rel_g <= 1e-9):
        failed.append("sbc marginal parity")

    def rows(dev):
        q = torch.as_tensor(u[:SBC_PARITY_NUTS_ROWS], device=dev)
        lp, g = vgs[dev](q)
        return (vgs[dev], q, lp, g,
                torch.full((SBC_PARITY_NUTS_ROWS,), 0.05,
                           dtype=torch.float64, device=dev),
                torch.ones_like(q))

    bad = nuts_transition_parity(card, "sbc parity nuts",
                                 SBC_PARITY_NUTS_ROWS, SBC_PRIOR_DEPTH, 8,
                                 rows)
    if bad:
        failed.append("sbc nuts parity")


def write_cli_inputs(root):
    """The CLI's input directory: the CSVs of CLI_GRIDS (noisy ZARC
    spectra from sim, a seed a grid), CLI_DTA Gamry .DTA files on the
    first grid and one corrupt file. Returns {grid index: (freq, stems)}."""
    import csv
    from bayes_drt_tpu_torch import sim
    grids = {}
    for g, (n, (hi, lo, pts)) in enumerate(CLI_GRIDS):
        freq, zb = sim.make_benchmark_batch(n, freq=np.logspace(hi, lo, pts),
                                            noise_level=0.0025, seed=20 + g)
        stems = []
        for i, z in enumerate(zb):
            stem = f"zarc_g{g}_{i:04d}"
            with open(os.path.join(root, stem + ".csv"), "w",
                      newline="") as f:
                w = csv.writer(f, lineterminator="\n")
                w.writerow(["Freq", "Zreal", "Zimag"])
                w.writerows([repr(float(a)), repr(float(b.real)),
                             repr(float(b.imag))] for a, b in zip(freq, z))
            stems.append(stem)
        grids[g] = (freq, stems)
    freq, zb = sim.make_benchmark_batch(CLI_DTA, freq=grids[0][0],
                                        noise_level=0.0025, seed=30)
    for i, z in enumerate(zb):
        sim.write_gamry_dta(os.path.join(root, f"gamry_{i}.DTA"), freq, z)
        grids[0][1].append(f"gamry_{i}")
    with open(os.path.join(root, "corrupt.csv"), "w") as f:
        f.write("this is not a spectrum\x00\x01")
    return grids


def read_csv_rows(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def start_cli(argv, out):
    """``python -m bayes_drt_tpu_torch fit ...`` started in a subprocess
    from the repo root; returns (process, start time)."""
    cmd = [sys.executable, "-m", "bayes_drt_tpu_torch", "fit", *argv,
           "--out", out]
    return (subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter())


def finish_cli(label, started, note=""):
    """Wait for a command of ``start_cli``; returns (seconds, {bucket:
    (spectra, seconds)}), raising on a nonzero exit code."""
    proc, t0 = started
    _, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(err[-4000:])
        raise AssertionError(f"cli {label}: exit code {proc.returncode}")
    buckets = {}
    for line in err.splitlines():
        if line.startswith("bucket "):
            head, rest = line.split(":", 1)
            n = int(rest.split("spectra")[0])
            secs = float(rest.split(" fit in ")[1].split("s")[0])
            buckets[int(head.split()[1])] = (n, secs)
    print(f"cli {label}: {wall:.1f} s for the command{note}; " + "; ".join(
        f"bucket {b}: {n} spectra in {s:.2f} s, "
        f"{n / (s / 60.0):.0f} spectra/min" for b, (n, s) in
        sorted(buckets.items())))
    return wall, buckets


def cli_gamma_figures(out, stems):
    """Batch-mean gamma RMSE and per-spectrum RMSE p90 over Rp of the
    Gout files of ``stems`` against the ZARC truth, and the Rps."""
    from bayes_drt_tpu_torch import sim
    gs, rps = [], []
    for stem in stems:
        rows = read_csv_rows(os.path.join(out, f"Gout_{stem}.csv"))
        tau = np.array([float(r["tau"]) for r in rows])
        gs.append([float(r["gamma"]) for r in rows])
    g = np.array(gs)
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    per = np.sqrt(np.mean((g - gt) ** 2, axis=1)) / rp
    rmse = float(np.sqrt(np.mean((g.mean(axis=0) - gt) ** 2)) / rp)
    return rmse, float(np.percentile(per, 90)), np.trapezoid(g, np.log(tau),
                                                              axis=1) / rp


def cli_check_outputs(label, out, failed, n_files):
    """One Gout file a spectrum, the summary's rows, the corrupt file's
    load_error row."""
    summary = read_csv_rows(os.path.join(out, "summary.csv"))
    n_gout = sum(name.startswith("Gout_") for name in os.listdir(out))
    bad = [r for r in summary if r["file"] == "corrupt.csv"]
    ok = (n_gout == n_files and len(summary) == n_files + 1 and len(bad) == 1
          and bad[0]["status"].startswith("load_error")
          and all(r["status"] == "ok" for r in summary
                  if r["file"] != "corrupt.csv"))
    if not ok:
        failed.append(f"cli {label} outputs")
    return summary


def cli_trace(card, root, failed):
    """One sample-mode bucket (the second grid's) fit in this process as
    the CLI fits it, wrapped in profiling.trace: the Chrome trace must
    name K1's kernel once a draw; prints K1's share of the traced device
    kernel time. Returns the fit's launches."""
    import glob
    import tempfile
    import torch
    from bayes_drt_tpu_torch import cli, profiling
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.native import load_spectra
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    args = cli.build_parser().parse_args(["fit", "x", "--mode", "sample"])
    (bucket,) = load_spectra(sorted(glob.glob(os.path.join(root,
                                                           "zarc_g1_*"))))
    freq, zb = bucket["freq"], bucket["Z"]
    tau_eval = cli._eval_tau(cli._basis_tau(freq), args.eval_points)
    drt_quad.launches = 0
    traj_fused.launches = 0
    with tempfile.TemporaryDirectory() as tdir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.trace(tdir):
            cli.fit_bucket(args, freq, zb, tau_eval)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
        (name,) = os.listdir(tdir)
        with open(os.path.join(tdir, name)) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if "traj_kernel" in e.get("name", "")]
    k1_us = sum(e.get("dur", 0) for e in k1)
    all_us = sum(e.get("dur", 0) for e in kern)
    draws = args.warmup + args.samples
    print(f"cli trace: one sample-mode bucket ({zb.shape[0]} spectra) "
          f"under profiling.trace in {wall:.1f} s; {len(kern)} kernel "
          f"events, K1 ({k1[0]['name'][:60] if k1 else 'absent'}) "
          f"{len(k1)} launches, {k1_us / 1e3:.1f} ms of {all_us / 1e3:.1f} "
          f"ms device kernel time ({100.0 * k1_us / max(all_us, 1):.1f}%) "
          f"[{card}]")
    if len(k1) != draws or launches["traj"] != draws:
        failed.append("cli trace")
    return launches


def cli_runs(card, failed):
    """(b) the CLI as a user runs it, on the inputs of write_cli_inputs:
    sample mode (the defaults, 4 x (250+250), SHMC), optimize, ridge with
    and without --ridge-cv, --peaks on CLI_PEAK_FILES files, each a
    subprocess: sample alone, then the other four at once; then the
    traced bucket. Returns the commands' seconds and the traced fit's
    launches."""
    import tempfile
    secs = {}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        os.makedirs(data)
        grids = write_cli_inputs(data)
        n_files = sum(len(stems) for _, stems in grids.values())
        paths = [os.path.join(data, "*.csv"), os.path.join(data, "*.DTA")]
        commands = {"sample": paths, "optimize": paths + [
            "--mode", "optimize", "--max-iter", str(CLI_MAP_ITER)],
            "ridge": paths + ["--mode", "ridge"],
            "ridge-cv": paths + ["--mode", "ridge", "--ridge-cv"],
            "peaks": [os.path.join(data, s_ + ".csv")
                      for s_ in grids[0][1][:CLI_PEAK_FILES]]
            + ["--mode", "ridge", "--peaks"]}
        # the sample command (the main path) alone on the card: its
        # seconds are a user's. The other four at once, each its own
        # process: their seconds overlap, so they are not a user's and
        # not comparable with runs that ran them one after another (all
        # five one after another took 146 s, the smoke 1,133 s: too
        # close to the limit on a slow host)
        secs["sample"], _ = finish_cli("sample", start_cli(
            commands["sample"], os.path.join(root, "sample")))
        rest = [label for label in commands if label != "sample"]
        started = {label: start_cli(commands[label],
                                    os.path.join(root, label))
                   for label in rest}
        note = (f" (at once with the other {len(rest) - 1}: not a user's "
                "seconds)")
        for label in rest:
            secs[label], _ = finish_cli(label, started[label], note)
        for label in ("sample", "optimize", "ridge", "ridge-cv"):
            out = os.path.join(root, label)
            summary = cli_check_outputs(label, out, failed, n_files)
            figs = {}
            for g, (freq, stems) in grids.items():
                rmse, p90, rps = cli_gamma_figures(out, stems)
                figs[g] = {"rmse": rmse, "p90": p90,
                           "rp_err_max": float(np.abs(rps - 1.0).max())}
            if label == "sample":
                ok = all(f["rmse"] < GATE_RMSE and f["p90"] < GATE_P90
                         for f in figs.values())
                div = [float(r["divergence_rate"]) for r in summary
                       if r["status"] == "ok"]
                figs["divergence_mean"] = float(np.mean(div))
            elif label == "optimize":
                ok = all(f["rmse"] < MAP_GATE_RMSE
                         and f["p90"] < CLI_GATE_MAP_P90
                         for f in figs.values())
            elif label == "ridge":
                ok = all(f["rp_err_max"] < CLI_GATE_RIDGE_RP
                         for f in figs.values())
            else:
                ok = all(f["rmse"] < CLI_GATE_CV_RMSE for f in figs.values())
            print(f"cli {label} figures (of Rp, per grid): "
                  f"{json.dumps(figs)} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"cli {label} gates")
        summary = read_csv_rows(os.path.join(root, "peaks", "summary.csv"))
        n_peaks = [int(r["n_peaks"]) for r in summary]
        rel = [float(r["peak_fit_rmse_rel"]) for r in summary]
        print(f"cli peaks: n_peaks {n_peaks}, peak_fit_rmse_rel max "
              f"{max(rel):.4f}")
        if not (len(summary) == CLI_PEAK_FILES and min(n_peaks) >= 1
                and max(rel) < CLI_PEAK_RMSE_REL):
            failed.append("cli peaks")
        t0 = time.perf_counter()
        traced = cli_trace(card, data, failed)
        secs["trace"] = time.perf_counter() - t0
    return secs, traced


def phase_sbc_cli(card):
    """Simulation-based calibration and the command line (phase 15): (a)
    SBC at the JAX package's production configuration and its float64
    card-vs-CPU parity, (b) the CLI's runs, gates and trace. Returns the
    launches of (a)'s setup and fit and of the traced CLI bucket (the
    CLI's subprocesses launch the kernels in their own processes)."""
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    failed = []
    drt_quad.launches = 0
    traj_fused.launches = 0
    t0 = time.perf_counter()
    sbc_out = sbc_calibration(card, failed)
    t_a = time.perf_counter()
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    sbc_parity(card, failed)
    t_p = time.perf_counter()
    cli_s, traced = cli_runs(card, failed)
    t_b = time.perf_counter()
    launches = {k: launches[k] + traced[k] for k in launches}
    print("sbc/cli phase: " + json.dumps({
        "seconds": {"sbc": t_a - t0, "sbc_parity": t_p - t_a,
                    "cli": t_b - t_p, "total": t_b - t0,
                    "sbc_parts": sbc_out, "cli_parts": cli_s},
        "launches": launches}) + f" [{card}]")
    if failed:
        raise AssertionError(f"sbc/cli phase failed: {failed}")
    return launches


def cache_checks(card, failed):
    """(a) The cross-call cache: cleared, then for each cached path a fit
    of spectrum X (a miss: its captures), of Y (another same-shape
    spectrum: a hit on other data) and of X again, which must be a counted
    hit (no new miss, no capture) whose output equals the first X fit's
    bit for bit. The paths: Inverter.fit NUTS md8 and SHMC at short
    budgets, Inverter.fit MAP, Inverter.drift_map_fit (capped, no polish:
    the L-BFGS graphs are what is cached) and fit_spectra_batch's NUTS
    refit form (ridge seed, md8, tree_scan) on CACHE_REFIT_B spectra."""
    import torch
    from bayes_drt_tpu_torch import Inverter, progcache, sim
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    freq, zb = sim.make_benchmark_batch(2, circuit="ZARC",
                                        noise_level=0.0025, seed=CACHE_SEED)
    zx, zy = zb[0], 1.1 * zb[1]
    dfreq, dtimes, dzc = sim.make_drift_fleet(2, seed=CACHE_SEED)
    _, zr = sim.make_benchmark_batch(2 * CACHE_REFIT_B, circuit="ZARC",
                                     noise_level=0.0025, seed=CACHE_SEED)
    nw, ns = CACHE_NUTS

    def inverter(kind):
        def run(z):
            inv = Inverter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if kind == "nuts":
                    inv.fit(freq, z, mode="sample", max_tree_depth=8,
                            warmup=nw, samples=ns, ncp=True)
                elif kind == "shmc":
                    inv.fit(freq, z, mode="sample", sampler="shmc",
                            warmup=CACHE_SHMC[0], samples=CACHE_SHMC[1],
                            ncp=True)
                elif kind == "map":
                    inv.fit(freq, z, max_iter=CACHE_MAP_ITER, polish=False)
                else:
                    inv.drift_map_fit(dfreq, z, dtimes,
                                      max_iter=CACHE_MAP_ITER, polish=False)
            if kind in ("nuts", "shmc"):
                sd = inv.sample_diagnostics
                return [inv._raw_draws], sd["capture_s"], sd["draw_s"][0]
            if kind == "map":
                return ([inv.distribution_fits["DRT"]["coef"],
                         np.asarray(inv._opt_result["lp__"])], 0.0,
                        inv.timings.stages["lbfgs"])
            return ([np.asarray(v) for _, v in sorted(
                inv._drift_result.items())], 0.0,
                inv.timings.stages["lbfgs"])
        return run

    def refit(z):
        res = fit_spectra_batch(freq, z, chains=CHAINS,
                                warmup=CACHE_REFIT[0], samples=CACHE_REFIT[1],
                                max_tree_depth=NUTS_DEPTH,
                                tree_scan=True, ncp=True,
                                init_from_ridge=True, escalate=False,
                                timing=True)
        d = res.diagnostics
        return ([res.coef, d["state_q"]], float(np.sum(d["capture_s"])),
                float(d["phase_s"]["sample"]))

    cases = {"inverter_nuts_md8": (inverter("nuts"), zx, zy),
             "inverter_shmc": (inverter("shmc"), zx, zy),
             "inverter_map": (inverter("map"), zx, zy),
             "inverter_drift_map": (inverter("drift"), dzc[0], dzc[1]),
             "batch_nuts_refit": (refit, zr[:CACHE_REFIT_B],
                                  zr[CACHE_REFIT_B:])}
    progcache.clear()
    out = {}
    for name, (run, x, y) in cases.items():
        t0 = time.perf_counter()
        x1, cap1, s1 = run(x)
        t1 = time.perf_counter()
        st1 = progcache.stats()
        _, cap_y, _ = run(y)
        st_y = progcache.stats()
        t2 = time.perf_counter()
        x2, cap2, s2 = run(x)
        t3 = time.perf_counter()
        st2 = progcache.stats()
        bitwise = all(np.array_equal(a, b) for a, b in zip(x1, x2))
        # Y may add a ridge QP tail of its own (a data-dependent row
        # count), so its misses are printed, not gated
        gates = {"hit_x": (st2["misses"] == st_y["misses"]
                           and st2["hits"] > st_y["hits"]),
                 "no_capture": float(cap2) == 0.0, "bitwise": bitwise}
        out[name] = {"cold_s": t1 - t0, "hit_other_s": t2 - t1,
                     "hit_s": t3 - t2, "capture_s_cold": float(cap1),
                     "capture_s_other": float(cap_y),
                     "capture_s_hit": float(cap2), "timed_part_s_cold": s1,
                     "timed_part_s_hit": s2,
                     "misses_other": st_y["misses"] - st1["misses"],
                     "stats": st2,
                     "gates": {k: bool(v) for k, v in gates.items()}}
        failed += [f"cache.{name}.{k}" for k, v in gates.items() if not v]
    print("cache: " + json.dumps(out) + f" [{card}]")


def resume_checks(card, failed):
    """(b) warm_start at full width, each fit on spectra scaled by
    WARM_SCALE (the posterior moved a little) against the scaled truth:
    the main path (B=1024, SHMC n32, the trajectory kernel) resumed from
    phase 4's result at 4 x (WARM_MAIN_WARMUP + 250) with the five gates
    and its launches; NUTS md8 (tree_scan) resumed from phase 6's 64 spectra
    at 4 x (WARM_WARMUP + WARM_NUTS_SAMPLES), its RMSE within max(1.5x
    phase 6's own cold figure, 5% Rp) and divergence < 0.05 (the JAX
    package's test_warm_start_chained_refit gates); RG_WARM_B spectra of
    the ragged fleet fitted cold by generic SHMC at 4 x RG_WARM_COLD and
    resumed at 4 x (WARM_WARMUP + 150), gated as phase 12's ragged fits.
    Returns the launches of the main path's resume."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import (evaluate_gamma,
                                              fit_spectra_batch,
                                              fit_spectra_ragged)
    if "main" not in KEEP:
        phase_main(card)
    if "esc" not in KEEP:
        phase_escalation(card)
    out = {}
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     eps_quantile=EPS_QUANTILE)
    freq, Zb, res0, tau, gt, rp = KEEP["main"]
    drt_quad.launches = 0
    traj_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    print(f"warm start: the main path resumes at {CHAINS}x("
          f"{WARM_MAIN_WARMUP}+{SAMPLES}): at {CHAINS}x({WARM_WARMUP}+"
          f"{SAMPLES}) its median logp split-Rhat read 4.18 > "
          f"{GATE_LOGP_RHAT} (an undersized step size after {WARM_WARMUP} "
          "dual-averaging steps)")
    res = fit_spectra_batch(freq, WARM_SCALE * Zb, mode="sample",
                            chains=CHAINS, warmup=WARM_MAIN_WARMUP,
                            samples=SAMPLES, random_seed=2, ncp=True,
                            sampler="shmc", shmc_cfg=cfg, gamma_eval_tau=tau,
                            dtype=np.float32, warm_start=res0, timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    d = res.diagnostics
    rmse, p90, cov = gamma_figures(res, tau, WARM_SCALE * gt, WARM_SCALE * rp)
    ess_med = float(np.median(d["min_ess"]))
    rhat_med = float(np.median(d["logp_rhat"]))
    gates = {"rmse": rmse < GATE_RMSE, "p90": p90 < GATE_P90,
             "coverage": cov > GATE_COVERAGE,
             "min_ess_med": ess_med > GATE_MIN_ESS,
             "logp_rhat_med": rhat_med < GATE_LOGP_RHAT,
             "launches": launches == {"quad": 2,
                                      "traj": WARM_MAIN_WARMUP + SAMPLES},
             "finite": bool(np.isfinite(res.coef).all())}
    out["main_path"] = {
        "B": B, "budget": [CHAINS, WARM_MAIN_WARMUP, SAMPLES],
        "wall_s": wall,
        "phase_s": d["phase_s"], "spectra_per_min": B / (wall / 60.0),
        "traj_ms_per_draw_median": float(np.median(d["traj_ms"])),
        "rmse_over_rp": rmse, "p90_over_rp": p90, "coverage": cov,
        "min_ess_median": ess_med, "logp_rhat_median": rhat_med,
        "divergence_rate": float(np.mean(d["divergence_rate"])),
        "launches": launches,
        "gates": {k: bool(v) for k, v in gates.items()}}
    failed += [f"warm_main.{k}" for k, v in gates.items() if not v]

    efreq, eZb, eres, etau, egt, erp, e_rmse = KEEP["esc"]
    print(f"warm start: NUTS md8 resumes at {CHAINS}x({WARM_WARMUP}+"
          f"{WARM_NUTS_SAMPLES}), its draws cut from 100 to make room for "
          "phase 17 (ChEES; at 100 it took 15.95 s, RMSE 1.39% Rp against "
          f"the 5% bar) [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_spectra_batch(efreq, WARM_SCALE * eZb, mode="sample",
                            chains=CHAINS, warmup=WARM_WARMUP,
                            samples=WARM_NUTS_SAMPLES,
                            max_tree_depth=NUTS_DEPTH, tree_scan=True,
                            random_seed=4, ncp=True, gamma_eval_tau=etau,
                            dtype=np.float32, warm_start=eres, timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = res.diagnostics
    rmse, p90, cov = gamma_figures(res, etau, WARM_SCALE * egt,
                                   WARM_SCALE * erp)
    div = float(np.mean(d["divergence_rate"]))
    gates = {"rmse": rmse <= max(1.5 * e_rmse, 0.05), "divergence": div < 0.05,
             "finite": bool(np.isfinite(res.coef).all())}
    out["nuts_md8"] = {
        "B": B_ESC, "budget": [CHAINS, WARM_WARMUP, WARM_NUTS_SAMPLES],
        "wall_s": wall, "phase_s": d["phase_s"],
        "draw_s_median": float(np.median(d["draw_s"])),
        "capture_s": float(np.sum(d["capture_s"])),
        "rmse_over_rp": rmse, "cold_rmse_over_rp": e_rmse,
        "p90_over_rp": p90, "coverage": cov, "divergence_rate": div,
        "n_leapfrog_mean": float(np.mean(d["n_leapfrog"])),
        "gates": {k: bool(v) for k, v in gates.items()}}
    failed += [f"warm_nuts.{k}" for k, v in gates.items() if not v]

    fleet = sim.make_ragged_fleet(RG_B, RG_SEED)[:RG_WARM_B]
    f_all = np.concatenate([f for f, _ in fleet])
    tmin = np.log10(1 / (2 * np.pi * f_all.max())) - 1
    tmax = np.log10(1 / (2 * np.pi * f_all.min())) + 1
    rtau = np.logspace(tmin, tmax, int(10 * (tmax - tmin) + 1))
    rgt = sim.reference_gamma("ZARC", rtau)
    rrp = np.trapezoid(rgt, np.log(rtau))
    rcfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS, leaf_unroll=2,
                      draw_unroll=2, recompute_grad=True,
                      eps_quantile=EPS_QUANTILE)
    kw = dict(mode="sample", chains=CHAINS, samples=RG_WARM_COLD[1],
              ncp=True, sampler="shmc", shmc_cfg=rcfg, gamma_eval_tau=rtau,
              timing=True)
    rec = {"B": RG_WARM_B}
    cold = None
    for name, fl, scale, extra in (
            ("cold", fleet, 1.0, dict(warmup=RG_WARM_COLD[0],
                                      random_seed=1)),
            ("warm", [(f, WARM_SCALE * z) for f, z in fleet], WARM_SCALE,
             dict(warmup=WARM_WARMUP, random_seed=2))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_spectra_ragged(fl, warm_start=cold, **kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = evaluate_gamma(res, rtau)
        truth = scale * rgt
        per = np.sqrt(np.mean((g - truth[None, :]) ** 2, axis=1))
        rmse = float(np.sqrt(np.mean((g.mean(axis=0) - truth) ** 2)))
        rmse, p90 = rmse / (scale * rrp), float(
            np.percentile(per, 90)) / (scale * rrp)
        gates = {"finite": bool(np.isfinite(res.coef).all()),
                 "rmse": rmse < GATE_RMSE, "p90": p90 < GATE_P90}
        rec[name] = {"wall_s": wall, "phase_s": res.diagnostics["phase_s"],
                     "budget": [CHAINS, extra["warmup"], RG_WARM_COLD[1]],
                     "rmse_over_rp": rmse, "p90_over_rp": p90,
                     "capture_s": [float(x) for x in
                                   res.diagnostics["capture_s"]],
                     "gates": {k: bool(v) for k, v in gates.items()}}
        failed += [f"warm_ragged_{name}.{k}" for k, v in gates.items()
                   if not v]
        cold = res
    out["ragged"] = rec
    print("warm start: " + json.dumps(out) + f" [{card}]")
    return launches


def pooled_check(card, failed):
    """(c) precondition='pooled': NUTS md8 on POOL_B of the main path's
    spectra at warmup POOL_WARMUP (a POOL_PILOT pilot) and POOL_SAMPLES
    draws, centered as the JAX package's test, gated on its bars (RMSE of
    the batch-mean gamma < 6% Rp, divergence < 0.05); the five main-path
    figures printed. Returns the pooled metric (float64) for (e)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.ops.matrices import get_tau_basis
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    Zb = Zb[:POOL_B]
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    print(f"pooled: budget cut to warmup {POOL_WARMUP} and {POOL_SAMPLES} "
          "draws from 150 and 100 to make room for phase 17 (ChEES; at 150 "
          "+ 100 the fit took 45.6 s, at 100 + 50 27.0 s, RMSE 1.88% Rp and "
          f"divergence 0 against the 6% and 0.05 bars) [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_spectra_batch(freq, Zb, mode="sample", chains=CHAINS,
                            warmup=POOL_WARMUP, samples=POOL_SAMPLES,
                            max_tree_depth=NUTS_DEPTH, random_seed=1,
                            precondition="pooled",
                            pilot_warmup=POOL_PILOT[0],
                            pilot_samples=POOL_PILOT[1], escalate=False,
                            gamma_eval_tau=tau, dtype=np.float32,
                            timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = res.diagnostics
    rmse, p90, cov = gamma_figures(res, tau, gt, rp)
    div = float(np.mean(d["divergence_rate"]))
    m = d["state_inv_mass"]
    gates = {"rmse": rmse < POOL_GATE_RMSE, "divergence": div < POOL_GATE_DIV,
             "finite": bool(np.isfinite(res.coef).all()),
             "one_dense_metric": bool(m.ndim == 4 and np.array_equal(
                 m[0, 0], m[-1, -1]))}
    print("pooled: " + json.dumps({
        "B": POOL_B, "budget": [CHAINS, POOL_WARMUP, POOL_SAMPLES],
        "pilot": list(POOL_PILOT), "max_tree_depth": NUTS_DEPTH,
        "wall_s": wall, "phase_s": d["phase_s"],
        "draw_s_median": float(np.median(d["draw_s"])),
        "rmse_over_rp": rmse, "p90_over_rp": p90, "coverage": cov,
        "min_ess_median": float(np.median(d["min_ess"])),
        "logp_rhat_median": float(np.median(d["logp_rhat"])),
        "divergence_rate": div,
        "n_leapfrog_mean": float(np.mean(d["n_leapfrog"])),
        "gates": {k: bool(v) for k, v in gates.items()}}) + f" [{card}]")
    failed += [f"pooled.{k}" for k, v in gates.items() if not v]


def dense_checks(card, failed):
    """(d) The JAX package's dense-metric Gaussian tests as DENSE_ROWS rows
    of CUDA-graph trees (float64): dense_mass on d=6 (relative Frobenius
    error of the pooled draws' covariance < 0.3, mean leapfrogs < 0.7x the
    diagonal metric's on the same rows); a fixed dense metric, the exact
    covariance, on d=12 (error < 0.3, mean leapfrogs < 20) and its
    diagonal as a fixed diagonal metric (divergence < 0.02). Then the
    device memory of dense_mass's per-row metric at the main path's width
    (R=4096, D=211, float32, two md4 draws from its final states)."""
    import torch
    from bayes_drt_tpu_torch.infer import nuts
    dev = "cuda"

    def gaussian(d, seed):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((d, d))
        cov = A @ A.T + 0.05 * np.eye(d)
        P = torch.as_tensor(np.linalg.inv(cov), device=dev)

        def vg(q):
            g = -(q @ P.T)
            return 0.5 * (q * g).sum(-1), g

        return vg, cov

    def rel_f(draws, cov):
        est = np.cov(draws.reshape(-1, draws.shape[-1]).cpu().numpy().T)
        return float(np.linalg.norm(est - cov) / np.linalg.norm(cov))

    out = {}
    vg, cov = gaussian(6, 11)
    q0 = torch.zeros((DENSE_ROWS, 6), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    dd, di = nuts.sample_nuts(vg, q0, 150, 75, nuts.NUTSConfig(
        max_depth=DENSE_DEPTH, dense_mass=True),
        generator=torch.Generator(dev).manual_seed(4))
    _, gi = nuts.sample_nuts(vg, q0, 150, 75,
                             nuts.NUTSConfig(max_depth=DENSE_DEPTH),
                             generator=torch.Generator(dev).manual_seed(4))
    n_dense = float(di["n_leapfrog"].double().mean())
    n_diag = float(gi["n_leapfrog"].double().mean())
    err = rel_f(dd, cov)
    out["dense_mass_d6"] = {"rel_frobenius": err, "n_leapfrog_dense": n_dense,
                            "n_leapfrog_diag": n_diag,
                            "n_leapfrog_max": [int(di["n_leapfrog"].max()),
                                               int(gi["n_leapfrog"].max())],
                            "seconds": time.perf_counter() - t0}
    gates = {"dense_mass.cov": err < 0.3,
             "dense_mass.leaves": n_dense < 0.7 * n_diag}
    vg, cov = gaussian(12, 5)
    chol = np.linalg.cholesky(cov)
    cfg = nuts.NUTSConfig(max_depth=DENSE_DEPTH, adapt_mass=False)
    q0 = torch.zeros((DENSE_ROWS, 12), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    fd, fi = nuts.sample_nuts(vg, q0, 100, 75, cfg,
                              generator=torch.Generator(dev).manual_seed(9),
                              metric=(torch.as_tensor(cov, device=dev),
                                      torch.as_tensor(chol, device=dev)))
    _, vi = nuts.sample_nuts(vg, q0, 100, 50, cfg,
                             generator=torch.Generator(dev).manual_seed(9),
                             metric=torch.as_tensor(np.diag(cov).copy(),
                                                    device=dev))
    err = rel_f(fd, cov)
    n_fixed = float(fi["n_leapfrog"].double().mean())
    div = float(vi["diverging"].double().mean())
    out["fixed_dense_d12"] = {"rel_frobenius": err, "n_leapfrog": n_fixed,
                              "n_leapfrog_max": [int(fi["n_leapfrog"].max()),
                                                 int(vi["n_leapfrog"].max())],
                              "diag_divergence": div,
                              "seconds": time.perf_counter() - t0}
    gates.update({"fixed.cov": err < 0.3, "fixed.leaves": n_fixed < 20,
                  "fixed.diag_divergence": div < 0.02})
    # the per-row dense metric's memory at the main path's width
    vg, q, lp, g, eps, _ = nuts_rows(torch.float32, KEEP["state"], B * CHAINS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, ri = nuts.sample_nuts(vg, q, 1, 1, nuts.NUTSConfig(
        max_depth=4, dense_mass=True), generator=torch.Generator(
        dev).manual_seed(0))
    torch.cuda.synchronize()
    out["dense_rows_R4096_D211"] = {
        "peak_bytes_over_base": int(torch.cuda.max_memory_allocated() - base),
        "one_metric_bytes": int(ri["inv_mass"].numel() * 4),
        "seconds": time.perf_counter() - t0}
    del ri
    out["gates"] = {k: bool(v) for k, v in gates.items()}
    print("dense metrics: " + json.dumps(out) + f" [{card}]")
    failed += [f"dense.{k}" for k, v in gates.items() if not v]


def dense_parity(card, failed):
    """(e) float64 card-vs-CPU parity of one NUTS transition with a
    shared dense metric at D=211 on DENSE_PARITY_ROWS of the main path's
    final states (md8, static tree; on the card as CUDA graphs, bit for
    bit its eager form there), phase 9's row criteria. The metric: the
    main path's final states pooled within each spectrum (batch.
    pooled_metric over its 1024 spectra of 4 chains)."""
    import torch
    from bayes_drt_tpu_torch.parallel import batch
    sq = np.asarray(KEEP["state"]["state_q"], np.float64)
    m_inv, chol = batch.pooled_metric(sq[:, None])
    R = DENSE_PARITY_ROWS
    bad = nuts_transition_parity(
        card, "parity dense nuts", R, NUTS_DEPTH, 8,
        lambda dev: nuts_rows(torch.float64, KEEP["state"], R, dev),
        metric=lambda dev: tuple(torch.as_tensor(a, device=dev)[None]
                                 for a in (m_inv, chol)))
    if bad > 0.001 * R:
        failed.append(f"dense_parity.{bad}_rows")


def phase_resume(card):
    """Phase 16: the cross-call cache (a), warm starts at full width (b),
    the pooled preconditioner (c), dense metrics (d) and their float64
    card-vs-CPU parity (e). Returns the kernels' launches on (a) to (c)'s
    driven paths."""
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    failed = []
    seconds = {}
    total = {"quad": 0, "traj": 0}
    # the cache check clears the cache, so it runs last: the NUTS resume
    # first replays phase 6's refit graphs
    for name, fn in (("warm_start", resume_checks), ("pooled", pooled_check),
                     ("cache", cache_checks)):
        drt_quad.launches = 0
        traj_fused.launches = 0
        t0 = time.perf_counter()
        fn(card, failed)
        seconds[name] = time.perf_counter() - t0
        total["quad"] += drt_quad.launches
        total["traj"] += traj_fused.launches
    for name, fn in (("dense", dense_checks), ("dense_parity", dense_parity)):
        t0 = time.perf_counter()
        fn(card, failed)
        seconds[name] = time.perf_counter() - t0
    print("resume phase: " + json.dumps({"seconds": seconds,
                                         "launches": total}) + f" [{card}]")
    if failed:
        raise AssertionError(f"resume phase failed: {failed}")
    return total


def chees_fit_record(res, wall, tau, gt, rp):
    """What phase 17 prints of a fit: seconds, the draws' seconds and
    leapfrogs, the replays, trajectory times and the five gate
    figures."""
    d = res.diagnostics
    rmse, p90, cov = gamma_figures(res, tau, gt, rp)
    draw_s = np.asarray(d["draw_s"])
    leaf_max = np.asarray(d["leaf_max"])
    return {
        "wall_s": wall, "phase_s": d["phase_s"],
        "draw_s_median": float(np.median(draw_s[1:])),
        "first_draw_s": float(draw_s[0]),
        "capture_s": float(np.sum(d["capture_s"])),
        "n_leapfrog_mean_a_row": float(np.mean(d["n_leapfrog"])),
        "leaf_max_mean_a_draw": float(leaf_max.mean()),
        "leaf_max_max": int(leaf_max.max()),
        "replays_mean_a_draw": float(np.mean(d["replays"])),
        "divergence_rate": float(np.mean(d["divergence_rate"])),
        "traj_time_q": np.quantile(np.asarray(d["state_traj_time"], float),
                                   [0.0, 0.1, 0.5, 0.9, 1.0]).tolist(),
        "rmse_over_rp": rmse, "p90_over_rp": p90, "coverage": cov,
        "min_ess_median": float(np.median(d["min_ess"])),
        "logp_rhat_median": float(np.median(d["logp_rhat"]))}


def chees_fits(card, failed):
    """(a) and (b): ChEES on the main path's 1024 spectra, cold, then
    resumed on the spectra x WARM_SCALE. Returns (the cold result, the
    spectra)."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.ops.matrices import get_tau_basis
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch
    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    tau = get_tau_basis(np.sort(freq)[::-1])
    gt = sim.reference_gamma("ZARC", tau)
    rp = np.trapezoid(gt, np.log(tau))
    kw = dict(mode="sample", chains=CHAINS, samples=SAMPLES, ncp=True,
              sampler="chees", gamma_eval_tau=tau, dtype=np.float32,
              timing=True)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_spectra_batch(freq, Zb, warmup=WARMUP, random_seed=1, **kw)
    torch.cuda.synchronize()
    rec = chees_fit_record(res, time.perf_counter() - t0, tau, gt, rp)
    rec["jax"] = CH_JAX
    gates = {f"{k}_within_{CH_GATE_X}x_jax": rec[k] <= CH_GATE_X * CH_JAX[k]
             for k in CH_JAX}
    gates["min_ess_positive"] = bool((res.diagnostics["min_ess"] > 0).all())
    gates["finite"] = bool(np.isfinite(res.coef).all()
                           and res.coef.shape == (B, len(tau)))
    gates["traj_time_shape"] = (np.shape(res.diagnostics["state_traj_time"])
                                == (B,))
    rec["gates"] = {k: bool(v) for k, v in gates.items()}
    out["cold"] = rec
    failed += [f"chees_cold.{k}" for k, v in gates.items() if not v]
    cold_rmse = rec["rmse_over_rp"]

    print(f"chees warm start: {CHAINS}x({CH_WARM_WARMUP}+{CH_WARM_SAMPLES}),"
          f" its draws cut from {SAMPLES} to keep the smoke's time (at "
          f"{SAMPLES} the fit took 24.4 s) [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = fit_spectra_batch(freq, WARM_SCALE * Zb,
                             **dict(kw, warmup=CH_WARM_WARMUP,
                                    samples=CH_WARM_SAMPLES),
                             random_seed=2, warm_start=res)
    torch.cuda.synchronize()
    rec = chees_fit_record(warm, time.perf_counter() - t0, tau,
                           WARM_SCALE * gt, WARM_SCALE * rp)
    rec["budget"] = [CHAINS, CH_WARM_WARMUP, CH_WARM_SAMPLES]
    rec["captured"] = bool(len(warm.diagnostics["capture_s"]) > 0)
    gates = {"rmse_chained_refit": rec["rmse_over_rp"]
             < max(2.0 * cold_rmse, 0.08),
             "finite": bool(np.isfinite(warm.coef).all())}
    rec["gates"] = {k: bool(v) for k, v in gates.items()}
    out["warm"] = rec
    failed += [f"chees_warm.{k}" for k, v in gates.items() if not v]
    print("chees fits: " + json.dumps(out) + f" [{card}]")
    return res, freq, Zb


def chees_parity(card, res, freq, Zb, failed):
    """(c) float64, card against CPU: CH_PARITY_DRAWS ChEES draws of
    CH_PARITY_ROWS rows resumed as a warm start resumes (the metric held,
    ChEESConfig(adapt_mass=False)) from (a)'s final state of its first
    spectra: their positions, each spectrum's mean metric and step size
    and its trajectory time; through the autograd value and gradient,
    from the same numpy-made noise. On the card each draw's leaves replay
    as CUDA graph blocks, on the CPU they run eagerly. Every row's draws
    within 1e-9 of its largest entry, the leapfrog counts equal, the
    trajectory times and step sizes within 1e-9 (relative). The card runs
    all CH_PARITY_ROWS rows, the CPU the first CH_PARITY_CPU_B spectra's:
    a spectrum's draws depend on its own chains only (the leaves past its
    rows' counts, which the card's larger batch may add, are masked
    no-ops), so the rows compared are the same computation."""
    import torch
    from bayes_drt_tpu_torch.infer import chees
    from bayes_drt_tpu_torch.models.posterior import posterior_value_and_grad
    from bayes_drt_tpu_torch.parallel.batch import (_build_shared,
                                                    _scaled_targets)
    R, nb = CH_PARITY_ROWS, CH_PARITY_ROWS // CHAINS
    warmup, samples = CH_PARITY_DRAWS
    cfg_c = chees.ChEESConfig(adapt_mass=False)
    d = res.diagnostics
    q0 = np.asarray(d["state_q"][:nb], np.float64).reshape(R, -1)
    resume = {"metric": d["state_inv_mass"][:nb].mean(axis=1),
              "init_step_size": d["state_step_size"][:nb].mean(axis=1),
              "init_traj_time": d["state_traj_time"][:nb]}
    dim = q0.shape[1]
    rng = np.random.default_rng(17)
    noise_np = [rng.standard_normal((R, dim))] + [
        (rng.standard_normal((R, dim)), rng.uniform(size=nb),
         rng.uniform(size=(cfg_c.max_steps, R)),
         rng.uniform(size=(cfg_c.max_steps, R)))
        for _ in range(warmup + samples)]
    order = np.argsort(freq)[::-1]
    outs = {}
    for dev, ns in (("cuda", nb), ("cpu", CH_PARITY_CPU_B)):
        rr = ns * CHAINS

        def t(a):
            return torch.as_tensor(a, device=dev)

        f, _, _, cfg, data, dn = _build_shared(
            np.asarray(freq)[order], dtype=torch.float64, ncp=True,
            device=dev)
        _, tg = _scaled_targets(Zb[:ns, order], ns, None, torch.float64, dev,
                                dn)
        vg = posterior_value_and_grad(cfg, data,
                                      tg.repeat_interleave(CHAINS, dim=0))
        noise = [t(noise_np[0][:rr])] + [
            (t(z[:rr]), t(uj[:ns]), t(ub[:, :rr]), t(uf[:, :rr]))
            for z, uj, ub, uf in noise_np[1:]]
        t0 = time.perf_counter()
        draws, info = chees.sample_chees(
            vg, t(q0[:rr]), warmup, samples, cfg_c, CHAINS,
            noise=lambda: iter(noise),
            **{k: t(np.asarray(v[:ns], np.float64))
               for k, v in resume.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = (draws.cpu()[:CH_PARITY_CPU_B],
                     {k: v.cpu()[:CH_PARITY_CPU_B] for k, v in info.items()
                      if isinstance(v, torch.Tensor)},
                     time.perf_counter() - t0, info["leaf_max"])
    (dc, ic, sc, lc), (dh, ih, sh, lh) = outs["cuda"], outs["cpu"]
    R = CH_PARITY_CPU_B * CHAINS
    a, b = dc.reshape(R, -1), dh.reshape(R, -1)
    rel = ((a - b).abs().max(dim=1).values
           / torch.clamp(b.abs().max(dim=1).values, min=1.0))
    same_n = bool(torch.equal(ic["n_leapfrog"], ih["n_leapfrog"])
                  and torch.equal(ic["warmup_n_leapfrog"],
                                  ih["warmup_n_leapfrog"]))
    rel_tt = float(((ic["traj_time"] - ih["traj_time"]).abs()
                    / ih["traj_time"].abs()).max())
    rel_eps = float(((ic["step_size"] - ih["step_size"]).abs()
                     / ih["step_size"].abs()).max())
    bad = int((rel > 1e-9).sum())
    rec = {"rows_card": CH_PARITY_ROWS, "rows_compared": R,
           "draws": [warmup, samples],
           "q_rel_max": float(rel.max()), "rows_over_1e-9": bad,
           "leapfrog_counts_equal": same_n, "traj_time_rel_max": rel_tt,
           "step_size_rel_max": rel_eps, "leaf_max": [lc, lh],
           "card_s": sc, "cpu_s": sh}
    print("chees parity: " + json.dumps(rec) + f" [{card}]")
    if bad or not same_n or rel_tt > 1e-9 or rel_eps > 1e-9:
        failed.append("chees_parity")


def chees_inverter(card, failed):
    """(d) Inverter.fit(mode="sample", sampler="chees", ncp) on phase 13's
    spectrum at 2 x CH_INV_BUDGET (the default ChEESConfig(delta=
    adapt_delta)) for random_seed 0 to CH_INV_SEEDS - 1, the first fit's
    seconds cold (its captures) and the others' as cache hits. Every JAX
    Inverter sampled gate's figure is printed for each fit; since the
    JAX package's own ChEES fits of this spectrum miss rmse < 8% Rp,
    |R_inf - 1| < 0.05 and rhat_max < 5 at this budget, those three are
    gated as medians over the seeds within the JAX package's own 90th
    percentiles (CH_JAX_INV_Q90), and every fit on ess_min >
    INV_GATE_ESS_MIN (which the JAX fits meet), ordered bands and finite
    coefficients."""
    from bayes_drt_tpu_torch import Inverter, sim
    freq, zb = sim.make_benchmark_batch(1, circuit="ZARC",
                                        noise_level=0.0025, seed=INV_SEED)
    tau_gt = np.logspace(-7, 2, 200)
    t_rp = np.logspace(-9, 4, 2000)
    rp = float(np.trapezoid(sim.zarc_drt(t_rp, 1e-3, 0.8), np.log(t_rp)))
    fits = []
    gates = {}
    for seed in range(CH_INV_SEEDS):
        inv = Inverter()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inv.fit(freq, zb[0], mode="sample", sampler="chees", ncp=True,
                    warmup=CH_INV_BUDGET[0], samples=CH_INV_BUDGET[1],
                    random_seed=seed)
        wall = time.perf_counter() - t0
        sd = inv.sample_diagnostics
        draw_s = np.asarray(sd["draw_s"])
        lo = inv.predict_distribution(eval_tau=tau_gt, percentile=2.5)
        hi = inv.predict_distribution(eval_tau=tau_gt, percentile=97.5)
        fits.append({
            "seed": seed, "wall_s": wall, "stages_s": inv.timings.summary(),
            "first_draw_s": float(draw_s[0]),
            "draw_s_median": float(np.median(draw_s[1:])),
            "capture_s": sd["capture_s"],
            "rmse_over_rp": inverter_gamma(inv, tau_gt, rp),
            "R_inf_err": abs(inv.R_inf - 1.0), "rhat_max": sd["rhat_max"],
            "ess_min": sd["ess_min"],
            "divergence_rate": sd["divergence_rate"],
            "n_leapfrog": sd["n_leapfrog"]})
        gates[f"seed{seed}.ess_min"] = sd["ess_min"] > INV_GATE_ESS_MIN
        gates[f"seed{seed}.bands_ordered"] = bool(np.all(hi >= lo - 1e-12))
        gates[f"seed{seed}.finite"] = bool(np.isfinite(
            inv.distribution_fits["DRT"]["coef"]).all())
    med = {k: float(np.median([f[k] for f in fits]))
           for k in ("rmse_over_rp", "R_inf_err", "rhat_max", "ess_min")}
    for k, q90 in CH_JAX_INV_Q90.items():
        gates[f"median_{k}_within_jax_q90"] = med[k] <= q90
    print("chees inverter: " + json.dumps({
        "budget": [2, *CH_INV_BUDGET], "median": med,
        "jax_q90": CH_JAX_INV_Q90,
        "jax_test_gates_median": {
            "rmse<0.08": med["rmse_over_rp"] < 0.08,
            "|R_inf-1|<0.05": med["R_inf_err"] < 0.05,
            "rhat_max<5": med["rhat_max"] < INV_GATE_RHAT_MAX,
            "ess_min>2": med["ess_min"] > INV_GATE_ESS_MIN},
        "fits": fits, "gates": {k: bool(v) for k, v in gates.items()}})
        + f" [{card}]")
    failed += [f"chees_inverter.{k}" for k, v in gates.items() if not v]


def phase_chees(card):
    """Phase 17: ChEES-HMC cold and warm at full width (a, b), float64
    card-vs-CPU parity (c), the Inverter (d). Returns the kernels'
    launches on (a), (b) and (d)'s driven paths: K2 in every DRT A they
    build, no K1 (ChEES takes the autograd value and gradient)."""
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    failed = []
    seconds = {}
    drt_quad.launches = 0
    traj_fused.launches = 0
    t0 = time.perf_counter()
    res, freq, Zb = chees_fits(card, failed)
    seconds["fits"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chees_inverter(card, failed)
    seconds["inverter"] = time.perf_counter() - t0
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    t0 = time.perf_counter()
    chees_parity(card, res, freq, Zb, failed)
    seconds["parity"] = time.perf_counter() - t0
    print("chees phase: " + json.dumps({"seconds": seconds,
                                        "launches": launches})
          + f" [{card}]")
    if launches["quad"] < 5 or launches["traj"] != 0:
        failed.append("launches")
    if failed:
        raise AssertionError(f"chees phase failed: {failed}")
    return launches


class ThreadedShards:
    """make_mesh() over the one card with its one shard tagged, so that
    run_shards runs it in the mesh's worker thread, as each shard of a
    multi-card mesh runs (the device set in the thread, thread-local
    graph captures, the shard's own cache scope), and not inline in the
    caller's thread; records the threads the shards ran in."""

    def __init__(self, device=None):
        self.device = device
        from bayes_drt_tpu_torch.parallel import mesh as mesh_mod

        class Tagged(mesh_mod.DeviceMesh):
            def shards(self, b):
                return [sh._replace(tag=0) for sh in super().shards(b)]

        base = mesh_mod.make_mesh(device=self.device)
        self.mesh = Tagged(base.devices, base.ids)
        self.threads = []
        self._mod = mesh_mod

    def __enter__(self):
        import threading
        inner = self._orig = self._mod._in_shard

        def recorded(fn, shard, n_threads):
            self.threads.append(threading.current_thread().name)
            return inner(fn, shard, n_threads)

        self._mod._in_shard = recorded
        return self.mesh

    def __exit__(self, *exc):
        self._mod._in_shard = self._orig

    def in_workers(self) -> bool:
        return bool(self.threads) and all(
            t.startswith("mesh-shard") for t in self.threads)


def mesh_main_path(card, failed):
    """(a) The main path through make_mesh() over the one card, its one
    shard inline and then in the mesh's worker thread (ThreadedShards),
    each held bit for bit to phase 4's meshless fit (same call, same
    seed) and to the five gates. Returns their launches."""
    import torch
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import fit_spectra_batch, make_mesh
    freq, Zb, res0, tau, gt, rp = KEEP["main"]
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     eps_quantile=EPS_QUANTILE)
    total = {"quad": 0, "traj": 0}
    for form in ("inline", "threaded"):
        threaded = ThreadedShards()
        drt_quad.launches = 0
        traj_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if form == "inline":
            mesh = make_mesh()
            res = fit_spectra_batch(
                freq, Zb, mode="sample", chains=CHAINS, warmup=WARMUP,
                samples=SAMPLES, random_seed=1, ncp=True, sampler="shmc",
                shmc_cfg=cfg, gamma_eval_tau=tau, dtype=np.float32,
                timing=True, mesh=mesh)
        else:
            with threaded as mesh:
                res = fit_spectra_batch(
                    freq, Zb, mode="sample", chains=CHAINS, warmup=WARMUP,
                    samples=SAMPLES, random_seed=1, ncp=True,
                    sampler="shmc", shmc_cfg=cfg, gamma_eval_tau=tau,
                    dtype=np.float32, timing=True, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
        for k in total:
            total[k] += launches[k]
        d, d0 = res.diagnostics, res0.diagnostics
        flagged = int(d["escalated"].sum())
        want = {"quad": 2 + (4 if flagged else 0), "traj": WARMUP + SAMPLES}
        skip = ("phase_s", "traj_ms", "draw_s", "capture_s", "refit_s",
                "state_cfg", "dist_geometry", "shard_layout")
        differ = [f for f in ("coef", "r_inf", "inductance", "gamma_lo",
                              "gamma_hi", "z_scales")
                  if not np.array_equal(getattr(res, f), getattr(res0, f))]
        differ += [k for k in d0 if k not in skip and isinstance(
            d0[k], np.ndarray) and not np.array_equal(d[k], d0[k])]
        rmse, p90, cov = gamma_figures(res, tau, gt, rp)
        gates = {"rmse": rmse < GATE_RMSE, "p90": p90 < GATE_P90,
                 "coverage": cov > GATE_COVERAGE,
                 "min_ess_med": float(np.median(d["min_ess"]))
                 > GATE_MIN_ESS,
                 "logp_rhat_med": float(np.median(d["logp_rhat"]))
                 < GATE_LOGP_RHAT,
                 "bitwise_phase4": not differ,
                 "launches": launches == want,
                 "layout": d["shard_layout"] == ((0, 0, B),)}
        if form == "threaded":
            gates["in_worker_thread"] = threaded.in_workers()
        print(f"mesh main path, {form}: " + json.dumps({
            "mesh": repr(mesh), "shard_layout": d["shard_layout"],
            "shard_threads": threaded.threads,
            "wall_s": wall, "phase_s": d["phase_s"], "rmse_over_rp": rmse,
            "p90_over_rp": p90, "coverage": cov, "escalated": flagged,
            "launches": launches, "expected": want,
            "differ_from_phase4": differ,
            "gates": {k: bool(v) for k, v in gates.items()}})
            + f" [{card}]")
        failed += [f"mesh_main.{form}.{k}" for k, v in gates.items()
                   if not v]
    return total


def mesh_small_fits(card, failed):
    """(b) MAP (no polish), ridge (plain, and the Re-Im CV on a 5-point
    grid), drift and ragged MAP, each at a small size on a one-device
    mesh against the same call without one: equal bit for bit, the
    layout one range on device 0."""
    import torch
    from bayes_drt_tpu_torch import sim
    from bayes_drt_tpu_torch.parallel import (drift_fit_spectra_batch,
                                              fit_spectra_batch,
                                              fit_spectra_ragged, make_mesh,
                                              ridge_fit_spectra_batch)
    mesh = make_mesh()
    freq, Zb = sim.make_benchmark_batch(MESH_B, circuit="ZARC",
                                        noise_level=0.0025, seed=7)
    _, Zr = sim.make_benchmark_batch(MESH_RIDGE_B, circuit="ZARC",
                                     noise_level=0.0025, seed=8)
    dfreq, dtimes, dZ = sim.make_drift_fleet(MESH_DRIFT_B)
    fleet = sim.make_ragged_fleet(MESH_B, RG_SEED)
    cases = {
        "map": lambda **k: fit_spectra_batch(
            freq, Zb, mode="optimize", max_iter=MESH_MAP_ITER,
            random_seed=2, polish=False, **k),
        "ridge": lambda **k: ridge_fit_spectra_batch(freq, Zr, **k),
        "ridge_cv": lambda **k: ridge_fit_spectra_batch(
            freq, Zb, cv_lambdas=MESH_CV_GRID, **k),
        "drift": lambda **k: drift_fit_spectra_batch(
            dfreq, dtimes, dZ, **dict(DRIFT_KW, max_iter=MESH_DRIFT_ITER,
                                      **k)),
        "ragged_map": lambda **k: fit_spectra_ragged(
            fleet, mode="optimize", max_iter=MESH_MAP_ITER, **k)}
    out = {}
    for name, call in cases.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            r0 = call()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r1 = call(mesh=mesh)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        same = all(np.array_equal(getattr(r0, f), getattr(r1, f))
                   for f in ("coef", "r_inf", "inductance", "z_scales"))
        layout = r1.diagnostics["shard_layout"]
        rec = {"meshless_s": t1 - t0, "mesh_s": t2 - t1,
               "shard_layout": layout, "bitwise": same,
               "finite": bool(np.isfinite(r1.coef).all())}
        out[name] = rec
        if not (same and rec["finite"] and len(layout) == 1
                and layout[0][:2] == (0, 0)):
            failed.append(f"mesh_small.{name}")
    print("mesh small fits: " + json.dumps(out) + f" [{card}]")


def store_fit(card, failed):
    """(c) SHMCConfig(traj_store=True) on phase 12's Series-Parallel
    posterior (the generic sampler's store-then-select trajectory, each
    draw one CUDA graph replay) at a short budget, with phase 12's gates,
    its one shard in the mesh's worker thread (ThreadedShards: its graphs
    captured there). Returns its K2 launches."""
    import torch
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import batch
    freq, dists, z_true, zb, tau, truth = sp_setup()
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     eps_quantile=EPS_QUANTILE, traj_store=True)
    drt_quad.launches = 0
    traj_fused.launches = 0
    threaded = ThreadedShards()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with threaded as mesh:
        res = batch.fit_spectra_batch(
            freq, zb[:SP_B_SAMPLE], distributions=dists, nonneg=True,
            sigma_min=0.002, chains=CHAINS, warmup=STORE_BUDGET[0],
            samples=STORE_BUDGET[1], ncp=True, sampler="shmc",
            shmc_cfg=cfg, escalate=False, gamma_eval_tau=tau,
            random_seed=3, timing=True, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    d = res.diagnostics
    fig = sp_figures(res, freq, z_true, tau, truth)
    div = float(np.median(d["divergence_rate"]))
    gates = {"finite": fig["finite"], "z_resid": fig["z_resid_median"]
             <= SP_GATE_Z, "divergence": div <= SP_GATE_SHMC_DIV,
             "drt_rmse": fig["drt_rmse"] <= SP_GATE_DRT_RMSE,
             "route": d["shmc_route"] == "generic-store",
             "in_worker_thread": threaded.in_workers(),
             "launches": launches == {"quad": 2, "traj": 0}}
    print("traj_store series-parallel: " + json.dumps(dict(
        B=SP_B_SAMPLE, budget=[CHAINS, *STORE_BUDGET], wall_s=wall,
        phase_s=d["phase_s"], **fig, divergence_rate_median=div,
        accept_prob_mean=float(np.mean(d["accept_prob"])),
        draw_s_median=float(np.median(np.asarray(d["draw_s"]))),
        capture_s=[float(x) for x in d["capture_s"]],
        streaming_draw_s_median=KEEP["generic_sp"]["draw_s_median"],
        gates={k: bool(v) for k, v in gates.items()})) + f" [{card}]")
    failed += [f"traj_store.{k}" for k, v in gates.items() if not v]
    return launches


def fused_nuts(card, failed):
    """(d) NUTSConfig(fused_draws=True), md8, on the main path's final
    states of FUSED_B spectra (FUSED_B * CHAINS rows, the hand-written
    density) without adaptation, against the flat form with the same
    generator: fused_draws runs the flat form (the JAX package's fused
    chain gives its draws), so the same trees, divergences and draws."""
    import torch
    from bayes_drt_tpu_torch.infer.nuts import NUTSConfig, sample_nuts
    R = FUSED_B * CHAINS
    vg, q, lp, g, eps, m_inv = nuts_rows(torch.float32, KEEP["state"], R)
    trees = {}      # the flat form's graphs, captured once for both runs
    runs = {}
    for form in ("flat", "fused"):
        cfg = NUTSConfig(max_depth=NUTS_DEPTH, fused_draws=form == "fused")
        gen = torch.Generator(device="cuda").manual_seed(5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs[form] = sample_nuts(vg, q, 0, FUSED_NOADAPT, cfg,
                                     generator=gen, metric=m_inv,
                                     init_step_size=eps, graphs=trees)
    (d1, i1), (d2, i2) = runs["flat"], runs["fused"]
    gates = {"same_trees": bool(torch.equal(i1["n_leapfrog"],
                                            i2["n_leapfrog"])),
             "same_divergences": bool(torch.equal(i1["diverging"],
                                                  i2["diverging"])),
             "draws_bitwise": bool(torch.equal(d1, d2)),
             "finite": bool(torch.isfinite(d2).all())}
    print("fused_draws nuts md8: " + json.dumps({
        "budget": [0, FUSED_NOADAPT], "rows": R,
        "n_leapfrog_mean": float(i2["n_leapfrog"].float().mean()),
        "gates": gates}) + f" [{card}]")
    failed += [f"fused.{k}" for k, v in gates.items() if not v]


def precision_ab(card, failed):
    """(e) The reduced-precision A/B: phase 12's generic SHMC fit (the
    same 256 Series-Parallel spectra, budget and seed) at
    SHMCConfig(precision='high'), the posterior's products as tf32x3,
    against phase 12's own run at 'highest': phase 12's gates, seconds a
    draw and the probe bf16x3_grad_err (median, max), phase 12's gates
    enforced on the opt-in arm (the 'fast' preset stays at 'highest':
    tf32x3 took longer a draw). Returns its K2 launches."""
    import torch
    from bayes_drt_tpu_torch.infer.chees import SHMCConfig
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    from bayes_drt_tpu_torch.parallel import batch
    freq, dists, z_true, zb, tau, truth = sp_setup()
    cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=N_STEPS,
                     recompute_grad=True, eps_quantile=EPS_QUANTILE,
                     precision="high")
    drt_quad.launches = 0
    traj_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = batch.fit_spectra_batch(
            freq, zb[:SP_B_SAMPLE], distributions=dists, nonneg=True,
            sigma_min=0.002, chains=CHAINS, warmup=WARMUP, samples=SAMPLES,
            ncp=True, sampler="shmc", shmc_cfg=cfg, escalate=False,
            gamma_eval_tau=tau, random_seed=3, timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quad": drt_quad.launches, "traj": traj_fused.launches}
    d = res.diagnostics
    fig = sp_figures(res, freq, z_true, tau, truth)
    div = float(np.median(d["divergence_rate"]))
    err = np.asarray(d.get("bf16x3_grad_err", [np.nan]))
    high = {"drt_rmse": fig["drt_rmse"], "z_resid": fig["z_resid_median"],
            "divergence_median": div, "wall_s": wall,
            "draw_s_median": float(np.median(np.asarray(d["draw_s"]))),
            "min_ess_median": float(np.median(d["min_ess"])),
            "grad_err_median": float(np.median(err)),
            "grad_err_max": float(np.max(err)), "precision": d["precision"]}
    low = KEEP["generic_sp"]
    highest = {"drt_rmse": low["drt_rmse"], "z_resid": low["z_resid_median"],
               "divergence_median": low["divergence_rate_median"],
               "wall_s": low["wall_s"], "draw_s_median": low["draw_s_median"],
               "min_ess_median": low["min_ess_median"]}
    ab_gates = {"finite": fig["finite"], "z_resid": fig["z_resid_median"]
                <= SP_GATE_Z, "divergence": div <= SP_GATE_SHMC_DIV,
                "drt_rmse": fig["drt_rmse"] <= SP_GATE_DRT_RMSE}
    preset = batch.QUALITY_PRESETS["fast"]["shmc_cfg"].precision
    gates = {"probe_finite": bool(np.isfinite(err).all()),
             "precision_recorded": d["precision"] == "high",
             "launches": launches == {"quad": 2, "traj": 0}, **ab_gates}
    print("precision A/B (generic SHMC, series-parallel, B=256, 4 x "
          f"({WARMUP}+{SAMPLES})): " + json.dumps({
              "highest": highest, "high_tf32x3": high,
              "high_passes_phase12_gates": {k: bool(v)
                                            for k, v in ab_gates.items()},
              "fast_preset_precision": preset,
              "gates": {k: bool(v) for k, v in gates.items()}})
          + f" [{card}]")
    failed += [f"precision.{k}" for k, v in gates.items() if not v]
    return launches


def phase_mesh_arms(card):
    """Phase 18: (a) the main path on a one-card mesh, bit for bit phase
    4; (b) the small entry points on a one-card mesh; (c) traj_store;
    (d) fused_draws; (e) the precision A/B. Returns the kernels' launches
    on (a), (c) and (e)'s driven paths ((b)'s K2 launches are counted
    too)."""
    from bayes_drt_tpu_torch.infer.shmc_flat import traj_fused
    from bayes_drt_tpu_torch.ops.quad import drt_quad
    failed = []
    seconds = {}
    launches = {"quad": 0, "traj": 0}

    def part(name, fn):
        t0 = time.perf_counter()
        drt_quad.launches = 0
        traj_fused.launches = 0
        got = fn(card, failed)
        if got is None:
            got = {"quad": drt_quad.launches, "traj": traj_fused.launches}
        for k in launches:
            launches[k] += got[k]
        seconds[name] = time.perf_counter() - t0

    part("a_mesh_main", mesh_main_path)
    part("b_mesh_small", mesh_small_fits)
    part("c_traj_store", store_fit)
    part("d_fused", fused_nuts)
    part("e_precision", precision_ab)
    print("mesh and arms phase: " + json.dumps({"seconds": seconds,
                                          "launches": launches})
          + f" [{card}]")
    if failed:
        raise AssertionError(f"mesh and arms phase failed: {failed}")
    return launches


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from bayes_drt_tpu_torch import _build
    card = card_line()
    print(card)
    seconds = {}

    def timed(name, fn, *args):
        from bayes_drt_tpu_torch import progcache
        t0 = time.perf_counter()
        out = fn(card, *args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"progcache after {name}: {json.dumps(progcache.stats())}")
        return out

    print("depth cut to make room for phase 18 (the mesh, traj_store, "
          "fused_draws and the precision A/B) and for the CLI's sample "
          "command alone (no gate removed): phase 9's "
          f"CPU rows 512 -> {PARITY_CPU_ROWS}; phase 13 (d)'s test-warmup "
          f"NUTS md10 fit 2x(120+60) -> 2x({INV_NUTS_TEST_WARMUP}+"
          f"{INV_NUTS_TEST_SAMPLES}) (its warmup and the rhat_max gate "
          f"kept); phase 17 (b)'s warm draws "
          f"60 -> {CH_WARM_SAMPLES}; phase 7's budget 4x(10+5) -> "
          f"4x({DEFAULT_WARMUP}+{DEFAULT_SAMPLES}); phase 10's caps 2000 -> "
          f"{MAP_DEFAULT_ITER} and 1500 -> {MAP_RIDGE_ITER}, its parity's "
          f"200 -> {MAP_PARITY_ITER} iterations; phase 11's DDT A parity "
          "81 -> 41 frequencies and NUTS parity 128 -> "
          f"{SP_PARITY_NUTS_B * CHAINS} rows; phase 13's CV parity grid 25 "
          f"-> {len(INV_CV_PARITY_GRID)} lambdas; phase 16's cold ragged "
          f"fit 4x(100+150) -> 4x{RG_WARM_COLD}, its dense parity 256 -> "
          f"{DENSE_PARITY_ROWS} rows; phase 10's and 13's float64 parity 8 "
          f"-> {MAP_PARITY_B} spectra; phase 15's CLI directory 768 + 256 "
          f"-> {CLI_GRIDS[0][0]} + {CLI_GRIDS[1][0]} spectra and its "
          f"optimize command's cap 1500 -> {CLI_MAP_ITER}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds["1 build"] = round(time.perf_counter() - t0, 1)
    print(f"build: {seconds['1 build']:.1f} s for {sorted(logs)} "
          "(nvcc, sm_90a, in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    quad = timed("2 quad", phase_quad)
    timed("3 traj f64", phase_traj_f64)
    if "--check-only" in argv:
        return 0
    launches, state = timed("4 main", phase_main)
    traj = timed("5 traj f32", phase_traj_f32, state)
    esc = timed("6 escalation", phase_escalation)
    dflt = timed("7 default", phase_default)
    timed("8 nuts timing", phase_nuts_timing, state)
    timed("9 parity", phase_parity, state)
    mp = timed("10 map", phase_map)
    timed("10 map parity", phase_map_parity)
    sp = timed("11 multidist", phase_multidist)
    gr = timed("12 generic", phase_generic, state)
    inv = timed("13 inverter", phase_inverter)
    dr = timed("14 drift", phase_drift)
    sc = timed("15 sbc cli", phase_sbc_cli)
    rs = timed("16 resume", phase_resume)
    ch = timed("17 chees", phase_chees)
    it = timed("18 mesh and arms", phase_mesh_arms)
    launches = {k: launches[k] + esc[k] + dflt[k] + mp[k] + sp[k] + gr[k]
                + inv[k] + dr[k] + sc[k] + rs[k] + ch[k] + it[k]
                for k in launches}
    print(f"phase seconds: {json.dumps(seconds)} [{card}]")
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
