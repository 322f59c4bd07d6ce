// One draw's whole static multinomial HMC trajectory on Hopper.
//
// Replaces: bayes_drt_tpu/infer/shmc_flat.py, _traj_pallas (the Pallas TPU
// kernel over _leaf_step, flat_value_and_grad and _traj_init_state).
//
// Each row is one chain of the single series-DRT posterior (the Stan
// Series model). Per row the kernel runs n_leap leapfrogs with the value
// and gradient written out by hand: the prediction x.A^T plus offsets, the
// heteroscedastic variance, three L matvecs and their adjoints (the
// q-penalty), the dups smoothness prior, the scalar priors and the
// Jacobians. The backward leg (momentum -p0) flips to the forward leg at
// split j; a leg freezes on NaN or when dH > max_e; the proposal is a
// streaming multinomial (logaddexp against u_sel). Outputs: the selected
// q and grad, and per row [logp, kinetic energy, summed accept stat,
// ever-diverged].
//
// What bounds it on this card: fp32 operations. Per row per leapfrog the
// matvecs are 2 * (2n + 3K) * K FMAs (93,930 at n=81, K=101), about 24.6
// GFLOP per draw at 4096 rows: ~0.37 ms at the 67 TFLOP/s fp32 CUDA-core
// peak, against ~24 MB of device memory traffic (0.007 ms). In practice
// the two products issue from shared memory (three 16-byte loads per 32
// FMAs) and wait at one barrier per staged chunk; the per-element phases
// (exp, log and IEEE divides on every index) are latency-bound.
//
// Design. A and the three L matrices are stacked into one zero-padded
// matrix W (OP x KP) = [A; L0; L1; L2], so a leaf is two matrix products
// over the block's rows: P = W x_raw (prediction and the three L x_raw
// at once) and g = W^T y (y = [x_scale g_pred; dlp/dLx]). One block of NT
// threads owns RB rows, so each element of W read into shared memory
// feeds RB rows. The launch takes the first tile (Cfg) that holds the
// shape: the main tile, 512 threads over 32 rows in fp32 and 16 in fp64
// (128 blocks at R=4096, one wave), for K <= 128 with each product in one
// pass and 32 KB stages (the main path's shapes); the same tile with
// passes, for longer sweeps up to K = 128; and a wide tile, 256 threads
// over 8 rows with 9 basis slots a lane (K <= 288, about a third of the
// shared memory a row-index).
// - Matvecs: W (or W^T) streams through three shared-memory stages (32 KB
//   each; with passes, halved until the block fits) by cp.async, two
//   chunks in flight while one is consumed, one barrier a chunk; the
//   first chunks of the next product are issued before the per-element
//   phase that precedes it. Each thread holds an 8 x RB/8 (outputs x
//   rows) register tile; with passes a product runs over its outputs in
//   passes of NT (P) or NT/4 (g), each staging only its columns. For P a
//   thread's outputs are two runs of four, so a quarter-warp reads 128
//   contiguous bytes of a W^T row; for g the sum over the stacked rows is
//   split over four adjacent lanes and reduced by shuffles. The vectors
//   are [index][row] in shared memory with a row stride padded by 16
//   bytes against bank conflicts. The one-pass tile is compiled apart:
//   the pass loop and the column staging cost the main path ~5% when
//   they are compiled in (register spills).
// - Per-row state: a row belongs to LPR = NT/RB lanes of one warp. Lane
//   s holds q and the half-stepped momentum of basis indices s + LPR c in
//   registers (128 registers a thread at 512 threads); S/ups^2, ups and
//   the nine scalar parameters sit in shared memory, and lane 0 of the
//   row updates the scalars. Per-row sums reduce by warp shuffles, and the
//   per-row scalar step (lp, scalar gradients, kinetic energy, selection)
//   runs on lane 0 with no block-wide pass: four barriers per leaf besides
//   one per staged chunk. Each dups window's two gradient weights are
//   computed once per window into P's rows, free after the transpose.
// - The proposal is written to q_out/g_out on each multinomial take. A
//   frozen leg does no per-element work and keeps no state: its leaves
//   carry weight -inf, and nothing reads its state before the flip at j
//   restores the start point. (Its diverged values would otherwise run
//   exp, log and divide through their slow special-value paths.)
// All sums are plain fp32/fp64 FMA on CUDA cores, no tensor cores (no
// TF32). Compile without --use_fast_math: the freeze and selection logic
// needs IEEE inf/NaN semantics (logaddexp(-inf,-inf) = -inf,
// (-inf)-(-inf) = NaN so a frozen leaf is never taken) and an accurate exp.
// The launch returns SHAPE_UNSUPPORTED (-1) when no tile holds the
// shape (K > 288, or 2n + 6K beyond some 2,800 rows in fp64); the
// wrapper raises it as a ValueError.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STAGE_MAX = 32768;    // bytes of each cp.async stage, at most
constexpr int NSUM = 13;            // per-row sums per leaf (12 + kinetic)
constexpr unsigned FULL = 0xffffffffu;
constexpr int SHAPE_UNSUPPORTED = -1;

struct Spec {
  int K, n, D, ncp, nonneg;
  int o_rinf, o_ai, o_ap, o_ar, o_d, o_iu, o_sr, o_u, o_x;
  int OP, KP;  // W's shape: >= 2n + 3K and >= 2 KP rows, K columns; by 8
};

// Tile-dependent sizes and shared-memory offsets (in elements), computed
// on the host; the kernel reads them from its parameters
struct Lay {
  int KP, OV, OP, SE;           // padded K, stacked rows (real, padded), stage
  int pf, pb, KC, OC;           // pass widths; rows of W^T / W a stage holds
  int nF, nB, npF, npB;         // chunks a pass, passes, of P and of g
  int py, xg, ups, su, rsc, sq, sp, sm, total;
};

template <typename T>
struct Args {
  const T* q;      // (R, D) start position
  const T* p0;     // (R, D) momentum
  const T* g;      // (R, D) gradient at q
  const T* logp;   // (R,)
  const T* eps;    // (R,)
  const T* minv;   // (R, D) diagonal inverse metric
  const T* tgt;    // (R, 2n)
  const T* usel;   // (n_leap, R) selection uniforms
  const T* W;      // (OP, KP) [A; L0; L1; L2], zero padded
  const T* WT;     // (KP, OP) W transposed
  const T* vecs;   // (3, 2n): rinf_vec, induc_vec, lik_mask
  const T* scal;   // (8,)
  T* q_out;        // (R, D)
  T* g_out;        // (R, D)
  T* rs_out;       // (4, R): logp, kin, sacc, ever
  Spec sp;
  int R, n_leap, j;
  T max_e;
  Lay L;
};

// A tile: NT threads over RB rows, SLOTS basis indices a lane. Without
// PASSES it takes only shapes whose products fit one pass each and 32 KB
// stages, and its chunk loops compile to a single pass.
template <typename T, int NT_, int RB_, int SLOTS_, bool PASSES_>
struct Cfg {
  static constexpr int NT = NT_, RB = RB_, SLOTS = SLOTS_;
  static constexpr bool PASSES = PASSES_;
  static constexpr int LPR = NT / RB;            // lanes per row
  static constexpr int RPW = 32 / LPR;           // rows per warp
  static constexpr int KMAX = SLOTS * LPR;       // basis size the slots hold
  static constexpr int VEC = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int XS = RB + VEC;            // padded row stride
  static constexpr int TR = RB / 8;              // rows per matvec tile
  static constexpr int PF = NT;                  // outputs of a P pass
  static constexpr int PB = NT / 4;              // outputs of a g pass
  static_assert(LPR <= 32 && 32 % LPR == 0, "a row's lanes share one warp");
  static_assert(RB % 8 == 0 && NT % 64 == 0, "eight row tiles, warp pairs");
};

template <class C>
Lay layout(const Spec& sp, int SE) {
  constexpr int RB = C::RB;
  Lay l;
  l.KP = sp.KP;
  l.OV = 2 * sp.n + 3 * sp.K;
  l.OP = sp.OP;
  l.SE = SE;
  l.pf = l.OP < C::PF ? l.OP : C::PF;
  l.pb = l.KP < C::PB ? l.KP : C::PB;
  l.KC = SE / l.pf;
  l.OC = SE / l.pb;
  l.nF = l.KC ? (sp.K + l.KC - 1) / l.KC : 0;
  l.nB = l.OC ? (l.OV + l.OC - 1) / l.OC : 0;
  l.npF = (l.OP + C::PF - 1) / C::PF;
  l.npB = (l.KP + C::PB - 1) / C::PB;
  l.py = 3 * SE;                // P, then y: [OP][XS]
  l.xg = l.py + l.OP * C::XS;   // x_raw, then g_x: [KP][XS]
  l.ups = l.xg + l.KP * C::XS;  // ups: [KP][XS]
  l.su = l.ups + l.KP * C::XS;  // S / ups^2 of the q-penalty: [KP][XS]
  l.rsc = l.su + l.KP * C::XS;  // exp of the nine scalar parameters [9][RB]
  l.sq = l.rsc + 9 * RB;        // scalar parameters [9][RB]
  l.sp = l.sq + 9 * RB;         // their half-stepped momenta [9][RB]
  l.sm = l.sp + 9 * RB;         // their inverse metric [9][RB]
  l.total = l.sm + 9 * RB;
  return l;
}

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float dmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double dmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }

// jnp.logaddexp: NaN or same-sign infinities fall through to a + b
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  T delta = a - b;
  if (isnan(delta)) return a + b;
  return dmax(a, b) + dlog1p(dexp(-dabs(delta)));
}

// N consecutive elements from/to shared memory: 16-byte vectors when N
// fills whole vectors (the run is then 16-byte aligned), else one by one
template <int N>
__device__ __forceinline__ void ldv(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void ldv(const double* p, double* o) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + i);
      o[i] = v.x; o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void stv(float* p, const float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = o[i];
  }
}
template <int N>
__device__ __forceinline__ void stv(double* p, const double* o) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<double2*>(p + i) = make_double2(o[i], o[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = o[i];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue chunk g of the forward product (FWD: rows of W^T, k over K) or
// of the transpose (rows of W, o over the OV stacked rows) into stage
// buffer g % 3, dense as [rows][pass width]; with passes, chunk g is
// chunk g % nc of pass g / nc, which covers the outputs [p w, p w + w)
// (columns). Past the last chunk the group is empty, so that every
// thread commits one group per call.
template <class C, bool FWD, typename T>
__device__ __forceinline__ void issue(const Args<T>& a, int g, T* stage,
                                      int SE) {
  constexpr int V = 16 / sizeof(T);
  const Lay& L = a.L;
  const int ld = FWD ? L.OP : L.KP, rows_per = FWD ? L.KC : L.OC;
  const int rows = FWD ? a.sp.K : L.OV;
  const T* src = FWD ? a.WT : a.W;
  T* d = stage + (g % 3) * SE;
  if constexpr (!C::PASSES) {
    const int r0 = g * rows_per;
    if (r0 < rows) {
      const int nv = min(rows_per, rows - r0) * ld / V;
      src += (size_t)r0 * ld;
      for (int v = threadIdx.x; v < nv; v += C::NT)
        cp_async16(d + v * V, src + v * V);
    }
  } else {
    const int nc = FWD ? L.nF : L.nB;
    if (g < nc * (FWD ? L.npF : L.npB)) {
      const int ps = g / nc, c = g - ps * nc;
      const int c0 = ps * (FWD ? L.pf : L.pb);
      const int w = min(FWD ? L.pf : L.pb, ld - c0), wv = w / V;
      const int r0 = c * rows_per, nr = min(rows_per, rows - r0);
      src += (size_t)r0 * ld + c0;
      for (int v = threadIdx.x; v < nr * wv; v += C::NT) {
        const int rr = v / wv, cc = v - rr * wv;
        cp_async16(d + rr * w + cc * V, src + (size_t)rr * ld + cc * V);
      }
    }
  }
  cp_commit();
}

// Sum over the LPR lanes of a row (all lanes end with the sum)
template <int LPR, typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int off = LPR / 2; off >= 1; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <typename T, class C>
__global__ void __launch_bounds__(C::NT, 1) traj_kernel(Args<T> a) {
  constexpr int NT = C::NT, RB = C::RB;
  constexpr int LPR = C::LPR, SLOTS = C::SLOTS, XS = C::XS, TR = C::TR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Spec& sp = a.sp;
  const int K = sp.K, n = sp.n, n2 = 2 * n, D = sp.D;
  const Lay& L = a.L;
  constexpr bool PS = C::PASSES;
  const int SE = PS ? L.SE : STAGE_MAX / (int)sizeof(T);
  T* stage = sm;
  T* py = sm + L.py; T* xg = sm + L.xg; T* ups = sm + L.ups;
  T* sus = sm + L.su;
  T* rsc = sm + L.rsc; T* sq = sm + L.sq; T* spm = sm + L.sp;
  T* smv = sm + L.sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = lane % LPR;                       // lane within its row
  const int r = warp * C::RPW + lane / LPR;       // row within the block
  const int lead = lane & ~(LPR - 1);             // lane 0 of the row
  const int row0 = blockIdx.x * RB;
  // rows past R (ragged last block) duplicate row R-1 and are not stored
  const int gr = min(row0 + r, a.R - 1);
  const bool store = row0 + r < a.R;
  const size_t rb = (size_t)gr * D;
  const bool ncp = sp.ncp != 0, nonneg = sp.nonneg != 0;
  const int so[9] = {sp.o_rinf, sp.o_ai, sp.o_ap, sp.o_ar, sp.o_iu, sp.o_sr,
                     sp.o_d, sp.o_d + 1, sp.o_d + 2};
  const T LS2P = T(0.91893853320467274178);   // log(sqrt(2 pi))
  const T LOG15 = T(-1.89711998488588130204);  // log(0.15)
  const T smin = a.scal[0], ua = a.scal[1], ub = a.scal[2];
  const T induc_scale = a.scal[3], xs = a.scal[4], cu = a.scal[5];
  const T* rv = a.vecs;
  const T* iv = a.vecs + n2;
  const T* mask = a.vecs + 2 * n2;
  const T eps = a.eps[gr], he = T(0.5) * eps;

  // matvec tiles, for rows TR rt + [0, TR) (eight row tiles: four in a
  // warp, two warps). Forward, in a pass of width w from c0: outputs c0 +
  // 4 ot + [0, 4) and c0 + w/2 + 4 ot + [0, 4), so a quarter-warp reads
  // 128 contiguous bytes of a W^T row. Transpose: outputs c0 + 4 it +
  // [0, 4) and c0 + w/2 + 4 it + [0, 4), over the stacked rows o = hb
  // (mod 4), the four residues hb in adjacent lanes.
  const int rt = (warp & 1) * 4 + (lane >> 3);
  const int ot = (warp >> 1) * 8 + (lane & 7);
  const int hb = lane & 3, it = (warp >> 1) * 2 + ((lane >> 2) & 1);

  // per-lane state: position and half-stepped momentum of u_i and x_i for
  // i = s + LPR c; S/ups^2 of the q-penalty from one phase to the next
  T qu[SLOTS], qx[SLOTS], pu[SLOTS], px[SLOTS];
#pragma unroll
  for (int c = 0; c < SLOTS; ++c) qu[c] = qx[c] = pu[c] = px[c] = T(0);
  // per-row scalars, meaningful on the row's lane 0 (dead on every lane:
  // a frozen leg does no per-element work until the flip restarts it)
  T H0 = T(0), logw = T(0), plp = T(0), pkin = T(0), sacc = T(0);
  bool dead = false, ever = false;

  // the start point: kinetic energy, and the initial proposal (weight 1)
  {
    T kp = T(0);
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      const int i = s + LPR * c;
      if (i < K) {
        for (int h = 0; h < 2; ++h) {
          const size_t d = rb + (h ? sp.o_x : sp.o_u) + i;
          const T pv = a.p0[d];
          kp += pv * pv * a.minv[d];
          if (store) { a.q_out[d] = a.q[d]; a.g_out[d] = a.g[d]; }
        }
      }
    }
    if (s == 0) {
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const size_t d = rb + so[m];
        const T pv = a.p0[d];
        smv[m * RB + r] = a.minv[d];
        kp += pv * pv * smv[m * RB + r];
        if (store) { a.q_out[d] = a.q[d]; a.g_out[d] = a.g[d]; }
      }
    }
    kp = row_sum<LPR>(kp);
    const T lp0 = a.logp[gr], kin0 = T(0.5) * kp;
    H0 = -lp0 + kin0;
    plp = lp0;
    pkin = kin0;
  }
  issue<C, true>(a, 0, stage, SE);
  issue<C, true>(a, 1, stage, SE);

  for (int step = 0; step < a.n_leap; ++step) {
    __syncwarp();
    // ---- restart a leg: the backward leg from -p0 at step 0 (unless j is
    // 0), the forward leg from +p0 at step j; then the first half step ----
    if (step == 0 || step == a.j) {
      const T sg = step == a.j ? T(1) : T(-1);
#pragma unroll
      for (int c = 0; c < SLOTS; ++c) {
        const int i = s + LPR * c;
        if (i < K) {
          const size_t du = rb + sp.o_u + i, dx = rb + sp.o_x + i;
          qu[c] = a.q[du];
          qx[c] = a.q[dx];
          pu[c] = sg * a.p0[du] + he * a.g[du];
          px[c] = sg * a.p0[dx] + he * a.g[dx];
        }
      }
      if (s == 0) {
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          const size_t d = rb + so[m];
          sq[m * RB + r] = a.q[d];
          spm[m * RB + r] = sg * a.p0[d] + he * a.g[d];
        }
      }
      dead = false;
    }

    // ---- drift, then ups and x_raw for the forward product ----
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      const int i = s + LPR * c;
      if (i < K && !dead) {
        qu[c] = qu[c] + eps * pu[c] * __ldg(a.minv + rb + sp.o_u + i);
        qx[c] = qx[c] + eps * px[c] * __ldg(a.minv + rb + sp.o_x + i);
        const T up = dexp(qu[c]) * T(0.15);
        const T base = nonneg ? dexp(qx[c]) : qx[c];
        ups[i * XS + r] = up;
        xg[i * XS + r] = ncp ? base * up : base;
      }
    }
    if (s == 0 && !dead) {
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const T qv = sq[m * RB + r] + eps * spm[m * RB + r] * smv[m * RB + r];
        sq[m * RB + r] = qv;
        rsc[m * RB + r] = dexp(qv);
      }
    }

    // ---- P = W x_raw: pred (before scale and offsets) and L_m x_raw ----
    for (int ps = 0; ps < (PS ? L.npF : 1); ++ps) {
      const int c0 = PS ? ps * L.pf : 0;
      const int w = PS ? min(L.pf, L.OP - c0) : L.OP;
      const bool on = ot < w / 8;
      T acc[8][TR];
#pragma unroll
      for (int o = 0; o < 8; ++o)
#pragma unroll
        for (int q = 0; q < TR; ++q) acc[o][q] = T(0);
      for (int c = 0; c < L.nF; ++c) {
        const int g = ps * L.nF + c;
        cp_wait1();
        __syncthreads();
        issue<C, true>(a, g + 2, stage, SE);
        if (on) {
          const T* S = stage + (g % 3) * L.SE;
          const int k0 = c * L.KC, nk = min(L.KC, K - k0);
          for (int kk = 0; kk < nk; ++kk) {
            T m[8], x[TR];
            ldv<4>(S + kk * w + 4 * ot, m);
            ldv<4>(S + kk * w + w / 2 + 4 * ot, m + 4);
            ldv<TR>(xg + (k0 + kk) * XS + TR * rt, x);
#pragma unroll
            for (int o = 0; o < 8; ++o)
#pragma unroll
              for (int q = 0; q < TR; ++q) acc[o][q] = dfma(m[o], x[q], acc[o][q]);
          }
        }
      }
      if (on) {
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int oo = c0 + (o < 4 ? 0 : w / 2) + 4 * ot + (o & 3);
          stv<TR>(py + oo * XS + TR * rt, acc[o]);
        }
      }
    }
    __syncthreads();
    issue<C, false>(a, 0, stage, SE);
    issue<C, false>(a, 1, stage, SE);

    // ---- likelihood and q-penalty; P becomes y in place ----
    T part[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) part[i] = T(0);
    const T er = rsc[0 * RB + r], eai = rsc[1 * RB + r];
    const T eap = rsc[2 * RB + r], ear = rsc[3 * RB + r];
    const T ei = rsc[4 * RB + r], es = rsc[5 * RB + r];
    const T ds0 = rsc[6 * RB + r], ds1 = rsc[7 * RB + r];
    const T ds2 = rsc[8 * RB + r];
    const T rinf = er * T(100), induc = ei * induc_scale;
    const T sres = es * T(0.05), a_p = eap * T(0.05);
    const T a_re = ear * T(0.05), a_im = eai * T(0.05);
    for (int tm = dead ? n : s; tm < n; tm += LPR) {
      // the real (tm) and imaginary (tm + n) points share a variance term
      const int tt[2] = {tm, tm + n};
      T pr[2], w[2], gl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pr[h] = py[tt[h] * XS + r] * xs + rinf * rv[tt[h]] + induc * iv[tt[h]];
      const T e2 = a_re * pr[0], e3 = a_im * pr[1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tt[h];
        const T e1 = a_p * pr[h];
        const T var = smin * smin + sres * sres + e1 * e1 + e2 * e2 + e3 * e3;
        const T resid = __ldg(a.tgt + (size_t)gr * n2 + t) - pr[h];
        const T ivar = T(1) / var;
        const T m = mask[t];
        part[0] += m * (T(-0.5) * resid * resid * ivar - T(0.5) * dlog(var) - LS2P);
        w[h] = m * T(0.5) * (resid * resid * ivar - T(1)) * ivar;
        gl[h] = m * resid * ivar;
        part[1] += w[h];
        part[2] += w[h] * pr[h] * pr[h];
      }
      const T ws = w[0] + w[1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tt[h];
        const T aa = h ? a_im : a_re;
        const T gpv = gl[h] + w[h] * (T(2) * (a_p * a_p) * pr[h])
                      + T(2) * (aa * aa) * pr[h] * ws;
        part[3] += gpv * rv[t];
        part[4] += gpv * iv[t];
        py[t * XS + r] = xs * gpv;
      }
      part[5] += ws * pr[0] * pr[0];
      part[6] += ws * pr[1] * pr[1];
    }
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      const int i = s + LPR * c;
      if (i < K && !dead) {
        const T up = ups[i * XS + r];
        const T iu2 = T(1) / (up * up);
        T* l = py + (n2 + i) * XS + r;
        const T l0 = l[0], l1 = l[K * XS], l2 = l[2 * K * XS];
        const T S = ds0 * l0 * l0 + ds1 * l1 * l1 + ds2 * l2 * l2;
        part[7] += T(-0.5) * S * iu2 - qu[c] - (LOG15 + LS2P);
        part[8] += l0 * l0 * iu2;
        part[9] += l1 * l1 * iu2;
        part[10] += l2 * l2 * iu2;
        sus[i * XS + r] = S * iu2;
        l[0] = -ds0 * l0 * iu2;
        l[K * XS] = -ds1 * l1 * iu2;
        l[2 * K * XS] = -ds2 * l2 * iu2;
      }
    }

    // ---- g_x = W^T y ----
    for (int ps = 0; ps < (PS ? L.npB : 1); ++ps) {
      const int c0 = PS ? ps * L.pb : 0;
      const int w = PS ? min(L.pb, L.KP - c0) : L.KP;
      const bool on = it < w / 8;
      T acc[8][TR];
#pragma unroll
      for (int o = 0; o < 8; ++o)
#pragma unroll
        for (int q = 0; q < TR; ++q) acc[o][q] = T(0);
      for (int c = 0; c < L.nB; ++c) {
        const int g = ps * L.nB + c;
        cp_wait1();
        __syncthreads();
        issue<C, false>(a, g + 2, stage, SE);
        if (on) {
          const T* S = stage + (g % 3) * L.SE;
          const int o0 = c * L.OC, no = min(L.OC, L.OV - o0);
          for (int oo = hb; oo < no; oo += 4) {
            T m[8], y[TR];
            ldv<4>(S + oo * w + 4 * it, m);
            ldv<4>(S + oo * w + w / 2 + 4 * it, m + 4);
            ldv<TR>(py + (o0 + oo) * XS + TR * rt, y);
#pragma unroll
            for (int o = 0; o < 8; ++o)
#pragma unroll
              for (int q = 0; q < TR; ++q) acc[o][q] = dfma(m[o], y[q], acc[o][q]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < 8; ++o)
#pragma unroll
        for (int q = 0; q < TR; ++q) {
          acc[o][q] += __shfl_xor_sync(FULL, acc[o][q], 1);
          acc[o][q] += __shfl_xor_sync(FULL, acc[o][q], 2);
        }
      if (on && hb == 0) {
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int i = c0 + (o < 4 ? 0 : w / 2) + 4 * it + (o & 3);
          stv<TR>(xg + i * XS + TR * rt, acc[o]);
        }
      }
    }
    __syncthreads();
    if (step + 1 < a.n_leap) {
      issue<C, true>(a, 0, stage, SE);
      issue<C, true>(a, 1, stage, SE);
    }

    // ---- ups and coefficient gradients, the kick, kinetic energy ----
    // dups(b) couples ups[b], ups[b+1], ups[b+2] for b in [0, K-2): each
    // window's weight on its outer members (rows [0, KP) of P, free after
    // the transpose) and on its middle one (rows [KP, 2 KP))
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      const int b = s + LPR * c;
      if (b < K - 2 && !dead) {
        const T aw = ups[b * XS + r], cw = ups[(b + 1) * XS + r];
        const T bw = ups[(b + 2) * XS + r];
        const T dups = T(0.5) * (cw - T(0.5) * (aw + bw)) / cw;
        const T wd = -dups;
        py[b * XS + r] = wd * (T(-0.25) / cw);
        py[(L.KP + b) * XS + r] = wd * T(0.25) * (aw + bw) / (cw * cw);
        part[11] += T(-0.5) * dups * dups;
      }
    }
    __syncwarp();
    T gu_[SLOTS], gv_[SLOTS];
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      const int i = s + LPR * c;
      gu_[c] = gv_[c] = T(0);
      if (i < K && !dead) {
        const T up = ups[i * XS + r];
        const T u = qu[c], v = qx[c];
        const T base = nonneg ? dexp(v) : v;
        const T xraw = ncp ? base * up : base;
        const T gxr = xg[i * XS + r];
        const T emu = dexp(-u);
        T gu = (sus[i * XS + r] - T(1)) - (ua + T(1)) + ub * emu + T(1);
        if (ncp) gu += T(1) + gxr * xraw;
        // the windows whose member 0, 1, 2 is ups[i]
        T gud = T(0);
        if (i <= K - 3) gud += py[i * XS + r];
        if (i >= 1 && i <= K - 2) gud += py[(L.KP + i - 1) * XS + r];
        if (i >= 2) gud += py[(i - 2) * XS + r];
        gu += gud * up;
        const T dxdv = nonneg ? xraw : (ncp ? up : T(1));
        T gv = gxr * dxdv;
        if (nonneg) gv += T(1);
        // inv-gamma prior on exp(u), Jacobians of u (and v, ncp)
        part[11] += cu - (ua + T(1)) * u - ub * emu + u;
        if (nonneg) part[11] += v;
        if (ncp) part[11] += u;
        gu_[c] = gu;
        gv_[c] = gv;
        pu[c] = pu[c] + he * gu;
        px[c] = px[c] + he * gv;
        part[12] += pu[c] * pu[c] * __ldg(a.minv + rb + sp.o_u + i)
                    + px[c] * px[c] * __ldg(a.minv + rb + sp.o_x + i);
      }
    }
#pragma unroll
    for (int i = 0; i < NSUM; ++i) part[i] = row_sum<LPR>(part[i]);

    // ---- per-row scalars on the row's lane 0: lp, the scalar gradients
    // and kick, the energy and the multinomial selection ----
    int take = 0;
    T gs[9];
    if (s == 0 && !dead) {
      const T q_r = sq[0 * RB + r], q_ai = sq[1 * RB + r];
      const T q_ap = sq[2 * RB + r], q_ar = sq[3 * RB + r];
      const T q_iu = sq[4 * RB + r], q_sr = sq[5 * RB + r];
      const T c5 = T(5.0 * 1.6094379124341003 - 3.1780538303479458);  // 5 log 5 - lgamma 5
      T lp = part[0] + part[7] + part[11] - T(K - 2) * LS2P;
      lp += T(-0.5) * (er * er + ei * ei + es * es + eap * eap
                       + ear * ear + eai * eai) - T(6) * LS2P;
      lp += q_r + q_ai + q_ap + q_ar + q_iu + q_sr;
      const T dsv[3] = {ds0, ds1, ds2};
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const T d = sq[(6 + m) * RB + r];
        const T emd = dexp(-d);
        lp += c5 - T(6) * d - T(5) * emd + d;
        gs[6 + m] = T(-0.5) * part[8 + m] * dsv[m] + T(1) - T(6) + T(5) * emd;
      }
      if (ncp) lp += T(K) * LOG15;
      gs[0] = part[3] * rinf + T(1) - er * er;
      gs[1] = part[6] * T(2) * a_im * a_im + T(1) - eai * eai;
      gs[2] = part[2] * T(2) * a_p * a_p + T(1) - eap * eap;
      gs[3] = part[5] * T(2) * a_re * a_re + T(1) - ear * ear;
      gs[4] = part[4] * induc + T(1) - ei * ei;
      gs[5] = part[1] * T(2) * sres * sres + T(1) - es * es;
      T kp = part[12];
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const T pv = spm[m * RB + r] + he * gs[m];
        spm[m * RB + r] = pv;
        kp += pv * pv * smv[m * RB + r];
      }
      const T kin = T(0.5) * kp;
      const T Hn = -lp + kin;
      const bool badf = isnan(Hn) || (Hn - H0) > a.max_e;
      const T w = badf ? -INFINITY : H0 - Hn;
      const T logw_new = logaddexp(logw, w);
      const T u = a.usel[(size_t)step * a.R + gr];
      take = dlog(u) < (w - logw_new);
      if (take) {
        plp = lp;
        pkin = kin;
      }
      sacc += dmin(T(1), dexp(w));
      dead = badf;
      ever = ever || dead;
      logw = logw_new;
    }
    take = __shfl_sync(FULL, take, lead);
    dead = __shfl_sync(FULL, (int)dead, lead) != 0;
    if (take && store) {
#pragma unroll
      for (int c = 0; c < SLOTS; ++c) {
        const int i = s + LPR * c;
        if (i < K) {
          a.q_out[rb + sp.o_u + i] = qu[c];
          a.q_out[rb + sp.o_x + i] = qx[c];
          a.g_out[rb + sp.o_u + i] = gu_[c];
          a.g_out[rb + sp.o_x + i] = gv_[c];
        }
      }
      if (s == 0) {
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          a.q_out[rb + so[m]] = sq[m * RB + r];
          a.g_out[rb + so[m]] = gs[m];
        }
      }
    }
    // the next leaf's first half step (a restart overrides it)
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      pu[c] = pu[c] + he * gu_[c];
      px[c] = px[c] + he * gv_[c];
    }
    if (s == 0 && !dead) {
#pragma unroll
      for (int m = 0; m < 9; ++m) spm[m * RB + r] += he * gs[m];
    }
  }

  if (s == 0 && store) {
    T* o = a.rs_out + gr;
    o[0] = plp;
    o[a.R] = pkin;
    o[2 * a.R] = sacc;
    o[3 * a.R] = ever ? T(1) : T(0);
  }
}

// Launch with tile C if it holds K and fits the card's shared memory with
// stages of at least one row; else SHAPE_UNSUPPORTED
template <class C, typename T>
int run(Args<T> a, cudaStream_t stream) {
  if (a.sp.K > C::KMAX) return SHAPE_UNSUPPORTED;
  int dev = 0, smax = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smax, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  Lay L;
  for (int b = STAGE_MAX;; b /= 2) {
    L = layout<C>(a.sp, b / (int)sizeof(T));
    if (L.SE < L.pf || L.SE < L.pb) return SHAPE_UNSUPPORTED;
    if ((size_t)L.total * sizeof(T) <= (size_t)smax) break;
    if (!C::PASSES) return SHAPE_UNSUPPORTED;
  }
  if (!C::PASSES && (L.npF > 1 || L.npB > 1)) return SHAPE_UNSUPPORTED;
  a.L = L;
  const size_t bytes = (size_t)L.total * sizeof(T);
  err = cudaFuncSetAttribute(traj_kernel<T, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.R + C::RB - 1) / C::RB;
  traj_kernel<T, C><<<blocks, C::NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, class Main, class MainP, class Wide>
int launch(const void* q, const void* p0, const void* g, const void* logp,
           const void* eps, const void* minv, const void* tgt,
           const void* usel, const void* W, const void* WT, const void* vecs,
           const void* scal, const int* spec, int R, int n_leap, int j,
           double max_e, void* q_out, void* g_out, void* rs_out,
           void* stream) {
  Args<T> a;
  a.q = (const T*)q; a.p0 = (const T*)p0; a.g = (const T*)g;
  a.logp = (const T*)logp; a.eps = (const T*)eps; a.minv = (const T*)minv;
  a.tgt = (const T*)tgt; a.usel = (const T*)usel; a.W = (const T*)W;
  a.WT = (const T*)WT; a.vecs = (const T*)vecs; a.scal = (const T*)scal;
  a.q_out = (T*)q_out; a.g_out = (T*)g_out; a.rs_out = (T*)rs_out;
  a.sp = Spec{spec[0], spec[1], spec[2], spec[3], spec[4], spec[5], spec[6],
              spec[7], spec[8], spec[9], spec[10], spec[11], spec[12],
              spec[13], spec[14], spec[15]};
  a.R = R; a.n_leap = n_leap; a.j = j; a.max_e = (T)max_e;
  const Spec& s = a.sp;
  // W's layout (shmc_flat.stacked_shape): the dups weights borrow 2 KP
  // rows of the stacked product
  if (s.OP % 8 || s.KP % 8 || s.OP < 2 * s.n + 3 * s.K || s.KP < s.K
      || s.OP < 2 * s.KP)
    return (int)cudaErrorInvalidValue;
  int err = run<Main>(a, (cudaStream_t)stream);
  if (err == SHAPE_UNSUPPORTED) err = run<MainP>(a, (cudaStream_t)stream);
  if (err == SHAPE_UNSUPPORTED) err = run<Wide>(a, (cudaStream_t)stream);
  return err;
}

using F32Main = Cfg<float, 512, 32, 8, false>;
using F32MainP = Cfg<float, 512, 32, 8, true>;
using F32Wide = Cfg<float, 256, 8, 9, true>;
using F64Main = Cfg<double, 512, 16, 4, false>;
using F64MainP = Cfg<double, 512, 16, 4, true>;
using F64Wide = Cfg<double, 256, 8, 9, true>;

}  // namespace

#define TRAJ_ARGS                                                          \
  const void *q, const void *p0, const void *g, const void *logp,          \
      const void *eps, const void *minv, const void *tgt, const void *usel, \
      const void *W, const void *WT, const void *vecs, const void *scal,   \
      const int *spec, int R, int n_leap, int j, double max_e,             \
      void *q_out, void *g_out, void *rs_out, void *stream
#define TRAJ_PASS                                                        \
  q, p0, g, logp, eps, minv, tgt, usel, W, WT, vecs, scal, spec, R,      \
      n_leap, j, max_e, q_out, g_out, rs_out, stream

extern "C" int traj_f32(TRAJ_ARGS) {
  return launch<float, F32Main, F32MainP, F32Wide>(TRAJ_PASS);
}
extern "C" int traj_f64(TRAJ_ARGS) {
  return launch<double, F64Main, F64MainP, F64Wide>(TRAJ_PASS);
}
