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
// four matvecs and their adjoints are 2*(2n*K) + 6*K^2 FMAs (93,930 at
// n=81, K=101), about 24.6 GFLOP per draw at 4096 rows, against ~24 MB of
// device memory traffic per draw (rows in and out once; A and L stay in
// L2). On CUDA cores that is ~0.37 ms at the 67 TFLOP/s fp32 peak.
//
// Design (simple first): one block of 128 threads owns RB rows (8 in fp32,
// 4 in fp64) for the whole trajectory. Every per-row vector lives in
// dynamic shared memory interleaved as [index][row], so a matvec thread
// owns one output index for all RB rows and each element of A or L read
// from global memory (L1/L2 resident, read coalesced through a transposed
// copy where needed) feeds RB FMAs. Elementwise phases give each thread a
// fixed row (tid % RB), so per-row sums reduce with warp shuffles across
// lanes of equal (lane % RB) and one shared-memory pass across warps. All
// sums are plain fp32/fp64 FMA, no tensor cores (no TF32). Compile without
// --use_fast_math: the freeze and selection logic needs IEEE inf/NaN
// semantics (logaddexp(-inf,-inf) = -inf, (-inf)-(-inf) = NaN so a frozen
// leaf is never taken) and an accurate exp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int NRED = 12;          // sums reduced together per leaf

struct Spec {
  int K, n, D, ncp, nonneg;
  int o_rinf, o_ai, o_ap, o_ar, o_d, o_iu, o_sr, o_u, o_x;
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
  const T* A;      // (2n, K)
  const T* AT;     // (K, 2n)
  const T* L;      // (3, K, K)
  const T* LT;     // (3, K, K), each transposed
  const T* vecs;   // (3, 2n): rinf_vec, induc_vec, lik_mask
  const T* scal;   // (8,)
  T* q_out;        // (R, D)
  T* g_out;        // (R, D)
  T* rs_out;       // (4, R): logp, kin, sacc, ever
  Spec sp;
  int R, n_leap, j;
  T max_e;
};

// per-row scalar slots in shared memory, each RB wide
enum {
  S_LP, S_LP0, S_H0, S_EPS, S_LOGW, S_PLP, S_PKIN, S_SACC, S_DEAD, S_EVER,
  S_TAKE, S_ALIVE, S_LPN, S_KIN,
  S_ER, S_EI, S_ES, S_EAP, S_EAR, S_EAI, S_DS0, S_DS1, S_DS2,
  NSC
};

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

// Sum NV per-thread partials over the threads that own the same row
// (tid % RB): shuffles within a warp, then one pass over warps. Results go
// to out[v * RB + row]. Ends with a barrier.
template <typename T, int RB, int NV>
__device__ void block_reduce(T (&v)[NV], T* red, T* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off >= RB; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  if (lane < RB) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[(warp * NV + i) * RB + lane] = v[i];
  }
  __syncthreads();
  if (tid < NV * RB) {
    const int i = tid / RB, r = tid % RB;
    T s = T(0);
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[(w * NV + i) * RB + r];
    out[i * RB + r] = s;
  }
  __syncthreads();
}

// out[o][r] = sum_k M[k * ld + o] * x[k][r] for o in [0, m), k in [0, kd)
template <typename T, int RB>
__device__ __forceinline__ void matvec_rows(const T* __restrict__ M, int ld,
                                            int kd, int o,
                                            const T* __restrict__ x,
                                            T (&acc)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = T(0);
  for (int k = 0; k < kd; ++k) {
    const T a = __ldg(M + (size_t)k * ld + o);
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = dfma(a, x[k * RB + r], acc[r]);
  }
}

struct Smem {
  // offsets (in elements) of every array; each holds width x RB values
  int q, p, g, qn, pn, gn, pq, pg, minv, tgt, ups, xr, pred, wv, gp, lx,
      su, gx, red, sums, rs, total;
};

template <int RB>
__host__ __device__ inline Smem smem_layout(int D, int K, int n) {
  Smem s;
  s.q = 0;
  s.p = s.q + D * RB;
  s.g = s.p + D * RB;
  s.qn = s.g + D * RB;
  s.pn = s.qn + D * RB;
  s.gn = s.pn + D * RB;
  s.pq = s.gn + D * RB;
  s.pg = s.pq + D * RB;
  s.minv = s.pg + D * RB;
  s.tgt = s.minv + D * RB;
  s.ups = s.tgt + 2 * n * RB;
  s.xr = s.ups + K * RB;
  s.pred = s.xr + K * RB;
  s.wv = s.pred + 2 * n * RB;
  s.gp = s.wv + 2 * n * RB;
  s.lx = s.gp + 2 * n * RB;
  s.su = s.lx + 3 * K * RB;
  s.gx = s.su + K * RB;
  s.red = s.gx + K * RB;
  s.sums = s.red + NW * NRED * RB;
  s.rs = s.sums + NRED * RB;
  s.total = s.rs + NSC * RB;
  return s;
}

// lp and gradient of the rows held in qn; writes gn and rs[S_LPN].
template <typename T, int RB>
__device__ void value_and_grad(const Args<T>& a, const Smem& L, T* sm) {
  const Spec& sp = a.sp;
  const int tid = threadIdx.x, r = tid % RB, i0 = tid / RB;
  constexpr int SR = NT / RB;
  const int K = sp.K, n = sp.n, n2 = 2 * n;
  const T LS2P = T(0.91893853320467274178);   // log(sqrt(2 pi))
  const T LOG15 = T(-1.89711998488588130204);  // log(0.15)
  T* qn = sm + L.qn; T* gn = sm + L.gn; T* ups = sm + L.ups;
  T* xr = sm + L.xr; T* pred = sm + L.pred; T* wv = sm + L.wv;
  T* gp = sm + L.gp; T* lx = sm + L.lx; T* su = sm + L.su; T* gx = sm + L.gx;
  T* rs = sm + L.rs;
  const T smin = a.scal[0], ua = a.scal[1], ub = a.scal[2];
  const T induc_scale = a.scal[3], xs = a.scal[4], cu = a.scal[5];
  const T* rv = a.vecs;
  const T* iv = a.vecs + n2;
  const T* mask = a.vecs + 2 * n2;
  const bool ncp = sp.ncp != 0, nonneg = sp.nonneg != 0;

  // ---- phase 1: per-row scalars, ups and x_raw ----
  if (tid < RB) {
    rs[S_ER * RB + tid] = dexp(qn[sp.o_rinf * RB + tid]);
    rs[S_EI * RB + tid] = dexp(qn[sp.o_iu * RB + tid]);
    rs[S_ES * RB + tid] = dexp(qn[sp.o_sr * RB + tid]);
    rs[S_EAP * RB + tid] = dexp(qn[sp.o_ap * RB + tid]);
    rs[S_EAR * RB + tid] = dexp(qn[sp.o_ar * RB + tid]);
    rs[S_EAI * RB + tid] = dexp(qn[sp.o_ai * RB + tid]);
    rs[S_DS0 * RB + tid] = dexp(qn[(sp.o_d + 0) * RB + tid]);
    rs[S_DS1 * RB + tid] = dexp(qn[(sp.o_d + 1) * RB + tid]);
    rs[S_DS2 * RB + tid] = dexp(qn[(sp.o_d + 2) * RB + tid]);
  }
  for (int i = i0; i < K; i += SR) {
    const T u = qn[(sp.o_u + i) * RB + r];
    const T v = qn[(sp.o_x + i) * RB + r];
    const T up = dexp(u) * T(0.15);
    const T base = nonneg ? dexp(v) : v;
    ups[i * RB + r] = up;
    xr[i * RB + r] = ncp ? base * up : base;
  }
  __syncthreads();

  // ---- phase 2: pred = x A^T + rinf*rv + induc*iv ----
  for (int o = tid; o < n2; o += NT) {
    T acc[RB];
    matvec_rows<T, RB>(a.AT, n2, K, o, xr, acc);
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const T rinf = rs[S_ER * RB + rr] * T(100);
      const T induc = rs[S_EI * RB + rr] * induc_scale;
      pred[o * RB + rr] = acc[rr] * xs + rinf * rv[o] + induc * iv[o];
    }
  }
  __syncthreads();

  // row scalars of this thread's row
  const T er = rs[S_ER * RB + r], ei = rs[S_EI * RB + r];
  const T es = rs[S_ES * RB + r], eap = rs[S_EAP * RB + r];
  const T ear = rs[S_EAR * RB + r], eai = rs[S_EAI * RB + r];
  const T sres = es * T(0.05), a_p = eap * T(0.05);
  const T a_re = ear * T(0.05), a_im = eai * T(0.05);

  // ---- phase 3: likelihood terms, w = dl/dvar, gl = direct dl/dpred ----
  T part[NRED];
#pragma unroll
  for (int i = 0; i < NRED; ++i) part[i] = T(0);
  for (int t = i0; t < n2; t += SR) {
    const int tm = t < n ? t : t - n;
    const T pr = pred[t * RB + r];
    const T pre = pred[tm * RB + r], pim = pred[(tm + n) * RB + r];
    const T e1 = a_p * pr, e2 = a_re * pre, e3 = a_im * pim;
    const T var = smin * smin + sres * sres + e1 * e1 + e2 * e2 + e3 * e3;
    const T resid = sm[L.tgt + t * RB + r] - pr;
    const T ivar = T(1) / var;
    const T m = mask[t];
    part[0] += m * (T(-0.5) * resid * resid * ivar - T(0.5) * dlog(var) - LS2P);
    const T w = m * T(0.5) * (resid * resid * ivar - T(1)) * ivar;
    wv[t * RB + r] = w;
    gp[t * RB + r] = m * resid * ivar;
    part[1] += w;
    part[2] += w * pr * pr;
  }
  __syncthreads();

  // ---- phase 4: g_pred and its scalar sums ----
  for (int t = i0; t < n2; t += SR) {
    const int tm = t < n ? t : t - n;
    const T ws = wv[tm * RB + r] + wv[(tm + n) * RB + r];
    const T pr = pred[t * RB + r];
    const T aa = t < n ? a_re : a_im;
    const T gpv = gp[t * RB + r] + wv[t * RB + r] * (T(2) * (a_p * a_p) * pr)
                  + T(2) * (aa * aa) * pr * ws;
    gp[t * RB + r] = gpv;
    part[3] += gpv * rv[t];
    part[4] += gpv * iv[t];
    if (t < n) {
      const T pim = pred[(t + n) * RB + r];
      part[5] += ws * pr * pr;
      part[6] += ws * pim * pim;
    }
  }
  __syncthreads();

  // ---- phase 5: g_x = x_scale * g_pred A (K outputs) and Lx_m = L_m x_raw
  // (3K outputs) ----
  for (int o = tid; o < 4 * K; o += NT) {
    T acc[RB];
    if (o < K) {
      matvec_rows<T, RB>(a.A, K, n2, o, gp, acc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) gx[o * RB + rr] = xs * acc[rr];
    } else {
      const int m = (o - K) / K, i = (o - K) % K;
      matvec_rows<T, RB>(a.LT + (size_t)m * K * K, K, K, i, xr, acc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) lx[(m * K + i) * RB + rr] = acc[rr];
    }
  }
  __syncthreads();

  // ---- phase 6: q-penalty terms; Lx_m becomes gLx_m = -ds_m Lx_m / ups^2 ----
  const T ds0 = rs[S_DS0 * RB + r], ds1 = rs[S_DS1 * RB + r];
  const T ds2 = rs[S_DS2 * RB + r];
  for (int i = i0; i < K; i += SR) {
    const T up = ups[i * RB + r];
    const T iu2 = T(1) / (up * up);
    const T l0 = lx[(0 * K + i) * RB + r];
    const T l1 = lx[(1 * K + i) * RB + r];
    const T l2 = lx[(2 * K + i) * RB + r];
    const T S = ds0 * l0 * l0 + ds1 * l1 * l1 + ds2 * l2 * l2;
    const T u = qn[(sp.o_u + i) * RB + r];
    part[7] += T(-0.5) * S * iu2 - u - (LOG15 + LS2P);
    part[8] += l0 * l0 * iu2;
    part[9] += l1 * l1 * iu2;
    part[10] += l2 * l2 * iu2;
    su[i * RB + r] = S * iu2;
    lx[(0 * K + i) * RB + r] = -ds0 * l0 * iu2;
    lx[(1 * K + i) * RB + r] = -ds1 * l1 * iu2;
    lx[(2 * K + i) * RB + r] = -ds2 * l2 * iu2;
  }
  __syncthreads();

  // ---- phase 7: g_x += sum_m gLx_m L_m ----
  for (int o = tid; o < K; o += NT) {
    T acc[RB];
    matvec_rows<T, RB>(a.L, K, 3 * K, o, lx, acc);
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) gx[o * RB + rr] += acc[rr];
  }
  __syncthreads();

  // ---- phase 8: ups and coefficient gradients; per-k log-density terms ----
  for (int i = i0; i < K; i += SR) {
    const T up = ups[i * RB + r];
    const T u = qn[(sp.o_u + i) * RB + r];
    const T v = qn[(sp.o_x + i) * RB + r];
    const T xraw = xr[i * RB + r];
    const T gxr = gx[i * RB + r];
    const T emu = dexp(-u);
    T gu = (su[i * RB + r] - T(1)) - (ua + T(1)) + ub * emu + T(1);
    if (ncp) gu += T(1) + gxr * xraw;
    // dups(i) couples ups[i], ups[i+1], ups[i+2] for i in [0, K-2)
    T gud = T(0);
    for (int s = 0; s < 3; ++s) {
      const int b = i - s;             // window whose member s is ups[i]
      if (b < 0 || b > K - 3) continue;
      const T aw = ups[b * RB + r], cw = ups[(b + 1) * RB + r];
      const T bw = ups[(b + 2) * RB + r];
      const T dups = T(0.5) * (cw - T(0.5) * (aw + bw)) / cw;
      const T wd = -dups;
      if (s == 1) gud += wd * T(0.25) * (aw + bw) / (cw * cw);
      else gud += wd * (T(-0.25) / cw);
      if (s == 0) part[11] += T(-0.5) * dups * dups;
    }
    gu += gud * up;
    const T dxdv = nonneg ? xraw : (ncp ? up : T(1));
    T gv = gxr * dxdv;
    if (nonneg) gv += T(1);
    gn[(sp.o_u + i) * RB + r] = gu;
    gn[(sp.o_x + i) * RB + r] = gv;
    // inv-gamma prior on exp(u), Jacobians of u (and v, ncp)
    part[11] += cu - (ua + T(1)) * u - ub * emu + u;
    if (nonneg) part[11] += v;
    if (ncp) part[11] += u;
  }
  block_reduce<T, RB, NRED>(part, sm + L.red, sm + L.sums);

  // ---- per-row scalars: lp and the scalar gradients ----
  if (tid < RB) {
    const int rr = tid;
    const T* sums = sm + L.sums;
    auto sum = [&](int i) { return sums[i * RB + rr]; };
    const T q_r = qn[sp.o_rinf * RB + rr], q_ai = qn[sp.o_ai * RB + rr];
    const T q_ap = qn[sp.o_ap * RB + rr], q_ar = qn[sp.o_ar * RB + rr];
    const T q_iu = qn[sp.o_iu * RB + rr], q_sr = qn[sp.o_sr * RB + rr];
    const T er_ = rs[S_ER * RB + rr], ei_ = rs[S_EI * RB + rr];
    const T es_ = rs[S_ES * RB + rr], eap_ = rs[S_EAP * RB + rr];
    const T ear_ = rs[S_EAR * RB + rr], eai_ = rs[S_EAI * RB + rr];
    const T rinf = er_ * T(100), induc = ei_ * induc_scale;
    const T sres_ = es_ * T(0.05), ap_ = eap_ * T(0.05);
    const T are_ = ear_ * T(0.05), aim_ = eai_ * T(0.05);
    const T c5 = T(5.0 * 1.6094379124341003 - 3.1780538303479458);  // 5 log 5 - lgamma 5
    T lp = sum(0) + sum(7) + sum(11) - T(K - 2) * LS2P;
    lp += T(-0.5) * (er_ * er_ + ei_ * ei_ + es_ * es_ + eap_ * eap_
                     + ear_ * ear_ + eai_ * eai_) - T(6) * LS2P;
    lp += q_r + q_ai + q_ap + q_ar + q_iu + q_sr;
    const T dsv[3] = {rs[S_DS0 * RB + rr], rs[S_DS1 * RB + rr],
                      rs[S_DS2 * RB + rr]};
    for (int m = 0; m < 3; ++m) {
      const T d = qn[(sp.o_d + m) * RB + rr];
      const T emd = dexp(-d);
      lp += c5 - T(6) * d - T(5) * emd + d;
      gn[(sp.o_d + m) * RB + rr] =
          T(-0.5) * sum(8 + m) * dsv[m] + T(1) - T(6) + T(5) * emd;
    }
    if (ncp) lp += T(K) * LOG15;
    rs[S_LPN * RB + rr] = lp;
    gn[sp.o_rinf * RB + rr] = sum(3) * rinf + T(1) - er_ * er_;
    gn[sp.o_iu * RB + rr] = sum(4) * induc + T(1) - ei_ * ei_;
    gn[sp.o_sr * RB + rr] = sum(1) * T(2) * sres_ * sres_ + T(1) - es_ * es_;
    gn[sp.o_ap * RB + rr] = sum(2) * T(2) * ap_ * ap_ + T(1) - eap_ * eap_;
    gn[sp.o_ar * RB + rr] = sum(5) * T(2) * are_ * are_ + T(1) - ear_ * ear_;
    gn[sp.o_ai * RB + rr] = sum(6) * T(2) * aim_ * aim_ + T(1) - eai_ * eai_;
  }
  __syncthreads();
}

template <typename T, int RB>
__global__ void __launch_bounds__(NT) traj_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Spec& sp = a.sp;
  const int D = sp.D, n2 = 2 * sp.n;
  const Smem L = smem_layout<RB>(D, sp.K, sp.n);
  T* q = sm + L.q; T* p = sm + L.p; T* g = sm + L.g;
  T* qn = sm + L.qn; T* pn = sm + L.pn; T* gn = sm + L.gn;
  T* pq = sm + L.pq; T* pg = sm + L.pg; T* minv = sm + L.minv;
  T* rs = sm + L.rs;
  const int tid = threadIdx.x, r = tid % RB, i0 = tid / RB;
  constexpr int SR = NT / RB;
  const int row0 = blockIdx.x * RB;
  // rows past R (ragged last block) duplicate row R-1 and are not stored
  auto grow = [&](int rr) { return min(row0 + rr, a.R - 1); };

  for (int e = tid; e < RB * D; e += NT) {
    const int rr = e / D, d = e % D;
    const size_t gi = (size_t)grow(rr) * D + d;
    const T qv = a.q[gi], gv = a.g[gi];
    q[d * RB + rr] = qv;
    p[d * RB + rr] = -a.p0[gi];
    g[d * RB + rr] = gv;
    pq[d * RB + rr] = qv;
    pg[d * RB + rr] = gv;
    minv[d * RB + rr] = a.minv[gi];
  }
  for (int e = tid; e < RB * n2; e += NT) {
    const int rr = e / n2, t = e % n2;
    sm[L.tgt + t * RB + rr] = a.tgt[(size_t)grow(rr) * n2 + t];
  }
  __syncthreads();
  {
    T kp[1] = {T(0)};
    for (int i = i0; i < D; i += SR) {
      const T pv = p[i * RB + r];
      kp[0] += pv * pv * minv[i * RB + r];
    }
    block_reduce<T, RB, 1>(kp, sm + L.red, rs + S_KIN * RB);
  }
  if (tid < RB) {
    const int gr = grow(tid);
    const T lp0 = a.logp[gr], kin0 = T(0.5) * rs[S_KIN * RB + tid];
    rs[S_LP * RB + tid] = lp0;
    rs[S_LP0 * RB + tid] = lp0;
    rs[S_H0 * RB + tid] = -lp0 + kin0;
    rs[S_EPS * RB + tid] = a.eps[gr];
    rs[S_LOGW * RB + tid] = T(0);
    rs[S_PLP * RB + tid] = lp0;
    rs[S_PKIN * RB + tid] = kin0;
    rs[S_SACC * RB + tid] = T(0);
    rs[S_DEAD * RB + tid] = T(0);
    rs[S_EVER * RB + tid] = T(0);
  }
  __syncthreads();

  for (int it = 0; it < a.n_leap; ++it) {
    if (it == a.j) {
      // the forward leg restarts from the initial point with +p0
      for (int e = tid; e < RB * D; e += NT) {
        const int rr = e / D, d = e % D;
        const size_t gi = (size_t)grow(rr) * D + d;
        q[d * RB + rr] = a.q[gi];
        p[d * RB + rr] = a.p0[gi];
        g[d * RB + rr] = a.g[gi];
      }
      if (tid < RB) {
        rs[S_LP * RB + tid] = rs[S_LP0 * RB + tid];
        rs[S_DEAD * RB + tid] = T(0);
      }
      __syncthreads();
    }
    const T eps = rs[S_EPS * RB + r];
    for (int i = i0; i < D; i += SR) {
      const int x = i * RB + r;
      const T ph = p[x] + T(0.5) * eps * g[x];
      pn[x] = ph;
      qn[x] = q[x] + eps * ph * minv[x];
    }
    __syncthreads();
    value_and_grad<T, RB>(a, L, sm);
    {
      T kp[1] = {T(0)};
      for (int i = i0; i < D; i += SR) {
        const int x = i * RB + r;
        const T pv = pn[x] + T(0.5) * eps * gn[x];
        pn[x] = pv;
        kp[0] += pv * pv * minv[x];
      }
      block_reduce<T, RB, 1>(kp, sm + L.red, rs + S_KIN * RB);
    }
    if (tid < RB) {
      const int rr = tid;
      const T kin = T(0.5) * rs[S_KIN * RB + rr];
      const T lpn = rs[S_LPN * RB + rr];
      const T Hn = -lpn + kin;
      const T H0 = rs[S_H0 * RB + rr];
      const bool badf = isnan(Hn) || (Hn - H0) > a.max_e;
      const bool dead = rs[S_DEAD * RB + rr] > T(0.5);
      const T w = (badf || dead) ? -INFINITY : H0 - Hn;
      const T logw_new = logaddexp(rs[S_LOGW * RB + rr], w);
      const T u = a.usel[(size_t)it * a.R + grow(rr)];
      const bool take = dlog(u) < (w - logw_new);
      if (take) {
        rs[S_PLP * RB + rr] = lpn;
        rs[S_PKIN * RB + rr] = kin;
      }
      rs[S_SACC * RB + rr] += dmin(T(1), dexp(w));
      const bool dead_new = dead || badf;
      if (dead_new) rs[S_EVER * RB + rr] = T(1);
      if (!dead_new) rs[S_LP * RB + rr] = lpn;
      rs[S_DEAD * RB + rr] = dead_new ? T(1) : T(0);
      rs[S_TAKE * RB + rr] = take ? T(1) : T(0);
      rs[S_ALIVE * RB + rr] = dead_new ? T(0) : T(1);
      rs[S_LOGW * RB + rr] = logw_new;
    }
    __syncthreads();
    const bool take = rs[S_TAKE * RB + r] > T(0.5);
    const bool alive = rs[S_ALIVE * RB + r] > T(0.5);
    for (int i = i0; i < D; i += SR) {
      const int x = i * RB + r;
      if (take) {
        pq[x] = qn[x];
        pg[x] = gn[x];
      }
      if (alive) {
        q[x] = qn[x];
        p[x] = pn[x];
        g[x] = gn[x];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < RB * D; e += NT) {
    const int rr = e / D, d = e % D;
    if (row0 + rr >= a.R) continue;
    const size_t gi = (size_t)(row0 + rr) * D + d;
    a.q_out[gi] = pq[d * RB + rr];
    a.g_out[gi] = pg[d * RB + rr];
  }
  if (tid < RB && row0 + tid < a.R) {
    T* o = a.rs_out + row0 + tid;
    o[0] = rs[S_PLP * RB + tid];
    o[a.R] = rs[S_PKIN * RB + tid];
    o[2 * a.R] = rs[S_SACC * RB + tid];
    o[3 * a.R] = rs[S_EVER * RB + tid];
  }
}

template <typename T, int RB>
int launch(const void* q, const void* p0, const void* g, const void* logp,
           const void* eps, const void* minv, const void* tgt,
           const void* usel, const void* A, const void* AT, const void* Lm,
           const void* LT, const void* vecs, const void* scal,
           const int* spec, int R, int n_leap, int j, double max_e,
           void* q_out, void* g_out, void* rs_out, void* stream) {
  Args<T> a;
  a.q = (const T*)q; a.p0 = (const T*)p0; a.g = (const T*)g;
  a.logp = (const T*)logp; a.eps = (const T*)eps; a.minv = (const T*)minv;
  a.tgt = (const T*)tgt; a.usel = (const T*)usel; a.A = (const T*)A;
  a.AT = (const T*)AT; a.L = (const T*)Lm; a.LT = (const T*)LT;
  a.vecs = (const T*)vecs; a.scal = (const T*)scal;
  a.q_out = (T*)q_out; a.g_out = (T*)g_out; a.rs_out = (T*)rs_out;
  a.sp = Spec{spec[0], spec[1], spec[2], spec[3], spec[4], spec[5], spec[6],
              spec[7], spec[8], spec[9], spec[10], spec[11], spec[12],
              spec[13]};
  a.R = R; a.n_leap = n_leap; a.j = j; a.max_e = (T)max_e;
  const Smem L = smem_layout<RB>(a.sp.D, a.sp.K, a.sp.n);
  const size_t bytes = (size_t)L.total * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      traj_kernel<T, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + RB - 1) / RB;
  traj_kernel<T, RB><<<blocks, NT, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define TRAJ_ARGS                                                          \
  const void *q, const void *p0, const void *g, const void *logp,          \
      const void *eps, const void *minv, const void *tgt, const void *usel, \
      const void *A, const void *AT, const void *L, const void *LT,        \
      const void *vecs, const void *scal, const int *spec, int R,          \
      int n_leap, int j, double max_e, void *q_out, void *g_out,           \
      void *rs_out, void *stream
#define TRAJ_PASS                                                           \
  q, p0, g, logp, eps, minv, tgt, usel, A, AT, L, LT, vecs, scal, spec, R, \
      n_leap, j, max_e, q_out, g_out, rs_out, stream

extern "C" int traj_f32(TRAJ_ARGS) { return launch<float, 8>(TRAJ_PASS); }
extern "C" int traj_f64(TRAJ_ARGS) { return launch<double, 4>(TRAJ_PASS); }
