// DRT A-matrix quadrature on Hopper.
//
// Replaces: bayes_drt_tpu/ops/pallas_quad.py, _pallas_drt_A (kernel body
// _drt_kernel_body), the Pallas TPU kernel behind construct_A_drt_pallas.
//
// Computes A[n, k] = sum_q phiw[q] * K(y[q] + s[n, k]) with s = ln(omega_n
// tau_k) and the series-DRT kernels
//   real: 1 / (1 + exp(2 clip(u, -40, 40)))
//   imag: -0.5 sech(u) = -0.5 * 2 e^{-|u|} / (1 + e^{-2|u|})
// phiw folds the Gaussian basis and the trapezoid weights together.
//
// What bounds it: nothing on this card. At the main path's shapes (N=81,
// K=101, Q=1000) it is 8.2 M integrand evaluations and a 65 KB output,
// a few microseconds of work, so the launch dominates.
// Design: one thread per (n, k) output with a sequential loop over the Q
// points. The Pallas kernel accumulated 128-point chunks across sequential
// grid steps into one VMEM tile; blocks here run unordered, so each thread
// owns its whole sum instead, and Q is an argument (no padding).
// Compile without --use_fast_math: exp must be the accurate one.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ float dclip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double dclip(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

template <typename T>
__global__ void drt_quad_kernel(const T* __restrict__ s,
                                const T* __restrict__ y,
                                const T* __restrict__ phiw, int nk, int nq,
                                int imag, T* __restrict__ out) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nk) return;
  const T sv = s[idx];
  T acc = T(0);
  if (imag) {
    for (int q = 0; q < nq; ++q) {
      T e = dexp(-dabs(y[q] + sv));
      acc += (T(-0.5) * (T(2) * e / (T(1) + e * e))) * phiw[q];
    }
  } else {
    for (int q = 0; q < nq; ++q) {
      T u = dclip(y[q] + sv, T(-40), T(40));
      acc += (T(1) / (T(1) + dexp(T(2) * u))) * phiw[q];
    }
  }
  out[idx] = acc;
}

template <typename T>
static int launch(const void* s, const void* y, const void* phiw, int nk,
                  int nq, int imag, void* out, void* stream) {
  const int threads = 128;
  const int blocks = (nk + threads - 1) / threads;
  drt_quad_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)s, (const T*)y, (const T*)phiw, nk, nq, imag, (T*)out);
  return (int)cudaGetLastError();
}

extern "C" int drt_quad_f32(const void* s, const void* y, const void* phiw,
                            int nk, int nq, int imag, void* out,
                            void* stream) {
  return launch<float>(s, y, phiw, nk, nq, imag, out, stream);
}

extern "C" int drt_quad_f64(const void* s, const void* y, const void* phiw,
                            int nk, int nq, int imag, void* out,
                            void* stream) {
  return launch<double>(s, y, phiw, nk, nq, imag, out, stream);
}
