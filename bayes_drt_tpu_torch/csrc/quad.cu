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
// What bounds it on this card: operations. Every node costs one exp and
// one IEEE divide besides the multiply-adds, and in float64 each of those
// is a few dozen instructions on the fp64 pipe (64 a clock per SM). At the
// main path's shapes (N=81, K=101, Q=1000) that is 8.2 M nodes and a
// 65 KB output, so the kernel must spread the nodes over every SM and
// keep enough independent exps in flight to hide their latency.
// Design: one warp per output (8,181 warps at the main path's shapes, a
// full wave of 64 warps on each of the 132 SMs); its 32 lanes split the Q
// nodes, each keeping its own partial sum, and a shuffle tree adds them.
// A block of 8 warps first loads y and phiw into shared memory. The
// Pallas kernel accumulated 128-point chunks across sequential grid steps
// into one VMEM tile; blocks here run unordered, so each warp owns its
// outputs' whole sums, and Q is an argument (no padding).
// Compile without --use_fast_math: exp and the divide must be IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block, one output per warp

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

template <typename T, bool IMAG>
__global__ void __launch_bounds__(NT) drt_quad_kernel(
    const T* __restrict__ s, const T* __restrict__ y,
    const T* __restrict__ phiw, int nk, int nq, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);
  T* ws = ys + nq;
  for (int q = threadIdx.x; q < nq; q += NT) {
    ys[q] = y[q];
    ws[q] = phiw[q];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  constexpr int WPB = NT / 32;
  for (int idx = blockIdx.x * WPB + (threadIdx.x >> 5); idx < nk;
       idx += gridDim.x * WPB) {
    const T sv = s[idx];
    T acc = T(0);
#pragma unroll 4
    for (int q = lane; q < nq; q += 32) {
      if (IMAG) {
        const T e = dexp(-dabs(ys[q] + sv));
        acc += (T(-0.5) * (T(2) * e / (T(1) + e * e))) * ws[q];
      } else {
        const T u = dclip(ys[q] + sv, T(-40), T(40));
        acc += (T(1) / (T(1) + dexp(T(2) * u))) * ws[q];
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[idx] = acc;
  }
}

template <typename T, bool IMAG>
int launch_part(const T* s, const T* y, const T* phiw, int nk, int nq,
                T* out, cudaStream_t stream) {
  const size_t bytes = 2 * (size_t)nq * sizeof(T);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        drt_quad_kernel<T, IMAG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (nk + NT / 32 - 1) / (NT / 32);
  drt_quad_kernel<T, IMAG><<<blocks, NT, bytes, stream>>>(s, y, phiw, nk, nq,
                                                          out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* s, const void* y, const void* phiw, int nk, int nq,
           int imag, void* out, void* stream) {
  if (imag)
    return launch_part<T, true>((const T*)s, (const T*)y, (const T*)phiw, nk,
                                nq, (T*)out, (cudaStream_t)stream);
  return launch_part<T, false>((const T*)s, (const T*)y, (const T*)phiw, nk,
                               nq, (T*)out, (cudaStream_t)stream);
}

}  // namespace

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
