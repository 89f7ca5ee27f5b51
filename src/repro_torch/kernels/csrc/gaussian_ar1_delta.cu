// AR(1) transition-factor pair delta for Hopper (sm_90a):
//   l[k, i] = log N(xt | phi'_k xp, s2'_k) - log N(xt | phi_k xp, s2_k)
//
// Replaces the Pallas TPU kernel src/repro/kernels/gaussian_ar1.py
// batched_gaussian_ar1_delta (_kernel at :28-37), plus the gather XLA fuses in
// front of it (src/repro/core/target_builder.py:260-265): with a row-index
// pointer `idx` (K, m) the kernel reads each chain's sections of the shared
// (N,) pools, or of per-chain (K, N) pools (pool_stride = N), in place. With
// idx == null, xt and xp are the (K, m) gathered sections themselves.
//
// What bounds it: bytes. Per section it reads xt and xp (4 or 2 bytes each)
// and one index, writes one float, and does ~16 flops: about 1 flop per
// byte, far below the card's ~20 flop/byte fp32 balance point, so the bound
// is the bytes moved over 3.35 TB/s (HBM3 on the H100 SXM). At the round
// shapes of the stochvol cycle (K = 32, m = 100: ~40 KB) the launch itself
// is the real limit, a few microseconds.
//
// Design against that bound: one thread per section, neighbouring threads
// on neighbouring sections of one chain (the gathered reads scatter, the
// index reads and the output writes coalesce); bf16 pools are upcast with
// __bfloat162float and every sum is fp32, like the TPU kernel's astype.
// The arithmetic repeats the plain version's operation order (the library is
// built with --fmad=false), so kernel and plain version agree to the last
// bits wherever their log agrees.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kS2Floor = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ar1_pair_delta_kernel(const T* __restrict__ xt, const T* __restrict__ xp,
                      const int32_t* __restrict__ idx, long long pool_stride,
                      const float* __restrict__ phi_c, const float* __restrict__ s2_c,
                      const float* __restrict__ phi_p, const float* __restrict__ s2_p,
                      float* __restrict__ out, int k, int m) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)k * m) return;
  const int kk = (int)(e / m);
  const long long src = idx ? (long long)kk * pool_stride + idx[e] : e;
  const float a = to_f32(xt[src]);
  const float b = to_f32(xp[src]);
  const float sc = fmaxf(s2_c[kk], kS2Floor);
  const float sp = fmaxf(s2_p[kk], kS2Floor);
  const float dc = a - phi_c[kk] * b;
  const float dp = a - phi_p[kk] * b;
  const float lc = -0.5f * ((dc * dc) / sc + logf(sc));
  const float lp = -0.5f * ((dp * dp) / sp + logf(sp));
  out[e] = lp - lc;
}

template <typename T>
int launch(const void* xt, const void* xp, const int32_t* idx, long long pool_stride,
           const float* phi_c, const float* s2_c, const float* phi_p, const float* s2_p,
           float* out, int k, int m, cudaStream_t s) {
  const long long total = (long long)k * m;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  ar1_pair_delta_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(xt), static_cast<const T*>(xp), idx, pool_stride, phi_c, s2_c,
      phi_p, s2_p, out, k, m);
  return (int)cudaGetLastError();
}

}  // namespace

// xt, xp: (K, m) sections when idx is null; else pools of N sections, shared
// (pool_stride = 0) or per chain (pool_stride = N), element type fp32 or bf16
// (x_bf16). idx: (K, m) int32 in [0, N) or null. phi_*, s2_*: (K,) fp32.
// out: (K, m) fp32.
extern "C" int ar1_pair_delta(const void* xt, const void* xp, int x_bf16, const int32_t* idx,
                              long long pool_stride, const float* phi_c, const float* s2_c,
                              const float* phi_p, const float* s2_p, float* out, int k, int m,
                              void* stream) {
  if (k <= 0 || m <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(xt, xp, idx, pool_stride, phi_c, s2_c, phi_p, s2_p, out, k, m, s);
  return launch<float>(xt, xp, idx, pool_stride, phi_c, s2_c, phi_p, s2_p, out, k, m, s);
}
