// Logit pair delta for Hopper (sm_90a): l = log sig(y x.w') - log sig(y x.w).
//
// Replaces two Pallas TPU kernels with one body:
//   src/repro/kernels/batched_loglik.py  batched_logit_delta (K chains, (K, m))
//   src/repro/kernels/logit_loglik.py    logit_delta         (one chain, K = 1)
// plus the gather XLA fused in front of the first (batched_loglik.py:72-85):
// with a row-index pointer `idx` (K, m) into a shared (N, D) pool the kernel
// reads each chain's rows in place, so no (K, m, D) slab is written and read
// back every round.
//
// What bounds it: bytes. Per row it reads D values of x (4 or 2 bytes each),
// one label and one index, and does 4 D flops: about 0.5 flop per byte, far
// below the card's ~20 flop/byte fp32 balance point, so the bound is the bytes
// moved over 3.35 TB/s (HBM3 on the H100 SXM). At the main path's round
// shapes (K = 32, m = 100, D = 50 moves about 0.7 MB) the real limit is the launch
// itself, a few microseconds.
//
// Design against that bound:
//   * the pair (w, w') is staged in shared memory once per block, so x is the
//     only stream from device memory and every x element is read once for
//     both sides of the MH ratio (the TPU kernel's pair fusion);
//   * one warp per row: lanes stride over D (neighbouring lanes on
//     neighbouring addresses), two fp32 accumulators, then a butterfly
//     reduction with __shfl_xor_sync; bf16 x is upcast with __bfloat162float
//     and accumulated in fp32 like the TPU kernel's preferred_element_type;
//   * the ragged edge is masked in the kernel: no padding copy;
//   * blockIdx.y is the chain, blockIdx.x a run of ROWS_PER_BLOCK rows.
// Making it fast at small m (fusing it with the round's Welford merge, CUDA
// graphs over the round) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// log(1 + exp(a)) as max(a, 0) + log1p(exp(-|a|)), the form of logaddexp(0, a).
__device__ __forceinline__ float softplus(float a) {
  return fmaxf(a, 0.0f) + log1pf(expf(-fabsf(a)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
logit_pair_delta_kernel(const T* __restrict__ x, const float* __restrict__ y,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ w_cur,
                        const float* __restrict__ w_prop,
                        float* __restrict__ out, int m, int d) {
  extern __shared__ float sw[];  // [0, d): w of this chain, [d, 2d): w'
  const int k = blockIdx.y;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    sw[j] = w_cur[(size_t)k * d + j];
    sw[d + j] = w_prop[(size_t)k * d + j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row_end = min((int)(blockIdx.x + 1) * kRowsPerBlock, m);
  for (int r = blockIdx.x * kRowsPerBlock + warp; r < row_end; r += nwarps) {
    const size_t slot = (size_t)k * m + r;
    const size_t src = idx ? (size_t)idx[slot] : slot;
    const T* xr = x + src * d;
    float zc = 0.0f, zp = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float xv = to_f32(xr[j]);
      zc += xv * sw[j];
      zp += xv * sw[d + j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      zc += __shfl_xor_sync(0xffffffffu, zc, off);
      zp += __shfl_xor_sync(0xffffffffu, zp, off);
    }
    if (lane == 0) {
      const float yv = y[src];
      out[slot] = softplus(-yv * zc) - softplus(-yv * zp);
    }
  }
}

}  // namespace

// x: (N, D) pool when idx is given, else (K, m, D); y: (N,) or (K, m);
// idx: (K, m) int32 rows of the pool, or null; w_cur, w_prop: (K, D) fp32;
// out: (K, m) fp32. x_bf16 selects the element type of x.
extern "C" int logit_pair_delta(const void* x, int x_bf16, const float* y,
                                const int32_t* idx, const float* w_cur,
                                const float* w_prop, float* out, int k, int m,
                                int d, void* stream) {
  if (k <= 0 || m <= 0) return (int)cudaSuccess;
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock, k);
  const size_t smem = 2 * (size_t)d * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(logit_pair_delta_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    logit_pair_delta_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), y, idx, w_cur, w_prop, out, m, d);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(logit_pair_delta_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    logit_pair_delta_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), y, idx, w_cur, w_prop, out, m, d);
  }
  return (int)cudaGetLastError();
}
