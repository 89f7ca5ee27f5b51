// AR(1) transition-factor pair delta for Hopper (sm_90a):
//   l[k, i] = log N(xt | phi'_k xp, s2'_k) - log N(xt | phi_k xp, s2_k)
//
// Replaces the Pallas TPU kernel src/repro/kernels/gaussian_ar1.py
// batched_gaussian_ar1_delta (_kernel at :28-37), plus the gather XLA fuses in
// front of it (src/repro/core/target_builder.py:260-265). Chain k's pools
// start pool_stride elements after chain k - 1's: 0 for the shared (N,)
// pools, N for per-chain (K, N) pools, m for the pre-gathered (K, m)
// sections. Its sections are addressed in one of two forms:
//   * gathered: idx (K, m) row indices into its pools, read in place (the
//     sequential test's rounds);
//   * contiguous: elements first .. first + m - 1 of its pools, no index
//     read at all: the pre-gathered (K, m) sections (first = 0) and the exact
//     transition's full pass over a range of the shared pools (K = 1).
//
// What bounds it. Per section it reads xt and xp (4 or 2 bytes each) and,
// gathered, one index, writes one float and does ~16 flops: about 1 flop per
// byte, far below the card's ~20 flop/byte fp32 balance point, so the floor
// is the bytes over 3.35 TB/s (HBM3 on the H100 SXM). At the rounds' shapes
// (K = 32, m = 100 of per-chain N = 1000: ~40 KB, 0.015 us) and at the exact
// pass of N = 1e5 (1.2 MB, 0.36 us) that floor lies far below the launch
// (~1.9 us), so what is left above the launch is latency: the dependent
// memory round trips a section waits for (the index, then the pools: two in
// the gathered form, one in the contiguous form), its arithmetic, and the
// write.
//
// Design against that:
//   * one section a lane, so a lane's chain is one load trip (two gathered)
//     and one section's arithmetic: four sections a lane from 16-byte loads
//     ran the four sections' float32 divisions one after another and took
//     longer at every exact-pass size of the main path;
//   * a chain a grid row (blockIdx.y); one warp a block while the chains'
//     warps fit on the 132 SMs once (K = 32, m = 100: 128 blocks; one
//     chain's round: 4), up to eight warps a block beyond that, since tens
//     of thousands of one-warp blocks take longer to dispatch than the pass;
//   * the gathered form issues a lane's index load with the chain's
//     parameters beside it, then both pool values together;
//   * each chain's four parameters are read once a warp (lanes 0-3, one
//     load), its clamped variances and their logs evaluated once a warp
//     (lanes 1 and 3) and broadcast by shuffles: the same floats as before,
//     since logf of the same float is the same float;
//   * the contiguous form reads no index: the exact pass over a range of
//     the shared pools, and the pre-gathered sections;
//   * precision bf16 on fp32 pools rounds the loaded values to bf16 in
//     registers (__float2bfloat16_rn, the bits of x.to(bfloat16)), so a bf16
//     call is this one launch with no copy of the pools in front of it.
// `warps` overrides the warps a block (1, 2, 4 or 8; 0 keeps the choice
// above): a lane's section is the same whatever the block, so every choice
// gives the default's bits. repro_torch.kernels.autotune races it.
// The arithmetic repeats the plain version's float32 operations in its order
// (fmaxf, product, difference, square, division, logf, the scale by -0.5; the
// library is built with --fmad=false), so kernel and plain version agree to
// the last bits wherever their log agrees, and every form gives the bits of
// the earlier thread-per-section kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;  // warps a block
constexpr int kSMs = 132;
constexpr int kMaxChains = 65535;  // gridDim.y
constexpr float kS2Floor = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool ROUND>
__device__ __forceinline__ float rounded(float v) {
  if constexpr (ROUND) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Lane j < 4 loads the j-th of chain kk's phi, s2, phi', s2'.
__device__ __forceinline__ float load_param(const float* phi_c, const float* s2_c,
                                            const float* phi_p, const float* s2_p, int kk,
                                            int lane) {
  const float* src = lane == 0 ? phi_c : lane == 1 ? s2_c : lane == 2 ? phi_p : s2_p;
  return lane < 4 ? __ldg(src + kk) : 0.0f;
}

struct Chain {
  float phi_c, sc, lsc, phi_p, sp, lsp;
};

// The chain's constants from load_param's value: clamp and log on lanes 1
// and 3 (the two variances), then broadcast. Every lane must take part.
__device__ __forceinline__ Chain broadcast(float v) {
  const float s = fmaxf(v, kS2Floor);
  const float ls = logf(s);
  Chain c;
  c.phi_c = __shfl_sync(kFull, v, 0);
  c.sc = __shfl_sync(kFull, s, 1);
  c.lsc = __shfl_sync(kFull, ls, 1);
  c.phi_p = __shfl_sync(kFull, v, 2);
  c.sp = __shfl_sync(kFull, s, 3);
  c.lsp = __shfl_sync(kFull, ls, 3);
  return c;
}

__device__ __forceinline__ float pair_delta(float a, float b, const Chain& c) {
  const float dc = a - c.phi_c * b;
  const float dp = a - c.phi_p * b;
  const float lc = -0.5f * ((dc * dc) / c.sc + c.lsc);
  const float lp = -0.5f * ((dp * dp) / c.sp + c.lsp);
  return lp - lc;
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
ar1_gather_kernel(const T* __restrict__ xt, const T* __restrict__ xp,
                  const int32_t* __restrict__ idx, long long pool_stride,
                  const float* __restrict__ phi_c, const float* __restrict__ s2_c,
                  const float* __restrict__ phi_p, const float* __restrict__ s2_p,
                  float* __restrict__ out, int m) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int kk = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = (long long)kk * m + r;
  const int i = r < m ? __ldg(idx + e) : 0;  // lanes past m read section 0
  const float pv = load_param(phi_c, s2_c, phi_p, s2_p, kk, lane);
  const long long src = (long long)kk * pool_stride + i;
  const float a = rounded<ROUND>(to_f32(xt[src]));
  const float b = rounded<ROUND>(to_f32(xp[src]));
  const Chain c = broadcast(pv);
  if (r < m) out[e] = pair_delta(a, b, c);
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
ar1_contig_kernel(const T* __restrict__ xt, const T* __restrict__ xp, long long first,
                  long long pool_stride, const float* __restrict__ phi_c,
                  const float* __restrict__ s2_c, const float* __restrict__ phi_p,
                  const float* __restrict__ s2_p, float* __restrict__ out, int m) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int kk = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const long long src = (long long)kk * pool_stride + first + (r < m ? r : 0);
  const float pv = load_param(phi_c, s2_c, phi_p, s2_p, kk, lane);
  const float a = rounded<ROUND>(to_f32(xt[src]));
  const float b = rounded<ROUND>(to_f32(xp[src]));
  const Chain c = broadcast(pv);
  if (r < m) out[(long long)kk * m + r] = pair_delta(a, b, c);
}

template <typename T, bool ROUND>
int launch(const void* xt_, const void* xp_, const int32_t* idx, long long pool_stride,
           long long first, const float* phi_c, const float* s2_c, const float* phi_p,
           const float* s2_p, float* out, int k, int m, int warps_override, cudaStream_t s) {
  const T* xt = static_cast<const T*>(xt_);
  const T* xp = static_cast<const T*>(xp_);
  // one warp a block while the warps fit on the SMs once, up to kMaxWarps
  const long long warps = (long long)k * ((m + kLanes - 1) / kLanes);
  const int w = warps_override
                    ? warps_override
                    : (int)(warps <= kSMs ? 1 : (warps >= (long long)kSMs * kMaxWarps
                                                     ? kMaxWarps : (warps + kSMs - 1) / kSMs));
  const dim3 grid((unsigned)((m + kLanes * w - 1) / (kLanes * w)), (unsigned)k);
  if (idx)
    ar1_gather_kernel<T, ROUND><<<grid, kLanes * w, 0, s>>>(xt, xp, idx, pool_stride, phi_c,
                                                             s2_c, phi_p, s2_p, out, m);
  else
    ar1_contig_kernel<T, ROUND><<<grid, kLanes * w, 0, s>>>(xt, xp, first, pool_stride, phi_c,
                                                             s2_c, phi_p, s2_p, out, m);
  return (int)cudaGetLastError();
}

}  // namespace

// xt, xp: pools of fp32 or bf16 (x_bf16) elements, chain k's starting
// k * pool_stride elements in. idx: (K, m) int32 sections of each chain's
// pools, or null: elements first .. first + m - 1 of them. phi_*, s2_*: (K,)
// fp32. out: (K, m) fp32. round_bf16 (fp32 pools only): round each value to
// bf16 as it is loaded. warps (1, 2, 4, 8) overrides the warps a block; 0
// keeps the default choice.
extern "C" int ar1_pair_delta(const void* xt, const void* xp, int x_bf16, int round_bf16,
                              const int32_t* idx, long long pool_stride, long long first,
                              const float* phi_c, const float* s2_c, const float* phi_p,
                              const float* s2_p, float* out, int k, int m, int warps,
                              void* stream) {
  if (k <= 0 || m <= 0) return (int)cudaSuccess;
  if (k > kMaxChains || (x_bf16 && round_bf16)) return (int)cudaErrorInvalidValue;
  if (warps != 0 && warps != 1 && warps != 2 && warps != 4 && warps != kMaxWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16, false>(xt, xp, idx, pool_stride, first, phi_c, s2_c, phi_p,
                                         s2_p, out, k, m, warps, s);
  if (round_bf16)
    return launch<float, true>(xt, xp, idx, pool_stride, first, phi_c, s2_c, phi_p, s2_p, out,
                               k, m, warps, s);
  return launch<float, false>(xt, xp, idx, pool_stride, first, phi_c, s2_c, phi_p, s2_p, out,
                              k, m, warps, s);
}
