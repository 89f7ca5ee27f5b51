// One conditional-SMC (particle Gibbs) sweep for a (K chains, S series)
// lattice of stochastic-volatility paths on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package this is the XLA-fused
// time-major scan of src/repro/kernels/pgibbs.py:58 (batched_pgibbs_sweep,
// mode="fast", :122-162), one loop body over the whole (K, S, P) slab per
// time step plus a backward scan. In eager PyTorch that is ~15 launches per
// step and per trace-back step, so the whole sweep is one kernel here.
//
// Per (chain k, series s), with P particles and T steps:
//   forward, t = 0 .. T-1:
//     h_t[i] = phi_k * h_prev[i] + sqrt(max(s2_k, 1e-12)) * noise[t, k, s, i]
//     h_t[0] = h_ref[k, s, t]                       (the retained path)
//     logw[i] = -0.5 (x_st^2 exp(-h_t[i]) + h_t[i] + log 2 pi)
//     cdf = inclusive cumsum of softmax(logw)       (max subtracted first)
//     anc[i] = min(#{j : cdf[j] < u[t, k, s, i]}, P - 1), anc[0] = 0
//     h_prev[i] = h_t[anc[i]]
//   final pick: b = min(#{j : cdf_{T-1}[j] < u_pick[k, s]}, P - 1)
//   backward: out[k, s, t] = h_t[b], b = anc_{t-1}[b].
// The reference's final pick is Gumbel-max (jax.random.categorical); an
// inverse-CDF pick from one uniform draws from the same categorical
// distribution. The CDF's last entry may fall short of 1 in float32, which
// is what the clamp to P - 1 is for. All randomness comes from the caller,
// so kernel and plain version see the same numbers; their ancestors differ
// only where a uniform lies within float32 rounding of a CDF boundary (the
// softmax sum and the scan add in another order).
//
// What bounds it: bytes, barely. It reads 2 T K S P floats of randomness
// (6.4 MB at K = 32, S = 200, T = 5, P = 25) and the paths, ~30 flops per
// particle and step: ~2 us of HBM traffic. The real limits are the serial
// dependence over T and the warp-level reductions.
//
// Design: one warp per (k, s); lane l holds particles l, l + 32, ... (P <= 256);
// max, sum and the inclusive scan are warp shuffles; the particle values and
// ancestors of every step (T P floats and ints) and the current CDF stay in
// shared memory, so the trace-back (one lane) never touches device memory
// except to write the path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 8;  // particles per lane: P <= 256
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kS2Floor = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int count_below(const float* cdf, int p, float v) {
  // first j with cdf[j] >= v, i.e. #{j : cdf[j] < v} on a nondecreasing cdf
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void pgibbs_sweep_kernel(const float* __restrict__ obs, const float* __restrict__ href,
                                    const float* __restrict__ phi, const float* __restrict__ s2,
                                    const float* __restrict__ noise, const float* __restrict__ u,
                                    const float* __restrict__ u_pick, float* __restrict__ out,
                                    int k, int s, int t_len, int p, float h0) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lattice = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (lattice >= (long long)k * s) return;  // the whole warp leaves together
  const int kk = (int)(lattice / s), ss = (int)(lattice % s);
  const int per_warp = 2 * t_len * p + p;
  float* hs = smem + (size_t)warp * per_warp;               // [T][P] particle values
  int* ancs = reinterpret_cast<int*>(hs + t_len * p);       // [T][P] ancestors
  float* cdf = hs + 2 * t_len * p;                          // [P]
  const int r_n = (p + 31) / 32;
  const float ph = phi[kk];
  const float sq = sqrtf(fmaxf(s2[kk], kS2Floor));

  float hp[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) hp[r] = h0;

  for (int t = 0; t < t_len; ++t) {
    const float x = obs[(size_t)ss * t_len + t];
    const size_t base = (((size_t)t * k + kk) * s + ss) * p;
    float lw[kMaxR];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int i = lane + 32 * r;
      lw[r] = -INFINITY;
      if (r < r_n && i < p) {
        float ht = ph * hp[r] + sq * noise[base + i];
        if (i == 0) ht = href[((size_t)kk * s + ss) * t_len + t];
        lw[r] = -0.5f * (((x * x) * expf(-ht) + ht) + kLog2Pi);
        hs[t * p + i] = ht;
        mx = fmaxf(mx, lw[r]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float tot = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int i = lane + 32 * r;
      lw[r] = (r < r_n && i < p) ? expf(lw[r] - mx) : 0.0f;
      tot += lw[r];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tot += __shfl_xor_sync(kFull, tot, off);
    // inclusive scan of the weights in particle order: chunk r is particles
    // 32 r .. 32 r + 31, scanned across lanes, plus the total of the chunks before
    float carry = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= r_n) break;
      const int i = lane + 32 * r;
      float v = lw[r] / tot;
      if (i >= p) v = 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += n;
      }
      if (i < p) cdf[i] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int i = lane + 32 * r;
      if (r < r_n && i < p) {
        int a = min(count_below(cdf, p, u[base + i]), p - 1);
        if (i == 0) a = 0;
        ancs[t * p + i] = a;
        hp[r] = hs[t * p + a];
      }
    }
    __syncwarp();  // cdf is rewritten by the next step
  }

  if (lane == 0) {
    int b = min(count_below(cdf, p, u_pick[lattice]), p - 1);
    float* o = out + (size_t)lattice * t_len;
    for (int t = t_len - 1; t >= 0; --t) {
      o[t] = hs[t * p + b];
      if (t > 0) b = ancs[(t - 1) * p + b];
    }
  }
}

}  // namespace

// obs: (S, T) fp32; href: (K, S, T) fp32 retained paths; phi, s2: (K,) fp32;
// noise, u: (T, K, S, P) fp32; u_pick: (K, S) fp32; out: (K, S, T) fp32.
extern "C" int pgibbs_sweep(const float* obs, const float* href, const float* phi,
                            const float* s2, const float* noise, const float* u,
                            const float* u_pick, float* out, int k, int s, int t_len, int p,
                            float h0, void* stream) {
  if (k <= 0 || s <= 0 || t_len <= 0) return (int)cudaSuccess;
  if (p <= 0 || p > 32 * kMaxR) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)(2 * t_len * p + p) * sizeof(float);
  if (per_warp > 227 * 1024) return (int)cudaErrorInvalidValue;
  int warps = (int)((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pgibbs_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const long long lattice = (long long)k * s;
  const unsigned blocks = (unsigned)((lattice + warps - 1) / warps);
  pgibbs_sweep_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, href, phi, s2, noise, u, u_pick, out, k, s, t_len, p, h0);
  return (int)cudaGetLastError();
}
