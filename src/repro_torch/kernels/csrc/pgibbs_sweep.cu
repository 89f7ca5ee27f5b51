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
// What bounds it. It reads 2 T K S P floats of randomness (6.4 MB at K = 32,
// S = 200, T = 5, P = 25) and the paths, ~30 flops per particle and step:
// ~2 us of HBM traffic, and the randomness was written just before, so it
// mostly sits in L2. The bound that holds is the step: the max, the sum and
// the inclusive scan over a series' particles, the ancestor search and the
// gather of the chosen values are a chain of ~17 dependent warp shuffles,
// two exponentials and a float32 division, and a series runs T of them in
// turn. One chain's 200 series take about that chain's time; at K = 32 the
// 6 400 warps' chains share the SMs' instruction issue and their shuffle
// and shared-memory unit. The operation orders are fixed: the paths must be
// the earlier kernel's, bit for bit.
//
// Design against that:
//   * every global load first: a chunk of up to 8 steps (all of them where
//     T <= 8) goes from device memory into shared memory with cp.async, the
//     noise and uniforms of a lane's particles, the observations and the
//     retained path, and the parameters and the final-pick uniform are
//     loaded while it flies; the steps then touch only shared memory and
//     registers;
//   * the step loop is one copy of its code, not unrolled (an unrolled
//     chunk of steps ran slower);
//   * a group of G lanes per series, G the smallest power of two >= P up to
//     32, so 32 / G series share a warp where P <= 16 (P = 25 keeps a warp);
//     its sum and scan are the shuffles of a G-lane group, its max one
//     integer reduction (redux) over keys that order like the floats;
//   * the CDF stays in the group's registers where P <= 32: the ancestor
//     search is a fixed-depth binary lifting over shuffles and the chosen
//     particle's value one shuffle more; above 32 particles it goes through
//     shared memory;
//   * lanes past P run the same code on padding slots, masked (weights -inf
//     and 0, CDF entries +inf), so no branch splits a group;
//   * the final pick is one ballot per chunk of particles;
//   * one warp a block while the lattice is small (K = 1, S = 200: 200 warps
//     on 132 SMs), up to four where it fills the card several times over;
//   * the trace-back stays serial on the group's first lane: T dependent
//     shared-memory reads, against a forward step's chain many times longer,
//     so it is a small share at every T and parallel lanes would not pay for
//     their synchronisation.
// The weights, max, sum, division and scan are the earlier warp-per-series
// kernel's float32 operations in its order: lanes past P hold -inf and 0,
// which leave a max and a sum unchanged, so a G-lane tree gives the bits of
// the full-warp one; the searches return the count the earlier bisection
// did. So are the paths, bit for bit.
// Limits: P <= 256 (P / 32 particles a lane where P > 32); K S < 2^26; a
// warp's 32 / G series, each with rows of N2 slots (the smallest power of
// two >= P) for its values and ancestors, its CDF and the stage of one step
// at least ((2 T + 3) N2 + 2 floats a series), within the 227 KB of shared
// memory of one block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;  // steps whose random numbers are staged at once
constexpr int kMaxP = 256;
constexpr int kMaxWarps = 4;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kSMs = 132;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kS2Floor = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The max over a G-lane group. A whole warp takes one integer max (redux)
// over keys that order like the floats; the max of floats is exact, so the
// value is that of the shuffle tree the smaller groups take.
template <int G>
__device__ __forceinline__ float group_max(float v) {
  if constexpr (G == 32) {
    int key = __float_as_int(v);
    key = __reduce_max_sync(kFull, key >= 0 ? key : key ^ 0x7fffffff);
    return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off, G));
    return v;
  }
}

// min(#{j : cdf[j] < v}, p - 1) on a nondecreasing cdf of N2 entries (a
// power of two; the entries past p are +inf), by binary lifting:
// log2(N2) dependent shared-memory reads.
template <int N2>
__device__ __forceinline__ int ancestor(const float* cdf, int p, float v) {
  int pos = 0;
#pragma unroll
  for (int step = N2 / 2; step > 0; step >>= 1)
    if (cdf[pos + step - 1] < v) pos += step;
  return min(pos, p - 1);
}

// The same where lane j of the G-lane group holds cdf[j]: one shuffle a level.
template <int G>
__device__ __forceinline__ int ancestor_in_lanes(float cdf_j, int p, float v) {
  int pos = 0;
#pragma unroll
  for (int step = G / 2; step > 0; step >>= 1)
    if (__shfl_sync(kFull, cdf_j, pos + step - 1, G) < v) pos += step;
  return min(pos, p - 1);
}

template <int G, int R>
__global__ void __launch_bounds__(32 * kMaxWarps)
pgibbs_sweep_kernel(const float* __restrict__ obs, const float* __restrict__ href,
                    const float* __restrict__ phi, const float* __restrict__ s2,
                    const float* __restrict__ noise, const float* __restrict__ u,
                    const float* __restrict__ u_pick, float* __restrict__ out, int k, int s,
                    int t_len, int p, int chunk, float h0) {
  constexpr int SPW = 32 / G;  // series a warp
  constexpr int N2 = G * R;    // particle slots a series: a power of two >= P
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane % G;
  const int n_lat = k * s;  // < 2^31 (the host checks)
  const int slot = (blockIdx.x * (blockDim.x >> 5) + warp) * SPW;
  if (slot >= n_lat) return;  // the whole warp leaves together
  const int mine = slot + lane / G;
  const bool active = mine < n_lat;  // a group past the lattice repeats the last series
  const int lattice = active ? mine : n_lat - 1;
  const int kk = lattice / s, ss = lattice - kk * s;
  float* hs = smem + (size_t)(warp * SPW + lane / G) *
                         (2 * t_len * N2 + N2 + chunk * (2 * N2 + 2));  // [T][N2] particle values
  int* ancs = reinterpret_cast<int*>(hs + t_len * N2);                  // [T][N2] ancestors
  float* cdf = hs + 2 * t_len * N2;                                     // [N2] (R > 1)
  float* st_nz = cdf + N2;                                              // [chunk][N2] noise
  float* st_u = st_nz + chunk * N2;                                     // [chunk][N2] uniforms
  float* st_x = st_u + chunk * N2;                                      // [chunk] observations
  float* st_h = st_x + chunk;                                           // [chunk] retained path
  const size_t plane = (size_t)n_lat * p;  // one step of noise or u
  const float* noise_l = noise + (size_t)lattice * p;
  const float* u_l = u + (size_t)lattice * p;
  // a chunk's global loads, all in flight before its first step
  auto stage = [&](int t0, int nc) {
    const float* nz = noise_l + (size_t)t0 * plane;
    const float* uu = u_l + (size_t)t0 * plane;
#pragma unroll 1
    for (int c = 0; c < nc; ++c, nz += plane, uu += plane) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + G * r;
        if (i < p) {
          cp_async4(st_nz + c * N2 + i, nz + i);
          cp_async4(st_u + c * N2 + i, uu + i);
        }
      }
    }
    for (int c = g; c < nc; c += G) {
      cp_async4(st_x + c, obs + (size_t)ss * t_len + t0 + c);
      cp_async4(st_h + c, href + (size_t)lattice * t_len + t0 + c);
    }
  };
  stage(0, min(chunk, t_len));  // before anything waits on memory
  const float ph = __ldg(phi + kk);
  const float sq = sqrtf(fmaxf(__ldg(s2 + kk), kS2Floor));
  const float upick = __ldg(u_pick + lattice);

  // Lanes past P compute on whatever their slots hold and are masked out:
  // their weights are -inf and 0, their CDF entries +inf, and their values
  // and ancestors land in padding slots, so no branch splits the group.
  float hp[R], cdf_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) hp[r] = h0;

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    const int nc = min(chunk, t_len - t0);
    if (t0 > 0) {
      __syncwarp();  // the last chunk's stage is read
      stage(t0, nc);
    }
    cp_async_wait_all();
    __syncwarp();
    for (int c = 0; c < nc; ++c) {
      const int t = t0 + c;
      const float x = st_x[c];
      const float retained = st_h[c];
      float ht[R], lw[R];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + G * r;
        float h = ph * hp[r] + sq * st_nz[c * N2 + i];
        if (r == 0 && g == 0) h = retained;
        ht[r] = h;
        hs[t * N2 + i] = h;
        const float w = -0.5f * (((x * x) * expf(-h) + h) + kLog2Pi);
        lw[r] = i < p ? w : -INFINITY;
        mx = fmaxf(mx, lw[r]);
      }
      mx = group_max<G>(mx);
      float tot = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + G * r;
        lw[r] = i < p ? expf(lw[r] - mx) : 0.0f;
        tot += lw[r];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) tot += __shfl_xor_sync(kFull, tot, off, G);
      // inclusive scan of the weights in particle order: chunk r is particles
      // G r .. G r + G - 1, scanned across the group, plus the chunks before
      float carry = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + G * r;
        float v = lw[r] / tot;
        if (i >= p) v = 0.0f;
#pragma unroll
        for (int off = 1; off < G; off <<= 1) {
          const float n = __shfl_up_sync(kFull, v, off, G);
          if (g >= off) v += n;
        }
        cdf_r[r] = i < p ? carry + v : INFINITY;
        carry += __shfl_sync(kFull, v, G - 1, G);
      }
      if constexpr (R == 1) {  // the CDF stays in the group's registers
        int a = ancestor_in_lanes<G>(cdf_r[0], p, st_u[c * N2 + g]);  // every lane shuffles
        if (g == 0) a = 0;
        ancs[t * N2 + g] = a;
        hp[0] = __shfl_sync(kFull, ht[0], a, G);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) cdf[g + G * r] = cdf_r[r];
        __syncwarp();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = g + G * r;
          int a = ancestor<N2>(cdf, p, st_u[c * N2 + i]);
          if (i == 0) a = 0;
          ancs[t * N2 + i] = a;
          hp[r] = hs[t * N2 + a];
        }
        __syncwarp();  // cdf is rewritten by the next step
      }
    }
  }
  __syncwarp();  // every value and ancestor is written

  // the final pick counts the last CDF's entries below u_pick with one
  // ballot per particle chunk: the count the search would return
  constexpr unsigned kGroupBits = G == 32 ? kFull : (1u << (G % 32)) - 1;
  const unsigned group = kGroupBits << (lane & ~(G - 1));
  int below = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) below += __popc(__ballot_sync(kFull, cdf_r[r] < upick) & group);
  if (g == 0 && active) {
    int b = min(below, p - 1);
    float* o = out + (size_t)lattice * t_len;
    for (int t = t_len - 1; t >= 0; --t) {
      o[t] = hs[t * N2 + b];
      if (t > 0) b = ancs[(t - 1) * N2 + b];
    }
  }
}

template <int G, int R>
int launch(const float* obs, const float* href, const float* phi, const float* s2,
           const float* noise, const float* u, const float* u_pick, float* out, int k, int s,
           int t_len, int p, int chunk, float h0, size_t per_series, cudaStream_t stream) {
  const size_t per_warp = per_series * (32 / G);
  const long long warps_needed = ((long long)k * s + 32 / G - 1) / (32 / G);
  // one warp a block until the lattice fills the card twice, then up to four
  long long w = warps_needed / (2 * kSMs);
  w = w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
  while (w > 1 && (size_t)w * per_warp > kMaxSmem) --w;
  const size_t smem = (size_t)w * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pgibbs_sweep_kernel<G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((warps_needed + w - 1) / w);
  pgibbs_sweep_kernel<G, R><<<blocks, (unsigned)(32 * w), smem, stream>>>(
      obs, href, phi, s2, noise, u, u_pick, out, k, s, t_len, p, chunk, h0);
  return (int)cudaGetLastError();
}

}  // namespace

// obs: (S, T) fp32; href: (K, S, T) fp32 retained paths; phi, s2: (K,) fp32;
// noise, u: (T, K, S, P) fp32; u_pick: (K, S) fp32; out: (K, S, T) fp32.
extern "C" int pgibbs_sweep(const float* obs, const float* href, const float* phi,
                            const float* s2, const float* noise, const float* u,
                            const float* u_pick, float* out, int k, int s, int t_len, int p,
                            float h0, void* stream) {
  if (k <= 0 || s <= 0 || t_len <= 0) return (int)cudaSuccess;
  if (p <= 0 || p > kMaxP || (long long)k * s * 32 > INT32_MAX) return (int)cudaErrorInvalidValue;
  int n2 = 1;  // particle slots a series: a power of two >= P
  while (n2 < p) n2 <<= 1;
  const int g = n2 < 32 ? n2 : 32;  // lanes a series
  // a warp's series: their values, ancestors and CDF, and the stage of
  // `chunk` steps
  auto warp_bytes = [&](int chunk) {
    return (size_t)(32 / g) * (2 * t_len * n2 + n2 + chunk * (2 * n2 + 2)) * sizeof(float);
  };
  int chunk = t_len < kChunk ? t_len : kChunk;
  while (chunk > 1 && warp_bytes(chunk) > kMaxSmem) --chunk;
  if (warp_bytes(chunk) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t per_series = warp_bytes(chunk) / (32 / g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PGIBBS_ARGS \
  obs, href, phi, s2, noise, u, u_pick, out, k, s, t_len, p, chunk, h0, per_series, st
  switch (n2) {
    case 1: return launch<1, 1>(PGIBBS_ARGS);
    case 2: return launch<2, 1>(PGIBBS_ARGS);
    case 4: return launch<4, 1>(PGIBBS_ARGS);
    case 8: return launch<8, 1>(PGIBBS_ARGS);
    case 16: return launch<16, 1>(PGIBBS_ARGS);
    case 32: return launch<32, 1>(PGIBBS_ARGS);
    case 64: return launch<32, 2>(PGIBBS_ARGS);
    case 128: return launch<32, 4>(PGIBBS_ARGS);
    default: return launch<32, 8>(PGIBBS_ARGS);
  }
#undef PGIBBS_ARGS
}
