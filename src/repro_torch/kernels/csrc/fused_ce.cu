// Per-token LM log-likelihood for Hopper (sm_90a):
//   out[k, t] = log softmax(h[k, t] . W_k^T)[target[k, t]]
// online over vocabulary tiles, never building the (T, V) logits.
//
// Replaces two Pallas TPU kernels with one body:
//   src/repro/kernels/fused_ce.py  fused_ce          (one chain, K = 1)
//   src/repro/kernels/fused_ce.py  batched_fused_ce  (K chains; table shared
//                                                     (V, D) or per chain (K, V, D))
// plus the gather XLA fuses in front of them in the `ce` family
// (src/repro/core/target_builder.py:268-293): with a row-index pointer `idx`
// (K, T) into a shared (N, D) pool of hidden states (and its (N,) targets) the
// kernel reads each chain's rows in place.
//
// What bounds it: operations. Per chain a call reads the (V, D) table once
// (1.07 GB in fp32 at V = 65024, D = 4096) and does 2 T V D flops (53 GFLOP at
// T = 100): about 50 flops per table byte, above the card's ~20 flop/byte
// fp32 balance point, so the bound is the flops over the fp32 rate of the
// CUDA cores (67 TFLOP/s); the tensor cores are not used here.
//
// Design against that bound (a simple kernel that is right first):
//   * grid (vocab split, token tile, chain): a block owns 128 tokens of one
//     chain and a run of 128-column vocabulary tiles. The vocabulary is split
//     across blocks because the chain and token axes alone give one block at
//     K = 1, T = 100, leaving the table to stream through one SM;
//   * per vocabulary tile the block computes the 128 x 128 logits as an
//     SGEMM: D is walked in chunks of 16 staged in shared memory (a token row
//     at D = 4096 does not fit whole), the next chunk prefetched into
//     registers while this one is multiplied; each of 256 threads holds an
//     8 x 8 micro-tile of fp32 accumulators (explicit fmaf, so the library's
//     --fmad=false does not split them);
//   * the tile's epilogue masks the padded vocabulary columns, reduces each
//     row's max and sum of exp over the 16 threads that share it (warp
//     shuffles), picks the target logit in the tile that holds it, and folds
//     them into the row's running (max, sum, target) in shared memory;
//   * each block writes its partial (max, sum, target) per token; a second,
//     short launch merges the splits by log-sum-exp, one warp per token;
//   * bf16 inputs are upcast on load and every sum is fp32; `round_bf16`
//     rounds fp32 inputs to bf16 on load (precision="bf16" without copying
//     the table).
// WGMMA/TMA tensor-core tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileT = 128;  // tokens per block
constexpr int kTileV = 128;  // vocabulary columns per inner tile
constexpr int kTileD = 16;   // depth chunk staged in shared memory
constexpr int kThreads = 256;
constexpr int kPad = 4;      // keeps the float4 reads aligned
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive elements [c, c + 4) of a row as fp32 (zeros past the end
// of the row, or for a row that does not exist). `vec`: d % 4 == 0 and the
// rows aligned, so one 16-byte (fp32) or 8-byte (bf16) load.
__device__ __forceinline__ void load4(const float* row, int c, int d, bool vec, float* o) {
  if (row != nullptr && vec && c < d) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = (row != nullptr && c + e < d) ? row[c + e] : 0.0f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* row, int c, int d, bool vec, float* o) {
  if (row != nullptr && vec && c < d) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    o[0] = __low2float(lo); o[1] = __high2float(lo);
    o[2] = __low2float(hi); o[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = (row != nullptr && c + e < d) ? __bfloat162float(row[c + e]) : 0.0f;
}

// Thread (ty, tx) of the 16 x 16 layout owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4: a quarter warp's float4
// reads of one shared-memory row then cover 128 contiguous bytes.
__device__ __forceinline__ int micro(int base, int i) {
  return (i < 4) ? base * 4 + i : 64 + base * 4 + (i - 4);
}

template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_partial_kernel(const TH* __restrict__ h, const TW* __restrict__ table,
                        const int32_t* __restrict__ targets,
                        const int32_t* __restrict__ idx, long long tab_stride,
                        float* __restrict__ part, int t_len, int d, int v,
                        int tiles_per_split, int n_split, int round_bf16, int vec) {
  __shared__ __align__(16) float sh[kTileD][kTileT + kPad];
  __shared__ __align__(16) float sw[kTileD][kTileV + kPad];
  __shared__ float s_max[kTileT], s_sum[kTileT], s_tgt[kTileT];
  __shared__ int s_target[kTileT];

  const int split = blockIdx.x;
  const int t0 = blockIdx.y * kTileT;
  const int k = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const bool is_vec = vec != 0;
  const TW* tab = table + (size_t)k * (size_t)tab_stride;

  // this block's tokens: running state and targets
  for (int r = tid; r < kTileT; r += kThreads) {
    s_max[r] = kNeg;
    s_sum[r] = 0.0f;
    s_tgt[r] = 0.0f;
    const int t = t0 + r;
    int target = -1;
    if (t < t_len) {
      const size_t slot = (size_t)k * t_len + t;
      target = targets[idx ? (size_t)idx[slot] : slot];
    }
    s_target[r] = target;
  }

  // the two quads of h and of W this thread loads per chunk: row q >> 2,
  // columns 4 (q & 3) .. +3 of the chunk, q = tid and tid + 256
  const TH* hrow[2];
  int lrow[2], lcol[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int q = tid + p * kThreads;
    lrow[p] = q >> 2;
    lcol[p] = (q & 3) * 4;
    const int t = t0 + lrow[p];
    hrow[p] = nullptr;
    if (t < t_len) {
      const size_t slot = (size_t)k * t_len + t;
      const size_t src = idx ? (size_t)idx[slot] : slot;
      hrow[p] = h + src * (size_t)d;
    }
  }

  const int n_vtiles = (v + kTileV - 1) / kTileV;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_vtiles);
  const int n_chunks = (d + kTileD - 1) / kTileD;

  for (int vt = tile_begin; vt < tile_end; ++vt) {
    const int v0 = vt * kTileV;
    const TW* wrow[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int vv = v0 + lrow[p];
      wrow[p] = vv < v ? tab + (size_t)vv * (size_t)d : nullptr;
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float ph[2][4], pw[2][4];
    auto fetch = [&](int c0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        load4(hrow[p], c0 + lcol[p], d, is_vec, ph[p]);
        load4(wrow[p], c0 + lcol[p], d, is_vec, pw[p]);
        if (round_bf16) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ph[p][e] = bf16_round(ph[p][e]);
            pw[p][e] = bf16_round(pw[p][e]);
          }
        }
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sh[lcol[p] + e][lrow[p]] = ph[p][e];
          sw[lcol[p] + e][lrow[p]] = pw[p][e];
        }
    };

    fetch(0);
    stage();
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) fetch((c + 1) * kTileD);
#pragma unroll
      for (int kk = 0; kk < kTileD; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&sh[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sh[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sw[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&sw[kk][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
      if (c + 1 < n_chunks) {
        stage();
        __syncthreads();
      }
    }

    // epilogue: fold this tile's 128 columns into each row's running state
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = micro(ty, i);
      const int local_target = s_target[r] - v0;
      float mx = kNeg, pick = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = micro(tx, j);
        if (v0 + col >= v) acc[i][j] = kNeg;  // padded vocabulary column
        mx = fmaxf(mx, acc[i][j]);
        if (col == local_target) pick = acc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(acc[i][j] - mx);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        pick += __shfl_xor_sync(0xffffffffu, pick, off);
      }
      if (tx == 0) {
        const float m_old = s_max[r];
        const float m_new = fmaxf(m_old, mx);
        s_sum[r] = s_sum[r] * expf(m_old - m_new) + sum * expf(mx - m_new);
        s_max[r] = m_new;
        s_tgt[r] += pick;
      }
    }
  }
  __syncthreads();

  // partials, laid out [K][T][n_split] x {max, sum, target}
  const size_t plane = (size_t)gridDim.z * t_len * n_split;
  for (int r = tid; r < kTileT; r += kThreads) {
    const int t = t0 + r;
    if (t >= t_len) continue;
    const size_t o = ((size_t)k * t_len + t) * n_split + split;
    part[o] = s_max[r];
    part[plane + o] = s_sum[r];
    part[2 * plane + o] = s_tgt[r];
  }
}

// One warp per (chain, token): log-sum-exp over the vocabulary splits.
__global__ void __launch_bounds__(kThreads)
fused_ce_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int rows, int n_split) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const size_t plane = (size_t)rows * n_split;
  const float* pm = part + (size_t)warp * n_split;
  float m = kNeg, s = 0.0f, tgt = 0.0f;
  for (int i = lane; i < n_split; i += 32) {
    const float mi = pm[i], si = pm[plane + i];
    const float mn = fmaxf(m, mi);
    s = s * expf(m - mn) + si * expf(mi - mn);
    m = mn;
    tgt += pm[2 * plane + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    tgt += __shfl_xor_sync(0xffffffffu, tgt, off);
    const float mn = fmaxf(m, mo);
    s = s * expf(m - mn) + so * expf(mo - mn);
    m = mn;
  }
  if (lane == 0) out[warp] = tgt - (logf(s) + m);
}

template <typename TH, typename TW>
cudaError_t launch_partial(const void* h, const void* table, const int32_t* targets,
                           const int32_t* idx, long long tab_stride, float* part, int k,
                           int t, int d, int v, int tiles_per_split, int n_split,
                           int round_bf16, int vec, cudaStream_t s) {
  const dim3 grid(n_split, (t + kTileT - 1) / kTileT, k);
  fused_ce_partial_kernel<TH, TW><<<grid, kThreads, 0, s>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(table), targets, idx, tab_stride,
      part, t, d, v, tiles_per_split, n_split, round_bf16, vec);
  return cudaGetLastError();
}

}  // namespace

// h: (K, T, D) rows, or the (N, D) pool when idx (K, T) is given; targets:
// (K, T), or the (N,) pool with idx; table: (V, D) shared (tab_stride = 0) or
// (K, V, D) (tab_stride = V D); part: 3 K T n_split fp32 scratch; out: (K, T)
// fp32. h_bf16 / tab_bf16 select the element types; vec = 1 only when d % 4
// == 0 and every row is 16-byte (fp32) or 8-byte (bf16) aligned. Launches the
// partial kernel and the merge; returns the first launch error.
extern "C" int fused_ce_launch(const void* h, int h_bf16, const void* table, int tab_bf16,
                               const int32_t* targets, const int32_t* idx,
                               long long tab_stride, float* part, float* out, int k, int t,
                               int d, int v, int tiles_per_split, int n_split,
                               int round_bf16, int vec, void* stream) {
  if (k <= 0 || t <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (h_bf16 && tab_bf16)
    err = launch_partial<__nv_bfloat16, __nv_bfloat16>(h, table, targets, idx, tab_stride, part,
                                                       k, t, d, v, tiles_per_split, n_split,
                                                       round_bf16, vec, s);
  else if (h_bf16)
    err = launch_partial<__nv_bfloat16, float>(h, table, targets, idx, tab_stride, part, k, t,
                                               d, v, tiles_per_split, n_split, round_bf16,
                                               vec, s);
  else if (tab_bf16)
    err = launch_partial<float, __nv_bfloat16>(h, table, targets, idx, tab_stride, part, k, t,
                                               d, v, tiles_per_split, n_split, round_bf16,
                                               vec, s);
  else
    err = launch_partial<float, float>(h, table, targets, idx, tab_stride, part, k, t, d, v,
                                       tiles_per_split, n_split, round_bf16, vec, s);
  if (err != cudaSuccess) return (int)err;
  const int rows = k * t;
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  fused_ce_merge_kernel<<<blocks, kThreads, 0, s>>>(part, out, rows, n_split);
  return (int)cudaGetLastError();
}
