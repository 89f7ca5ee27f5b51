// Logit pair delta for Hopper (sm_90a): l = log sig(y x.w') - log sig(y x.w).
//
// Replaces two Pallas TPU kernels with one body:
//   src/repro/kernels/batched_loglik.py  batched_logit_delta (K chains, (K, m))
//   src/repro/kernels/logit_loglik.py    logit_delta         (one chain, K = 1)
// plus the gather XLA fuses in front of the first (batched_loglik.py:135,
// gather_and_delta). Rows are addressed in one of two forms:
//   * gathered: a row-index pointer `idx` (K, m) into a shared (N, D) pool;
//     the kernel reads each chain's rows in place, so no (K, m, D) slab is
//     written and read back every round (the sequential test's rounds);
//   * contiguous: row first + k m + r of x, no index read at all. This is
//     the pre-gathered (K, m, D) slab (first = 0) and the exact transition's
//     full pass over a run of the pool (K = 1, first = the run's first row).
//
// What bounds it. Per row it reads D values of x (4 or 2 bytes each), one
// label and, in the gathered form, one index, and does 4 D flops: about 0.5
// flop per byte, far below the card's fp32 balance point (~20 flop/byte),
// so the floor is the bytes over 3.35 TB/s (HBM3 on the H100 SXM). At the
// rounds' shapes (K = 32, m = 100, D = 50: ~0.7 MB) that floor is 0.2 us and
// the real limit is latency: the launch (~1.9 us) plus the chain of memory
// round trips each row needs (its index, then its x row and label). At the
// full pass (N = 1e6) it is the bytes, and then the bytes in flight per SM
// decide how close it comes.
//
// Design against that:
//   * one round trip for the indices, one for the rows: a lane group loads
//     its R rows' indices first (side by side, one load each), then issues
//     every x-vector load of those R rows, and the labels of the rows the
//     lane will hold, before it consumes any, so R rows are in flight at
//     once instead of one after another;
//   * L lanes per row, the smallest power of two with L v >= D (at most 32),
//     where v is the widest vector (16, 8 or 4 bytes) that divides both the
//     row stride and the base address; 32 / L rows side by side in a warp.
//     D = 50 fp32 rows are 200 B: float2, 25 of 32 lanes load. D = 2 (Fig. 5)
//     is one row per thread. bf16 rows of 100 B take bf16x2 words, and rows
//     with an odd number of bf16 values scalar loads;
//   * each lane reads its slice of w and w' straight into registers through
//     the read-only path: no shared staging and no __syncthreads in front of
//     the first x load;
//   * a __shfl_xor_sync tree over a row's L lanes only, which scatters the
//     rows as it reduces: at each step a lane keeps half of its rows and
//     receives its partner's sums of that half, so a warp's R rows cost
//     ~2R + 2 log2(L) shuffles, not 2 R log2(L), and each lane ends with rows
//     of its own, whose softplus it alone computes;
//   * precision bf16 rounds w, w' (and fp32 x) to bf16 in registers
//     (__float2bfloat16_rn), so a bf16 call is this one launch;
//   * the contiguous form reads no index, and a long pass carries more rows
//     per warp (by_rows), so a full pass keeps more bytes in flight;
//   * blockIdx.y is the chain; a block is kWarps warps; the grid covers the
//     K m rows, so K = 32, m = 100 gives 800 warps over the 132 SMs.
//
// Launch parameter. `warps`, the warps of a block (1, 2, 4 or 8), may be
// overridden per call. It only decides which block a warp's rows fall in: a
// warp's rows, a lane's columns and the butterfly are the same whatever the
// block, so every choice gives the default's bits.
// repro_torch.kernels.autotune races it. This library is the default launch
// (kW = kWarps warps a block, compiled in); logit_delta_warps.cu includes
// this file with PAIR_DELTA_ANY_WARPS defined to build the same kernels with
// the block's size read at run time (kW = 0) behind the entry point
// logit_pair_delta_warps. Two sources, so nvcc builds the two in parallel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // warps a block unless the call overrides it
constexpr int kMaxWarps = 8;  // the most a call may ask for
#ifdef PAIR_DELTA_ANY_WARPS
constexpr int kW = 0;  // warps a block: blockDim.x / 32, the call's
#define PAIR_DELTA_ENTRY logit_pair_delta_warps
#else
constexpr int kW = kWarps;
#define PAIR_DELTA_ENTRY logit_pair_delta
#endif
constexpr long long kLongPass = 1 << 16;  // rows from which a contiguous pass is long
constexpr unsigned kFull = 0xffffffffu;

// log(1 + exp(a)) as max(a, 0) + log1p(exp(-|a|)), the form of logaddexp(0, a).
__device__ __forceinline__ float softplus(float a) {
  return fmaxf(a, 0.0f) + log1pf(expf(-fabsf(a)));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VB bytes of x at p (aligned to VB) as VB / sizeof(element) floats; a bf16
// value is the high half of its float.
template <bool BF16, int VB>
__device__ __forceinline__ void load_x(const char* p, float* v) {
  if constexpr (VB == 2) {
    v[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  } else {
    uint32_t w[VB / 4];
    if constexpr (VB == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (VB == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x;
      w[1] = t.y;
    } else {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x;
      w[1] = t.y;
      w[2] = t.z;
      w[3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (BF16) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        v[i] = __uint_as_float(w[i]);
      }
    }
  }
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// BF16: x holds bf16; VB: bytes a lane loads at a time; L: lanes per row;
// R: rows per lane group.
template <bool BF16, int VB, int L, int R>
__global__ void __launch_bounds__(32 * (kW ? kW : kMaxWarps))
pair_delta_kernel(const char* __restrict__ x, const float* __restrict__ y,
                  const int32_t* __restrict__ idx, const float* __restrict__ w_cur,
                  const float* __restrict__ w_prop, float* __restrict__ out, int m, int d,
                  long long first, int round_bf16) {
  constexpr int ES = BF16 ? 2 : 4;
  constexpr int VE = VB / ES;  // values per load
  constexpr int G = 32 / L;    // rows side by side in a warp
  // the reduction halves the rows a lane holds at each of its first S steps
  // (a reduce-scatter), so a lane ends with HELD rows of its own
  constexpr int LOG_L = ilog2(L);
  constexpr int S = LOG_L < ilog2(R) ? LOG_L : ilog2(R);
  constexpr int HELD = R >> S;
  const int k = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane / L, q = lane % L;
  const int warps = kW ? kW : (int)(blockDim.x >> 5);
  const int row0 = (blockIdx.x * warps + (threadIdx.x >> 5)) * (G * R);
  if (row0 >= m) return;  // the whole warp lies past the end
  const size_t row_bytes = (size_t)d * ES;
  const size_t chain = (size_t)k * m;

  // 1. the sources of the R rows and of the HELD rows this lane ends with:
  //    indices side by side, one load per row
  auto source = [&](int r) -> long long {
    return idx ? (long long)__ldg(idx + chain + r) : first + (long long)(chain + r);
  };
  long long src[R];
  bool ok[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = row0 + j * G + g;
    ok[j] = r < m;
    src[j] = ok[j] ? source(r) : 0;
  }
  int hbase = 0;  // the first of the held rows: the split steps' bits of q
#pragma unroll
  for (int t = 0; t < S; ++t)
    if (q & (L >> (t + 1))) hbase += R >> (t + 1);
  int hrow[HELD];
  float yv[HELD];
#pragma unroll
  for (int h = 0; h < HELD; ++h) {
    hrow[h] = row0 + (hbase + h) * G + g;
    yv[h] = hrow[h] < m ? __ldg(y + source(hrow[h])) : 0.0f;
  }
  // 2. every x vector of the R rows before any is consumed
  const float* wc = w_cur + (size_t)k * d;
  const float* wp = w_prop + (size_t)k * d;
  float zc[R], zp[R];
#pragma unroll
  for (int j = 0; j < R; ++j) zc[j] = zp[j] = 0.0f;
  const int nchunk = (d + L * VE - 1) / (L * VE);
  for (int c = 0; c < nchunk; ++c) {
    const int col = (c * L + q) * VE;
    const bool cok = col < d;  // VE divides D: a vector is all in or all out
    float xv[R][VE];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (ok[j] && cok) {
        load_x<BF16, VB>(x + src[j] * row_bytes + (size_t)col * ES, xv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) xv[j][e] = 0.0f;
      }
    }
    float a[VE], b[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      a[e] = cok ? __ldg(wc + col + e) : 0.0f;
      b[e] = cok ? __ldg(wp + col + e) : 0.0f;
      if (round_bf16) {
        a[e] = bf16_round(a[e]);
        b[e] = bf16_round(b[e]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float xe = (!BF16 && round_bf16) ? bf16_round(xv[j][e]) : xv[j][e];
        zc[j] += xe * a[e];
        zp[j] += xe * b[e];
      }
    }
  }
  // 3. a row's L lanes reduce: at each of the first S steps a lane keeps half
  //    of its rows and receives its partner's sums of that half; the later
  //    steps add the one row both hold
#pragma unroll
  for (int t = 0; t < LOG_L; ++t) {
    const int o = L >> (t + 1);
    if (t < S) {
      const int half = R >> (t + 1);
      const bool hi = (q & o) != 0;
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        if (i < half) {
          const float sc = hi ? zc[i] : zc[i + half], kc = hi ? zc[i + half] : zc[i];
          const float sp = hi ? zp[i] : zp[i + half], kp = hi ? zp[i + half] : zp[i];
          zc[i] = kc + __shfl_xor_sync(kFull, sc, o);
          zp[i] = kp + __shfl_xor_sync(kFull, sp, o);
        }
      }
    } else {
      zc[0] += __shfl_xor_sync(kFull, zc[0], o);
      zp[0] += __shfl_xor_sync(kFull, zp[0], o);
    }
  }
  // 4. one lane of those holding a row stores it
  if ((q & ((L >> S) - 1)) == 0) {
#pragma unroll
    for (int h = 0; h < HELD; ++h)
      if (hrow[h] < m) out[chain + hrow[h]] = softplus(-yv[h] * zc[h]) - softplus(-yv[h] * zp[h]);
  }
}

struct Args {
  const char* x;
  const float* y;
  const int32_t* idx;
  const float* w_cur;
  const float* w_prop;
  float* out;
  int k, m, d;
  long long first;
  int round_bf16;
  int warps;  // warps a block
  cudaStream_t stream;
};

template <bool BF16, int VB, int L, int R>
int launch(const Args& a) {
  const int rows_per_block = a.warps * (32 / L) * R;
  const dim3 grid((a.m + rows_per_block - 1) / rows_per_block, a.k);
  pair_delta_kernel<BF16, VB, L, R><<<grid, 32 * a.warps, 0, a.stream>>>(
      a.x, a.y, a.idx, a.w_cur, a.w_prop, a.out, a.m, a.d, a.first, a.round_bf16);
  return (int)cudaGetLastError();
}

// Rows per lane group. A long contiguous pass keeps more rows in flight per
// warp: 8 where a row takes 16 or 32 lanes, 4 where rows sit side by side (on
// an H100 SXM, D = 50 at N = 1e6 ran in 96 us at 8 rows, 111 at 4 and 92 at 16,
// where bf16 rows lost occupancy; D = 2 ran best at 4). Otherwise a warp takes
// at least 4 rows (R = 4 at 32 lanes a row, 2 at 16, 1 where 4 or more rows
// sit side by side), so small rounds spread over many warps.
template <bool BF16, int VB, int L>
int by_rows(const Args& a) {
  if (!a.idx && (long long)a.k * a.m >= kLongPass)
    return launch<BF16, VB, L, (L >= 16 ? 8 : 4)>(a);
  return launch<BF16, VB, L, (L == 32 ? 4 : L == 16 ? 2 : 1)>(a);
}

template <bool BF16, int VB>
int by_lanes(const Args& a, int lanes) {
  switch (lanes) {
    case 1: return by_rows<BF16, VB, 1>(a);
    case 2: return by_rows<BF16, VB, 2>(a);
    case 4: return by_rows<BF16, VB, 4>(a);
    case 8: return by_rows<BF16, VB, 8>(a);
    case 16: return by_rows<BF16, VB, 16>(a);
    default: return by_rows<BF16, VB, 32>(a);
  }
}

}  // namespace

// x: the (N, D) pool (gathered form, or contiguous from row `first`) or the
// (K, m, D) slab (contiguous, first = 0); y: (N,) or (K, m) beside it;
// idx: (K, m) int32 rows of the pool, or null for the contiguous form;
// w_cur, w_prop: (K, D) fp32; out: (K, m) fp32. x_bf16 selects the element
// type of x; round_bf16 rounds w, w' and fp32 x to bf16 as they are loaded.
// logit_pair_delta launches kWarps warps a block; logit_pair_delta_warps
// takes them as a trailing argument `warps` (1, 2, 4 or 8).
extern "C" int PAIR_DELTA_ENTRY(const void* x, int x_bf16, const float* y,
                                const int32_t* idx, const float* w_cur,
                                const float* w_prop, float* out, int k, int m,
                                int d, long long first, int round_bf16, void* stream
#ifdef PAIR_DELTA_ANY_WARPS
                                , int warps
#endif
) {
#ifndef PAIR_DELTA_ANY_WARPS
  const int warps = kWarps;
#endif
  if (k <= 0 || m <= 0) return (int)cudaSuccess;
  if (warps != 1 && warps != 2 && warps != 4 && warps != kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const char*>(x), y, idx, w_cur, w_prop, out, k, m, d, first,
               round_bf16, warps, static_cast<cudaStream_t>(stream)};
  const size_t es = x_bf16 ? 2 : 4;
  const size_t row_bytes = (size_t)d * es;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  size_t vb = es;
  for (size_t cand = 16; cand >= 4; cand /= 2)
    if (row_bytes % cand == 0 && base % cand == 0) {
      vb = cand;
      break;
    }
  const int ve = (int)(vb / es);
  int lanes = 1;
  while (lanes < 32 && lanes * ve < d) lanes *= 2;
  if (x_bf16) {
    switch (vb) {
      case 16: return by_lanes<true, 16>(a, lanes);
      case 8: return by_lanes<true, 8>(a, lanes);
      case 4: return by_lanes<true, 4>(a, lanes);
      default: return by_lanes<true, 2>(a, lanes);
    }
  }
  switch (vb) {
    case 16: return by_lanes<false, 16>(a, lanes);
    case 8: return by_lanes<false, 8>(a, lanes);
    default: return by_lanes<false, 4>(a, lanes);
  }
}
