// Per-token LM log-likelihood for Hopper (sm_90a), on the tensor cores:
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
// What bounds it: the table's bytes. Per chain a call reads the (V, D) table
// once (1.07 GB in fp32 at V = 65024, D = 4096: 0.32 ms at 3.35 TB/s) and
// does 2 T V D products per bf16 pass (53 GFLOP at T = 100); on the tensor
// cores three passes take 0.16 ms at 989 TFLOP/s, under the table's read.
// (K chains on one shared table read it once per chain here, unless L2
// serves the later chains: their blocks run side by side on the same rows.)
//
// fp32 logits from bf16 tensor cores: an fp32 value splits exactly into
// three bf16 terms, hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi -
// mid), and a product of two bf16 values is exact in fp32. The kernel sums
// every cross term of weight 2^-24 or above into one fp32 accumulator:
// bf16 h x fp32 table (the path) is 3 products (h x hi, h x mid, h x lo),
// fp32 x fp32 is 6, bf16 x bf16 is 1; `round_bf16` keeps the hi terms only
// (precision="bf16" without a bf16 copy of the table). The table is split as
// it arrives (it is theta', new every transition, so a pre-split copy would
// cost a pass over it).
//
// Design:
//   * grid (vocab split, token tile, chain); a block is one producer
//     warpgroup and two consumer warpgroups (384 threads). The vocabulary is
//     split across blocks so that K = 1 still fills every SM; each block
//     walks a run of 128-row vocabulary tiles and D in chunks of 64;
//   * tokens lie on wgmma's N axis, 104 of them (m = 100 pads by 4%), vocab
//     rows on M: each consumer warpgroup owns 64 rows of the tile and one
//     m64n104 fp32 accumulator (52 registers a thread);
//   * the producer fills a ring of shared-memory stages (4, or 3 where fp32
//     h needs three bf16 copies) under mbarriers: the table chunk (128 rows x
//     64 columns) by TMA (`cp.async.bulk.tensor`, a 3-D map over (K, V, D),
//     so the zero fill past the vocabulary's end never reads the next
//     chain's rows; 128-byte swizzle); the h rows (through `idx`) by
//     `cp.async` into wgmma's 128-byte-swizzled K-major B layout, each
//     thread's copies arriving on the stage's barrier by themselves
//     (`cp.async.mbarrier.arrive.noinc`), so the producer never waits on a
//     copy. A table whose rows are not 16-byte aligned cannot have a map,
//     and fp32 h has to be split: those go through plain loads into the
//     same layouts, and the same consumer body reads them;
//   * a consumer reads its fp32 (or bf16) table fragment from shared memory,
//     splits it into bf16 A-fragment registers and issues the products with
//     `wgmma.mma_async` (A from registers, B = h from shared memory);
//   * after the last D chunk of a tile, the epilogue masks the padded
//     vocabulary rows and reduces each token's (max, sum of exp, target
//     logit) down the tile's rows: within the thread, across lanes by
//     shuffles, across the eight warps through shared memory, and folds it
//     into the token's running state;
//   * each block writes its partial (max, sum, target) per token; a second,
//     short launch merges the splits by log-sum-exp, one warp per token.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileT = 104;     // tokens per block: wgmma's N
constexpr int kTileV = 128;     // vocabulary rows per tile: two m64 warpgroups
constexpr int kChunk = 64;      // D per stage
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kRow = 128;       // bytes of one swizzled shared-memory row
constexpr int kHBytes = kTileT * kRow;  // one bf16 term of a stage's h rows
constexpr int kAcc = kTileT / 2;        // accumulator registers a thread
constexpr float kNeg = -1e30f;

// byte offset of 16-byte chunk `ch` of row `r` in a tile of 128-byte rows
// under the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's
// layout type 1), the tile based at a multiple of 1024 bytes
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * kRow + (((ch ^ r) & 7) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the exact bf16 terms of two fp32 values: t[0] = hi, t[1] = mid, t[2] = lo,
// each packed as a pair (a low, b high); N terms
template <int N>
__device__ __forceinline__ void split2(float a, float b, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    __nv_bfloat162 p;
    p.x = ha;
    p.y = hb;
    t[i] = *reinterpret_cast<const uint32_t*>(&p);
    a -= __bfloat162float(ha);
    b -= __bfloat162float(hb);
  }
}

// --- mbarriers ---
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// --- copies ---
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// 16 bytes, or zeros where src_bytes == 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
// (.noinc: the arrival is one of the barrier's expected ones)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// shared-memory writes of the generic proxy, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ---
// B descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void pin(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 104] += A[64 x 16] (bf16, registers) . B[104 x 16]^T (bf16, shared)
__device__ __forceinline__ void wgmma_m64n104k16(float (&d)[52], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// Shared memory of one block: a ring of stages, each the table chunk
// (kTileV rows x kChunk columns in boxes of 128-byte rows: two boxes of 32
// fp32 columns, or one of 64 bf16) and NB bf16 terms of the h rows (kTileT
// rows x kChunk columns); then the epilogue's per-warp partials, the
// tokens' targets and h row offsets, and the barriers.
template <typename TW, int NB>
struct Layout {
  static constexpr int kTabBytes = kTileV * kChunk * (int)sizeof(TW);
  static constexpr int kStage = kTabBytes + NB * kHBytes;
  static constexpr int kStages = 4 * kStage <= 200 * 1024 ? 4 : 3;
  static constexpr int kRed = 3 * 8 * kTileT * 4;
  static constexpr int kBytes =
      1024 + kStages * kStage + kRed + kTileT * 4 + kTileT * 8 + 2 * kStages * 8;
};

// The table chunk by plain loads, for a table TMA cannot map: the same
// swizzled boxes TMA would write, zeros past the table's edges.
template <typename TW>
__device__ __forceinline__ void load_table_plain(uint8_t* st, const TW* tab, int v0, int c0,
                                                 int v, int d, int ptid) {
  constexpr int kPer = 16 / (int)sizeof(TW);  // elements of a 16-byte chunk
  constexpr int kPerRow = kChunk / kPer;      // chunks of a row
  for (int q = ptid; q < kTileV * kPerRow; q += 128) {
    const int r = q / kPerRow, ch = q % kPerRow;
    const int row = v0 + r, col = c0 + ch * kPer;
    alignas(16) TW vals[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      vals[e] = (row < v && col + e < d) ? tab[(size_t)row * d + col + e] : zero_of<TW>();
    *reinterpret_cast<uint4*>(st + (ch / 8) * kTileV * kRow + swz(r, ch % 8)) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// The h rows of a stage by plain loads, split into NB bf16 terms in wgmma's
// B layout (fp32 h, or bf16 rows cp.async cannot copy); zeros for padded
// tokens and past D.
template <typename TH, int NB>
__device__ __forceinline__ void load_h_plain(uint8_t* hs, const TH* h, const long long* s_hoff,
                                             int c0, int d, int ptid) {
  for (int q = ptid; q < kTileT * 8; q += 128) {
    const int r = q >> 3, ch = q & 7;
    const long long off = s_hoff[r];
    const int col = c0 + ch * 8;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = (off >= 0 && col + e < d) ? to_f32(h[off + col + e]) : 0.0f;
    uint32_t t[4][NB];
#pragma unroll
    for (int p = 0; p < 4; ++p) split2<NB>(x[2 * p], x[2 * p + 1], t[p]);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      *reinterpret_cast<uint4*>(hs + i * kHBytes + swz(r, ch)) =
          make_uint4(t[0][i], t[1][i], t[2][i], t[3][i]);
  }
}

// A fragments of k16 step kk for rows r and r + 8 of the tile (wgmma's
// register layout: a thread holds columns 2q, 2q + 1 and 2q + 8, 2q + 9 of
// its two rows), split into NA bf16 terms: a[term][kk][register].
template <int NA>
__device__ __forceinline__ void load_a(const uint8_t* st, int r, int kk, int tq,
                                       uint32_t (&a)[NA][4][4], float) {
  const uint8_t* box = st + (kk >> 1) * kTileV * kRow;
  const int ch = (kk & 1) * 4 + (tq >> 1), bo = (tq & 1) * 8;
  const float2 x0 = *reinterpret_cast<const float2*>(box + swz(r, ch) + bo);
  const float2 x1 = *reinterpret_cast<const float2*>(box + swz(r + 8, ch) + bo);
  const float2 x2 = *reinterpret_cast<const float2*>(box + swz(r, ch + 2) + bo);
  const float2 x3 = *reinterpret_cast<const float2*>(box + swz(r + 8, ch + 2) + bo);
  uint32_t t[4][NA];
  split2<NA>(x0.x, x0.y, t[0]);
  split2<NA>(x1.x, x1.y, t[1]);
  split2<NA>(x2.x, x2.y, t[2]);
  split2<NA>(x3.x, x3.y, t[3]);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][kk][j] = t[j][i];
}

template <int NA>
__device__ __forceinline__ void load_a(const uint8_t* st, int r, int kk, int tq,
                                       uint32_t (&a)[NA][4][4], __nv_bfloat16) {
  const int ch = 2 * kk, bo = tq * 4;  // columns 16 kk + 2 tq: bytes 32 kk + 4 tq
  a[0][kk][0] = *reinterpret_cast<const uint32_t*>(st + swz(r, ch) + bo);
  a[0][kk][1] = *reinterpret_cast<const uint32_t*>(st + swz(r + 8, ch) + bo);
  a[0][kk][2] = *reinterpret_cast<const uint32_t*>(st + swz(r, ch + 1) + bo);
  a[0][kk][3] = *reinterpret_cast<const uint32_t*>(st + swz(r + 8, ch + 1) + bo);
}

// NA, NB: bf16 terms of a table value and of an h value (1 or 3).
template <typename TW, typename TH, int NA, int NB>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_partial_kernel(const __grid_constant__ CUtensorMap tmap, const TH* __restrict__ h,
                        const TW* __restrict__ table, const int32_t* __restrict__ targets,
                        const int32_t* __restrict__ idx, long long tab_stride,
                        float* __restrict__ part, int t_len, int d, int v,
                        int tiles_per_split, int n_split, int use_tma, int h_async) {
  using L = Layout<TW, NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(smem + L::kStages * L::kStage);  // [3][8][kTileT]
  int* s_target = reinterpret_cast<int*>(red + 3 * 8 * kTileT);
  long long* s_hoff = reinterpret_cast<long long*>(s_target + kTileT);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_hoff + kTileT);
  uint64_t* empty = full + L::kStages;

  const int split = blockIdx.x;
  const int t0 = blockIdx.y * kTileT;
  const int k = blockIdx.z;
  const int tid = threadIdx.x;

  // this block's tokens: targets and the offsets of their h rows (-1: padding)
  for (int r = tid; r < kTileT; r += kThreads) {
    const int t = t0 + r;
    int target = -1;
    long long off = -1;
    if (t < t_len) {
      const size_t slot = (size_t)k * t_len + t;
      const size_t src = idx ? (size_t)idx[slot] : slot;
      target = targets[src];
      off = (long long)src * d;
    }
    s_target[r] = target;
    s_hoff[r] = off;
  }
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      // full: one arrival from each producer thread (plus the TMA byte count)
      mbar_init(&full[s], 128 + (use_tma ? 1 : 0));
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_vtiles = (v + kTileV - 1) / kTileV;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_vtiles);
  const int n_chunks = (d + kChunk - 1) / kChunk;
  const int n_iter = max(0, tile_end - tile_begin) * n_chunks;

  if (tid < 128) {
    // ---- producer warpgroup: fills stage it % kStages for every (tile, chunk)
    const int chain = tab_stride ? k : 0;
    const TW* tab = table + (size_t)k * (size_t)tab_stride;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % L::kStages;
      const int v0 = (tile_begin + it / n_chunks) * kTileV;
      const int c0 = (it % n_chunks) * kChunk;
      uint8_t* st = smem + s * L::kStage;
      uint8_t* hs = st + L::kTabBytes;
      mbar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
      if (use_tma) {
        if (tid == 0) {
          constexpr int kBox = kRow / (int)sizeof(TW);  // columns of one box
          mbar_arrive_expect_tx(&full[s], L::kTabBytes);
#pragma unroll
          for (int b = 0; b < kChunk / kBox; ++b)
            tma_load_3d(st + b * kTileV * kRow, &tmap, &full[s], c0 + b * kBox, v0, chain);
        }
      } else {
        load_table_plain<TW>(st, tab, v0, c0, v, d, tid);
      }
      // the h rows; each producer thread arrives on full[s] once its part
      // of the stage is written: by cp.async's own arrival when it copies
      // (no waiting here), else after its plain stores
      bool async_arrival = false;
      if constexpr (sizeof(TH) == 2 && NB == 1) {
        if (h_async) {
          for (int q = tid; q < kTileT * 8; q += 128) {
            const int r = q >> 3, ch = q & 7;
            const long long off = s_hoff[r];
            const int col = c0 + ch * 8;
            const bool ok = off >= 0 && col < d;
            cp_async16(smem_u32(hs) + swz(r, ch), ok ? static_cast<const void*>(h + off + col) : h,
                       ok ? 16 : 0);
          }
          if (use_tma) {
            cp_async_arrive(&full[s]);
            async_arrival = true;
          } else {
            cp_async_wait_all();  // the plain table stores arrive with these
          }
        } else {
          load_h_plain<TH, NB>(hs, h, s_hoff, c0, d, tid);
        }
      } else {
        load_h_plain<TH, NB>(hs, h, s_hoff, c0, d, tid);
      }
      if (!async_arrival) {
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warpgroups: warpgroup wg owns tile rows [64 wg, 64 wg + 64)
  const int ct = tid - 128;
  const int wg = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, tq = lane & 3;
  const int wslot = ct >> 5;                          // 0..7: warp among the consumers
  const int row0 = wg * 64 + (wslot & 3) * 16 + g;    // this thread's rows: row0, row0 + 8
  float m_run = kNeg, s_run = 0.0f, p_run = 0.0f;     // token ct's running state
  float acc[kAcc];
  int it = 0;
  for (int vt = tile_begin; vt < tile_end; ++vt) {
    const int v0 = vt * kTileV;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int s = it % L::kStages;
      const uint8_t* st = smem + s * L::kStage;
      mbar_wait(&full[s], (it / L::kStages) & 1);
      fence_proxy_async();  // h rows written by cp.async, read by wgmma
      __syncwarp();
      uint32_t a[NA][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_a<NA>(st, row0, kk, tq, a, TW());
      const uint32_t hb = smem_u32(st + L::kTabBytes);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int ia = 0; ia < NA; ++ia)
#pragma unroll
          for (int ib = 0; ib < NB; ++ib)
            if (ia + ib <= 2)  // cross terms of weight 2^-24 and above
              wgmma_m64n104k16(acc, a[ia][kk], desc_sw128(hb + ib * kHBytes + kk * 32));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: (max, sum of exp, target logit) of each token down the
    // tile's rows. acc[4 j + q] is (row0, token 8 j + 2 tq + q) and
    // acc[4 j + 2 + q] is (row0 + 8, the same token).
    const int vr0 = v0 + row0, vr1 = vr0 + 8;
    const bool ok0 = vr0 < v, ok1 = vr1 < v;
#pragma unroll
    for (int j = 0; j < kTileT / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * j + 2 * tq + q;
        const float x0 = ok0 ? acc[4 * j + q] : kNeg;  // padded vocabulary rows
        const float x1 = ok1 ? acc[4 * j + 2 + q] : kNeg;
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = expf(x0 - mx) + expf(x1 - mx);
        const int tg = s_target[col];
        float pick = (tg == vr0 ? x0 : 0.0f) + (tg == vr1 ? x1 : 0.0f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
          pick += __shfl_xor_sync(0xffffffffu, pick, off);
        }
        if (g == 0) {
          red[wslot * kTileT + col] = mx;
          red[(8 + wslot) * kTileT + col] = sum;
          red[(16 + wslot) * kTileT + col] = pick;
        }
      }
    }
    consumer_barrier();
    if (ct < kTileT) {
      float mt = kNeg;
#pragma unroll
      for (int w = 0; w < 8; ++w) mt = fmaxf(mt, red[w * kTileT + ct]);
      float st_sum = 0.0f, pt = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        st_sum += red[(8 + w) * kTileT + ct] * expf(red[w * kTileT + ct] - mt);
        pt += red[(16 + w) * kTileT + ct];
      }
      const float mn = fmaxf(m_run, mt);
      s_run = s_run * expf(m_run - mn) + st_sum * expf(mt - mn);
      m_run = mn;
      p_run += pt;
    }
    consumer_barrier();
  }

  // partials, laid out [K][T][n_split] x {max, sum, target}
  if (ct < kTileT && t0 + ct < t_len) {
    const size_t plane = (size_t)gridDim.z * t_len * n_split;
    const size_t o = ((size_t)k * t_len + t0 + ct) * n_split + split;
    part[o] = m_run;
    part[plane + o] = s_run;
    part[2 * plane + o] = p_run;
  }
}

// One warp per (chain, token): log-sum-exp over the vocabulary splits.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
fused_ce_merge_kernel(const float* __restrict__ part, float* __restrict__ out, int rows,
                      int n_split) {
  const int warp = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
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

// cuTensorMapEncodeTiled looked up at run time (cudaGetDriverEntryPoint),
// so the library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <typename TW, typename TH, int NA, int NB>
cudaError_t launch_partial(const void* h, const void* table, const int32_t* targets,
                           const int32_t* idx, long long tab_stride, float* part, int k, int t,
                           int d, int v, int tiles_per_split, int n_split, int use_tma,
                           int h_async, cudaStream_t s) {
  using L = Layout<TW, NB>;
  CUtensorMap map = {};
  if (use_tma) {
    // (K, V, D) innermost first; a shared table is one chain. Boxes of
    // 128-byte rows by kTileV rows, zeros past V and D.
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t es = sizeof(TW);
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)v, (cuuint64_t)(tab_stride ? k : 1)};
    const cuuint64_t strides[2] = {(cuuint64_t)d * es, (cuuint64_t)v * d * es};
    const cuuint32_t box[3] = {(cuuint32_t)(kRow / es), (cuuint32_t)kTileV, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        &map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
        const_cast<void*>(table), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  auto kern = fused_ce_partial_kernel<TW, TH, NA, NB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (t + kTileT - 1) / kTileT, k);
  kern<<<grid, kThreads, L::kBytes, s>>>(map, static_cast<const TH*>(h),
                                         static_cast<const TW*>(table), targets, idx, tab_stride,
                                         part, t, d, v, tiles_per_split, n_split, use_tma, h_async);
  return cudaGetLastError();
}

}  // namespace

// h: (K, T, D) rows, or the (N, D) pool when idx (K, T) is given; targets:
// (K, T), or the (N,) pool with idx; table: (V, D) shared (tab_stride = 0) or
// (K, V, D) (tab_stride = V D); part: 3 K T n_split fp32 scratch; out: (K, T)
// fp32. h_bf16 / tab_bf16 select the element types. use_tma = 1 only when
// the table's base is 16-byte aligned and a row is a multiple of 16 bytes;
// h_async = 1 only for bf16 h with 16-byte aligned rows (d % 8 == 0).
// Launches the partial kernel and the merge; returns the first error.
extern "C" int fused_ce_launch(const void* h, int h_bf16, const void* table, int tab_bf16,
                               const int32_t* targets, const int32_t* idx,
                               long long tab_stride, float* part, float* out, int k, int t,
                               int d, int v, int tiles_per_split, int n_split, int round_bf16,
                               int use_tma, int h_async, void* stream) {
  if (k <= 0 || t <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const auto args = [&](auto launch) {
    return launch(h, table, targets, idx, tab_stride, part, k, t, d, v, tiles_per_split, n_split,
                  use_tma, h_async, s);
  };
  cudaError_t err;
  if (tab_bf16 && h_bf16)
    err = args(launch_partial<bf16, bf16, 1, 1>);
  else if (tab_bf16)
    err = round_bf16 ? args(launch_partial<bf16, float, 1, 1>)
                     : args(launch_partial<bf16, float, 1, 3>);
  else if (h_bf16)
    err = round_bf16 ? args(launch_partial<float, bf16, 1, 1>)
                     : args(launch_partial<float, bf16, 3, 1>);
  else
    err = round_bf16 ? args(launch_partial<float, float, 1, 1>)
                     : args(launch_partial<float, float, 3, 3>);
  if (err != cudaSuccess) return (int)err;
  const int rows = k * t;
  const int blocks = (rows * 32 + kMergeThreads - 1) / kMergeThreads;
  fused_ce_merge_kernel<<<blocks, kMergeThreads, 0, s>>>(part, out, rows, n_split);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the partial kernel for a dtype pair (bytes).
extern "C" int fused_ce_smem_bytes(int h_bf16, int tab_bf16, int round_bf16) {
  const bool split_h = !h_bf16 && !round_bf16;
  if (tab_bf16) return split_h ? Layout<__nv_bfloat16, 3>::kBytes : Layout<__nv_bfloat16, 1>::kBytes;
  return split_h ? Layout<float, 3>::kBytes : Layout<float, 1>::kBytes;
}
