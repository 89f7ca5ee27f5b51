// One round of the partial Fisher–Yates draw for K chains on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package this is the fori_loop of
// src/repro/core/samplers.py:62-90 (fy_draw), which XLA compiles into one
// loop inside the sequential test's while loop. In eager PyTorch each of its
// m swap steps is a handful of launches (hundreds per round), so the round is
// one kernel here.
//
// Per chain k, for s = 0 .. m-1 (the swaps compose in this order):
//   p = min(pos + s, cap - 1);  span = max(size - p, 1)
//   j = min(p + min((int)(u[k, s] * span), span - 1), cap - 1)   (j = p when
//   the chain is not active: a self-swap leaves its buffer alone)
//   swap idx[k, p], idx[k, j]
// then out[k, i] = idx[k, min(pos + i, cap - 1)], valid[k, i] = pos + i < size
// and new_pos = min(pos + m, size) (pos when not active). The uniforms are
// the float64 draws the plain version takes from the generator; u * span is
// the same double product, truncated, so the indices are identical.
//
// The bounded draw (src/repro/core/samplers.py:93-107, fy_draw_bounded, the
// adaptive scheduler's effective batch): with a per-chain m_eff[k] in
// [0, m], the swaps and out[] are unchanged, valid[k, i] also needs
// i < m_eff[k], and new_pos = min(pos + m_eff[k], size). With m_eff null
// the kernel is the unbounded draw, bit for bit. The next round's window
// then starts at pos + m_eff, inside this round's: positions
// [pos + m_eff, pos + m) hold values this round's swaps put there but
// flagged invalid, so nothing is drawn twice, and the next round's
// Fisher–Yates walk over [pos + m_eff, size) takes fresh uniforms from
// whatever permutation it finds: any start state gives a uniform draw. No
// later swap of the transition touches a position below pos + m_eff (every
// later p is at least that, and j >= p), so the indices already handed out
// stay where they were drawn. Within one launch nothing changes: the
// trace-back below resolves all m swaps of the round as before.
//
// What bounds it: latency. Bytes (the uniforms, at most 2 m buffer entries
// read and written, the outputs: ~90 KB at K = 32, m = 100) and integer
// operations are negligible. Walking the swaps through the buffer costs m
// dependent memory round trips, because a step may read what the step
// before it wrote.
//
// Design: the swap pairs (p_s, j_s) depend on the uniforms, pos and size
// alone, never on the buffer, so the walk is not needed. One block per
// chain; the steps go in chunks of kChunk (one chunk for m <= kChunk):
//   1. thread s computes step s's pair into shared memory (all at once);
//   2. thread e takes the e-th touched position x (p_e for e < n, else
//      j_{e-n}) and traces it back through the chunk's swaps in reverse
//      order, y = t_0(t_1(...t_{n-1}(x))) with t_s the transposition of
//      (p_s, j_s): after the swaps, buf[x] holds what buf[y] held before
//      them. The trace reads only the pairs (broadcast shared-memory reads)
//      and its dependent chain is one compare-and-select a step, on
//      registers;
//   3. every thread reads buf[y] at once: one memory round trip for the
//      chunk in place of n dependent ones. The buffer is never staged, so
//      N = 1e5 takes the same path as N = 1000;
//   4. after a barrier every thread writes buf[x]; a position that several
//      steps touch is written by each of their threads with the same value.
//      out[s] is the value written at p_s (p_s is the window's position
//      min(pos + s, cap - 1)), valid[s] and new_pos follow.
// A later chunk never changes an earlier chunk's window: its swaps touch
// positions >= its own p > the earlier window, or are self-swaps at cap - 1
// once pos + s has reached it. Duplicate targets, targets inside the window
// ahead of their step, the clamped tail, an exhausted pool (every span 1,
// every swap a self-swap) and size < cap all fall out of the trace. An
// inactive chain's pairs are all self-swaps: it only gathers its window and
// writes nothing into its buffer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;            // swap steps resolved together
constexpr int kThreads = 2 * kChunk;   // one thread per touched position

__global__ void __launch_bounds__(kThreads)
fy_draw_kernel(const double* __restrict__ u, int32_t* idx, const int32_t* __restrict__ pos,
               const int32_t* __restrict__ size, const uint8_t* __restrict__ active,
               const int32_t* __restrict__ m_eff, int32_t* __restrict__ out,
               uint8_t* __restrict__ valid, int32_t* __restrict__ new_pos, int m, int cap) {
  __shared__ int2 pair[kChunk];  // (p_s, j_s) of the chunk's steps
  const int c = blockIdx.x, t = threadIdx.x;
  int32_t* buf = idx + (size_t)c * cap;
  const double* uc = u + (size_t)c * m;
  const int p0 = pos[c], sz = size[c];
  const bool act = active == nullptr || active[c] != 0;
  const int take = m_eff == nullptr ? m : m_eff[c];  // lanes valid and consumed
  for (int s0 = 0; s0 < m; s0 += kChunk) {
    const int n = min(kChunk, m - s0);
    if (t < n) {
      const int p = min(p0 + s0 + t, cap - 1);
      const int span = max(sz - p, 1);
      const int draw = min((int)(uc[s0 + t] * (double)span), span - 1);
      pair[t] = make_int2(p, act ? min(p + draw, cap - 1) : p);
    }
    __syncthreads();
    int x = 0;
    int32_t v = 0;
    if (t < 2 * n) {
      x = t < n ? pair[t].x : pair[t - n].y;
      int y = x;
      if (act) {
#pragma unroll 8
        for (int s = n - 1; s >= 0; --s) {
          const int2 ps = pair[s];
          y = y == ps.x ? ps.y : (y == ps.y ? ps.x : y);
        }
      }
      v = buf[y];
    }
    __syncthreads();  // every read of the chunk before any write
    if (t < 2 * n) {
      if (act) buf[x] = v;
      if (t < n) {
        out[(size_t)c * m + s0 + t] = v;
        valid[(size_t)c * m + s0 + t] = (p0 + s0 + t) < sz && s0 + t < take;
      }
    }
    __syncthreads();  // the next chunk reads these writes and reuses pair
  }
  if (t == 0) new_pos[c] = act ? min(p0 + take, sz) : p0;
}

}  // namespace

// u: (K, m) float64 in [0, 1); idx: (K, cap) int32, swapped in place;
// pos, size: (K,) int32; active: (K,) bool or null (all active);
// m_eff: (K,) int32 in [0, m] or null (m for every chain);
// out: (K, m) int32; valid: (K, m) bool; new_pos: (K,) int32.
extern "C" int fy_draw(const double* u, int32_t* idx, const int32_t* pos, const int32_t* size,
                       const uint8_t* active, const int32_t* m_eff, int32_t* out,
                       uint8_t* valid, int32_t* new_pos, int k, int m, int cap, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  fy_draw_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, idx, pos, size, active, m_eff, out, valid, new_pos, m, cap);
  return (int)cudaGetLastError();
}
