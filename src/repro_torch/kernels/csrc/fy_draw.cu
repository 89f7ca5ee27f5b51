// One round of the partial Fisher–Yates draw for K chains on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package this is the fori_loop of
// src/repro/core/samplers.py:62-90 (fy_draw), which XLA compiles into one
// loop inside the sequential test's while loop. In eager PyTorch each of its
// m swap steps is a handful of launches (hundreds per round), so the round is
// one kernel here.
//
// Per chain k, for s = 0 .. m-1 (the swaps are serially dependent):
//   p = min(pos + s, cap - 1);  span = max(size - p, 1)
//   j = min(p + min((int)(u[k, s] * span), span - 1), cap - 1)   (j = p when
//   the chain is not active: a self-swap leaves its buffer alone)
//   swap idx[k, p], idx[k, j]
// then out[k, i] = idx[k, min(pos + i, cap - 1)], valid[k, i] = pos + i < size
// and new_pos = min(pos + m, size) (pos when not active). The uniforms are
// the float64 draws the plain version takes from the generator; u * span is
// the same double product, truncated, so the indices are identical.
//
// What bounds it: latency. The m swaps of a chain are a chain of dependent
// reads and writes of device memory (2 m reads, 2 m writes, ~10 m integer
// operations); bytes and operations are both negligible (K = 32, m = 100:
// ~80 KB). One thread per chain walks its buffer in global memory (L2-resident
// at these sizes), so a round costs about m memory round trips. Staging the
// touched window of the buffer in shared memory is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
fy_draw_kernel(const double* __restrict__ u, int32_t* idx, const int32_t* __restrict__ pos,
               const int32_t* __restrict__ size, const uint8_t* __restrict__ active,
               int32_t* __restrict__ out, uint8_t* __restrict__ valid,
               int32_t* __restrict__ new_pos, int k, int m, int cap) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  int32_t* buf = idx + (size_t)c * cap;
  const double* uc = u + (size_t)c * m;
  const int p0 = pos[c], n = size[c];
  const bool act = active == nullptr || active[c] != 0;
  for (int s = 0; s < m; ++s) {
    const int p = min(p0 + s, cap - 1);
    const int span = max(n - p, 1);
    const int draw = min((int)(uc[s] * (double)span), span - 1);
    const int j = act ? min(p + draw, cap - 1) : p;
    const int32_t vi = buf[p], vj = buf[j];
    buf[p] = vj;
    buf[j] = vi;
  }
  for (int i = 0; i < m; ++i) {
    out[(size_t)c * m + i] = buf[min(p0 + i, cap - 1)];
    valid[(size_t)c * m + i] = (p0 + i) < n;
  }
  new_pos[c] = act ? min(p0 + m, n) : p0;
}

}  // namespace

// u: (K, m) float64 in [0, 1); idx: (K, cap) int32, swapped in place;
// pos, size: (K,) int32; active: (K,) bool or null (all active);
// out: (K, m) int32; valid: (K, m) bool; new_pos: (K,) int32.
extern "C" int fy_draw(const double* u, int32_t* idx, const int32_t* pos, const int32_t* size,
                       const uint8_t* active, int32_t* out, uint8_t* valid, int32_t* new_pos,
                       int k, int m, int cap, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  const int blocks = (k + kThreads - 1) / kThreads;
  fy_draw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, idx, pos, size, active, out, valid, new_pos, k, m, cap);
  return (int)cudaGetLastError();
}
