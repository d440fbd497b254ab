// Value-axis bisection of one row held in registers: the device routine of
// the full-range threshold kernel (topk_threshold.cu).
//
// Each sweep is one block-wide count of ``mag >= mid``; every thread then
// updates lo/hi the same way, so the block agrees on the bracket without a
// broadcast.  The arithmetic is the reference's, op for op
// (repro/core/selection.py: upper_bracket, bisect_bracket):
// ``mid = 0.5 * (lo + hi)`` in round-to-nearest, no contraction, so the
// result is bitwise equal to the plain PyTorch version on the same input.
#pragma once

#include "common.cuh"

namespace repro {

// Row of ``cols`` floats into registers; items past the row hold -inf, which
// no threshold >= 0 counts.
template <int ITEMS>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int cols,
                                         float (&v)[ITEMS]) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int col = j * kThreads + threadIdx.x;
    v[j] = col < cols ? row[col] : -INFINITY;
  }
}

template <int ITEMS>
__device__ __forceinline__ float row_max(const float (&v)[ITEMS], float* fscratch) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) m = fmaxf(m, v[j]);
  return block_max(m, fscratch);
}

template <int ITEMS>
__device__ __forceinline__ int count_ge(const float (&v)[ITEMS], float t, int* iscratch) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) c += v[j] >= t ? 1 : 0;
  return block_sum(c, iscratch);
}

// nextafter(x, +inf) for non-negative finite x, clamped to FLT_MAX.
__device__ __forceinline__ float upper_bracket(float x) {
  return fminf(__int_as_float(__float_as_int(x) + 1), FLT_MAX);
}

// ``iters`` sweeps keeping count(>= lo) >= k > count(>= hi); returns lo.
template <int ITEMS>
__device__ __forceinline__ float bisect_bracket(const float (&v)[ITEMS], float lo, float hi,
                                                int k, int iters, int* iscratch) {
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool feasible = count_ge<ITEMS>(v, mid, iscratch) >= k;
    lo = feasible ? mid : lo;
    hi = feasible ? hi : mid;
  }
  return lo;
}

// Full-range bisection from [0, nextafter(max)].
template <int ITEMS>
__device__ __forceinline__ float bisect_tau(const float (&v)[ITEMS], int k, int iters,
                                            int* iscratch, float* fscratch) {
  const float hi = upper_bracket(row_max<ITEMS>(v, fscratch));
  return bisect_bracket<ITEMS>(v, 0.0f, hi, k, iters, iscratch);
}

}  // namespace repro
