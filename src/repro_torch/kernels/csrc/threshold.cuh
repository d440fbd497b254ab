// Warp-per-row bisection pieces shared by the threshold kernels B1
// (topk_threshold.cu) and B4 (sampled_threshold.cu).
//
// One warp bisects one row; lane l holds the row's columns l, l + 32, ...
// in N registers (-inf past the row, which no count includes), N from
// dispatch_lane_items.  Every lane receives every count, so the lanes
// update lo/hi alike without a broadcast.  The arithmetic is the plain
// version's (core/selection.py: upper_bracket, bisect_bracket) op for op:
// mid = 0.5 * (lo + hi) in round-to-nearest, a NaN counts as not >=, a NaN
// or +inf maximum as torch.amax and upper_bracket give it.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kRowsPerCta = 4;  // one warp per row
constexpr float kMaxBracket = FLT_MAX / 4;  // brackets within it: lo + hi is finite

// count(v >= t) over the warp's row; every lane receives it.  Four
// accumulators keep the compare-and-add chains short.
template <int N>
__device__ __forceinline__ int warp_count_ge(const float (&v)[N], float t) {
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < N; ++j) c[j & 3] += v[j] >= t ? 1 : 0;
  return __reduce_add_sync(kFullMask, (c[0] + c[1]) + (c[2] + c[3]));
}

// The plain version's upper_bracket: the float above x (bit pattern + 1),
// clamped to FLT_MAX; a NaN result (x +inf or NaN) stays NaN, as
// torch.clamp_max keeps it.
__device__ __forceinline__ float upper_bracket(float x) {
  const float up = __uint_as_float(__float_as_uint(x) + 1u);
  return up != up ? up : fminf(up, FLT_MAX);
}

// The row maximum from each lane's maximum ``m`` (fmaxf drops a NaN) and
// the last NaN the lane saw: torch.amax returns a NaN of the row where
// there is one, so the first such lane's NaN is taken, bits and all, since
// upper_bracket adds one to its bits.
__device__ __forceinline__ float warp_max_keep_nan(float m, bool has_nan, float nan) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  const unsigned nan_lanes = __ballot_sync(kFullMask, has_nan);
  if (nan_lanes) m = __shfl_sync(kFullMask, nan, __ffs(nan_lanes) - 1);
  return m;
}

// CTAs per SM stated to ptxas: the registers a lane's N values and about 31
// more need.  Left to itself, ptxas picks fewer for some N and spills.
constexpr int min_ctas(int n) { return 65536 / (32 * kRowsPerCta) / ((n + 31 + 7) / 8 * 8); }

// Calls ``launch(std::integral_constant<int, N>{})`` for ceil(cols / 32) =
// items (1..128): N = items when that is 8g + 1 (2049, 1025, 513 columns:
// one lone column past a multiple of 256), else items rounded up to a
// multiple of 8, so 32 instantiations serve every width up to 4096.
template <int N = 1, typename Launch>
int dispatch_lane_items(int cols, Launch&& launch) {
  const int items = (cols + 31) / 32;
  if constexpr (N < kThreads * kMaxItems / 32) {
    if (items != N && (items % 8 == 1 || (items + 7) / 8 * 8 != N))
      return dispatch_lane_items<N % 8 == 1 ? N + 7 : N + 1>(cols, launch);
  }
  if (cols < 1 || cols > kThreads * kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  return launch(std::integral_constant<int, N>{});
}

}  // namespace repro
