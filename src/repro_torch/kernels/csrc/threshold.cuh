// Warp-per-row bisection pieces shared by the threshold kernels B1
// (topk_threshold.cu) and B4 (sampled_threshold.cu), and B1's row routine.
// B2 (fused_compress.cu) runs B1's sweeps with a whole CTA when it bisects
// for its own tau, from the pieces below.
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

constexpr int kCandPerLane = 2;              // candidates a lane holds after B1's compaction
constexpr int kCompactAt = 32 * kCandPerLane;  // values in [lo, hi) that B1's warp compacts

// The warp's values in [lo, hi), ``n`` of them (n <= kCompactAt), to the
// warp's kCompactAt floats of shared memory at the 32-bit shared address
// ``slots``, in lane order (an exclusive scan of the lanes' counts), then
// back as kCandPerLane a lane, -inf past n.  Then count(>= mid) =
// count(>= hi) + warp_count_ge(cv, mid) for every mid in [lo, hi].  The
// stores use the 32-bit address: left to itself the compiler rebuilds a
// generic one (an S2R of the cluster id and three more instructions) at
// every predicated store.
template <int N>
__device__ __forceinline__ void compact_candidates(const float (&v)[N], float lo, float hi, int n,
                                                   unsigned slots, float (&cv)[kCandPerLane]) {
  const int lane = threadIdx.x & 31;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) mine += v[j] >= lo && v[j] < hi ? 1 : 0;
  int slot = mine;  // inclusive scan over the lanes, then exclusive
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFullMask, slot, off);
    slot += lane >= off ? up : 0;
  }
  slot -= mine;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (v[j] >= lo && v[j] < hi) {
      asm volatile("st.shared.f32 [%0], %1;" ::"r"(slots + 4 * slot), "f"(v[j]) : "memory");
      ++slot;
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kCandPerLane; ++r) {
    const int s = 32 * r + lane;
    cv[r] = -INFINITY;  // below every mid
    if (s < n)
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(cv[r]) : "r"(slots + 4 * s) : "memory");
  }
}

// B1's row routine (topk_threshold.cu says how it works): ``iters``
// bisection sweeps on [0, upper_bracket(max)] for the row's k-th value, as
// the plain version's bisect_tau, with the compaction and the fixed-point
// stop.  ``cand``: the warp's kCompactAt floats of shared memory.  Every
// lane receives tau and count(>= tau).
template <int N>
__device__ __forceinline__ void bisect_row(const float (&v)[N], int k, int iters, float* cand,
                                           float& tau, int& count) {
  // count(>= 0) and the maximum in one pass
  int c_zero = 0;
  float m = -INFINITY, nan = 0.0f;
  bool has_nan = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c_zero += v[j] >= 0.0f ? 1 : 0;
    m = fmaxf(m, v[j]);
    if (v[j] != v[j]) {
      has_nan = true;
      nan = v[j];
    }
  }
  m = warp_max_keep_nan(m, has_nan, nan);

  // the bracket with count(>= lo), carried so the final count is free, and
  // count(>= hi) where it is known: 0 when hi lies above the maximum (not
  // for a maximum of FLT_MAX, +inf or NaN, nor a negative one)
  float lo = 0.0f;
  float hi = upper_bracket(m);
  int lo_count = __reduce_add_sync(kFullMask, c_zero);
  int hi_count = 0;
  bool hi_known = hi > m;

  const unsigned slots = static_cast<unsigned>(__cvta_generic_to_shared(cand));
  float cv[kCandPerLane];
  bool dense = false;
  for (int it = 0; it < iters; ++it) {
    if (!dense && hi_known && lo_count - hi_count <= kCompactAt && lo <= hi &&
        fabsf(lo) <= kMaxBracket && fabsf(hi) <= kMaxBracket) {  // lo <= mid <= hi
      compact_candidates<N>(v, lo, hi, lo_count - hi_count, slots, cv);
      dense = true;
    }
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int c = dense ? hi_count + warp_count_ge<kCandPerLane>(cv, mid)
                        : warp_count_ge<N>(v, mid);
    const bool feasible = c >= k;
    const float moved = feasible ? lo : hi;  // the end mid replaces
    lo = feasible ? mid : lo;
    lo_count = feasible ? c : lo_count;
    hi = feasible ? hi : mid;
    if (!feasible && !dense) {  // after the compaction hi_count stays count(>= its hi)
      hi_count = c;
      hi_known = true;
    }
    if (__float_as_uint(mid) == __float_as_uint(moved)) break;  // the fixed point
  }
  tau = lo;
  count = lo_count;
}

}  // namespace repro
