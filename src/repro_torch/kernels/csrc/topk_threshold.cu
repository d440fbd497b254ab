// B1: per-row top-k threshold by value-axis bisection.
//
// Replaces the TPU kernel repro/kernels/topk_threshold.py::threshold_pallas
// (pl.pallas_call at l.63): per row, ``iters`` (48) bisection sweeps on
// [0, upper_bracket(row max)] give tau with count(mag >= tau) >= k, plus
// that count.
//
// Bound on this card: one read of the magnitude plane (4 B per element,
// 1.8 GB at 221,184 rows of 2049) and 8 B written per row: about 0.54 ms at
// 3.35 TB/s.  The passes over the whole row (the maximum, then the sweeps
// until the bracket's values fit the candidate registers, about 7 on
// spectrum rows) are compare+count work on data that never leaves the SM.
//
// Design: one warp per row, four rows per CTA of 128 threads, no block
// barrier (threshold.cuh, as B4).  Lane l holds the row's columns l, l + 32,
// ... in registers (65 at 2049 columns).  One pass takes count(>= 0) and
// the row maximum, a NaN of the row kept bits and all as torch.amax keeps
// it; hi = upper_bracket(max), which leaves a NaN a NaN and steps +inf to
// one, as the plain version does.  Each sweep is a compare-and-count over
// the lane's items and one warp reduction.  count(>= lo) and count(>= hi)
// are carried, so after every sweep the warp knows how many values lie in
// [lo, hi); at the first sweep where that is at most kCompactAt (64: after
// about 7 sweeps on spectrum rows), and the bracket allows the proof
// (count(>= hi) known, lo <= hi, |lo|, |hi| <= FLT_MAX/4), the warp
// compacts those values through shared memory into kCandPerLane registers
// a lane, and the later sweeps count them alone plus count(>= hi).  Rows
// where that never applies (all-equal rows, ties, NaN or huge brackets)
// sweep the row in full.
//
// Early stop: the loop ends after the first sweep that leaves lo and hi as
// they were, bit for bit.  mid depends on (lo, hi) alone and count(>= mid)
// on mid and the row alone (the candidate count is exact), so every later
// sweep would repeat that one exactly: tau and count are what all
// ``iters`` sweeps give.  Spectrum rows stop after about 25 sweeps, all-zero
// rows after 1 (lo = 0, hi = 2**-149, and mid rounds to 0).  The count is
// the one carried from the sweep that set tau (count(>= 0) if none did),
// so no final pass is needed.  mid = 0.5 * (lo + hi) in round-to-nearest,
// as in the plain version (core/selection.py: bisect_tau), so tau and count
// are bitwise equal to it.  tests/test_torch_compress_threshold_design.py
// walks this routine in numpy; the two change together.
#include "threshold.cuh"

namespace repro {

constexpr int kCandPerLane = 2;              // candidates a lane holds after the compaction
constexpr int kCompactAt = 32 * kCandPerLane;  // values in [lo, hi) that the warp compacts

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

// N: items per lane (columns l + 32 j, j < N; past the row they hold -inf,
// which no count includes).
template <int N>
__global__ void __launch_bounds__(32 * kRowsPerCta, min_ctas(N))
topk_threshold_kernel(const float* __restrict__ mag, int rows, int cols, int k, int iters,
                      float* __restrict__ tau, int* __restrict__ count) {
  __shared__ float s_cand[kRowsPerCta][kCompactAt];
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(rows)) return;  // whole warps only
  const float* m_row = mag + row * cols;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = 32 * j + lane;
    v[j] = col < cols ? m_row[col] : -INFINITY;
  }

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

  const unsigned slots =
      static_cast<unsigned>(__cvta_generic_to_shared(&s_cand[threadIdx.x >> 5][0]));
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
  if (lane == 0) {
    tau[row] = lo;
    count[row] = lo_count;
  }
}

}  // namespace repro

REPRO_EXPORT int topk_threshold(const float* mag, int rows, int cols, int k, int iters,
                                float* tau, int* count, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_lane_items(cols, [&](auto n) {
    constexpr int N = decltype(n)::value;
    const int grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
    topk_threshold_kernel<N><<<grid, 32 * kRowsPerCta, 0, s>>>(mag, rows, cols, k, iters, tau,
                                                               count);
    return static_cast<int>(cudaGetLastError());
  });
}
