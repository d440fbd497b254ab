// B4: sampled-bracket threshold refinement.
//
// Replaces the TPU kernel
// repro/kernels/sampled_threshold.py::sampled_threshold_pallas
// (pl.pallas_call at l.75): per row, clamp the estimated (lo, hi) so that
// count(>= lo) >= k > count(>= hi) holds on the full row (falling back to 0
// or nextafter(max)), then run ``refine_iters`` (16) bisection sweeps, and
// report tau = lo with count(>= tau).  The strided sample and its bracket
// stay plain PyTorch in the wrapper, as they stay plain jnp in the
// reference.
//
// Bound on this card: one read of the magnitude plane (4 B per element)
// plus 8 B in and 8 B out per row: about 0.54 ms at 221,184 rows of 2049 at
// 3.35 TB/s.  The sweeps' compares (17 a value) stay on the SM.
//
// Design: one warp per row, four rows per CTA of 128 threads, no block
// barrier.  Lane l holds the row's columns l, l + 32, ... in registers
// (65 at 2049 columns).  One pass computes count(>= lo), count(>= hi) and
// the row maximum together.  Each sweep is a compare-and-count over the
// lane's items and one warp reduction (redux.sync), and every lane updates
// lo/hi the same way.  The first 5 sweeps read the whole row; they hide
// under the row's load.  Then each lane moves its values in [lo, hi) (about
// 2 of its 65 on spectrum rows) into 8 registers, and the last 11 sweeps
// count those alone plus count(>= hi), which is exact while mid stays in
// [lo, hi].  Rows where that cannot be shown (a NaN or huge bracket) or a
// lane has more than 8 such values (an all-zero row: every value is in
// [0, 2**-149)) sweep the whole row to the end.  The count of the final tau
// is the count of the sweep that set it, so no further pass is needed.
// The arithmetic is the plain version's (core/selection.py: refine_bracket,
// bisect_bracket, upper_bracket) op for op -- mid = 0.5 * (lo + hi) in
// round-to-nearest, a NaN counts as not >=, a NaN or +inf maximum as
// torch.amax and upper_bracket give it -- so tau and count are bitwise
// equal to it.  tests/test_torch_compress_threshold_design.py walks this
// routine in numpy; the two change together.
#include "threshold.cuh"

namespace repro {

constexpr int kFullSweeps = 5;  // sweeps over the whole row before the compaction
constexpr int kCandRegs = 8;    // candidates a lane holds after it

// N: items per lane (columns l + 32 j, j < N; past the row they hold -inf,
// which no count includes).
template <int N>
__global__ void __launch_bounds__(32 * kRowsPerCta, min_ctas(N))
sampled_threshold_kernel(const float* __restrict__ mag, const float* __restrict__ lo_in,
                         const float* __restrict__ hi_in, int rows, int cols, int k, int iters,
                         float* __restrict__ tau, int* __restrict__ count) {
  __shared__ float s_cand[kRowsPerCta][kCandRegs][32];
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
  const float lo0 = lo_in[row];
  const float hi0 = hi_in[row];

  // the clamp: count(>= lo0), count(>= hi0) and the maximum in one pass
  int c_lo = 0, c_hi = 0;
  float m = -INFINITY, nan = 0.0f;
  bool has_nan = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c_lo += v[j] >= lo0 ? 1 : 0;
    c_hi += v[j] >= hi0 ? 1 : 0;
    m = fmaxf(m, v[j]);
    if (v[j] != v[j]) {
      has_nan = true;
      nan = v[j];
    }
  }
  // per-lane counts are at most N <= 128, row counts at most 4096 < 2**16
  const int both = __reduce_add_sync(kFullMask, c_lo | (c_hi << 16));
  c_lo = both & 0xffff;
  c_hi = both >> 16;
  m = warp_max_keep_nan(m, has_nan, nan);

  // the bracket with count(>= lo), carried so the final count is free, and
  // count(>= hi) where it is known
  float lo = lo0, hi = hi0;
  int lo_count = c_lo, hi_count = c_hi;
  bool hi_known = true;
  if (c_lo < k) {
    lo = 0.0f;
    lo_count = warp_count_ge<N>(v, 0.0f);
  }
  if (c_hi >= k) {
    hi = upper_bracket(m);
    hi_count = 0;              // nothing is >= nextafter(max) ...
    hi_known = m < FLT_MAX;  // ... unless max is FLT_MAX, +inf or NaN
  }

  // kFullSweeps sweeps over the row, then each lane's candidates [lo, hi)
  // into kCandRegs registers (through its own column of shared memory) and
  // the rest of the sweeps over them alone: count(>= mid) = count(>= hi) +
  // #{v in [lo, hi) : v >= mid} holds for every later mid, which stays in
  // [lo, hi].  Rows whose bracket allows no such proof, or where a lane has
  // more than kCandRegs candidates, sweep the row.  The column is addressed
  // as a 32-bit shared address: left to itself the compiler rebuilds a
  // generic one (an S2R of the cluster id and three more instructions) at
  // every predicated store.
  const unsigned column = static_cast<unsigned>(
      __cvta_generic_to_shared(&s_cand[threadIdx.x >> 5][0][lane]));
  float cv[kCandRegs];
  bool dense = false;
  for (int it = 0; it < iters; ++it) {
    if (it == kFullSweeps && hi_known && lo <= hi && fabsf(lo) <= kMaxBracket &&
        fabsf(hi) <= kMaxBracket) {  // lo + hi cannot overflow: lo <= mid <= hi
      int n = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (v[j] >= lo && v[j] < hi) {
          if (n < kCandRegs)
            asm volatile("st.shared.f32 [%0], %1;" ::"r"(column + 128 * n), "f"(v[j]) : "memory");
          ++n;
        }
      }
      dense = __reduce_max_sync(kFullMask, n) <= kCandRegs;
#pragma unroll
      for (int r = 0; r < kCandRegs; ++r) {
        cv[r] = -INFINITY;  // below every mid
        if (r < n)
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(cv[r]) : "r"(column + 128 * r) : "memory");
      }
    }
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int c = dense ? hi_count + warp_count_ge<kCandRegs>(cv, mid)
                        : warp_count_ge<N>(v, mid);
    const bool feasible = c >= k;
    lo = feasible ? mid : lo;
    lo_count = feasible ? c : lo_count;
    hi = feasible ? hi : mid;
    if (!feasible && !dense) {  // after the compaction hi_count stays count(>= its hi)
      hi_count = c;
      hi_known = true;
    }
  }
  if (lane == 0) {
    tau[row] = lo;
    count[row] = lo_count;
  }
}

}  // namespace repro

REPRO_EXPORT int sampled_threshold(const float* mag, const float* lo, const float* hi, int rows,
                                   int cols, int k, int iters, float* tau, int* count,
                                   void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_lane_items(cols, [&](auto n) {
    constexpr int N = decltype(n)::value;
    const int grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
    sampled_threshold_kernel<N><<<grid, 32 * kRowsPerCta, 0, s>>>(mag, lo, hi, rows, cols, k,
                                                                  iters, tau, count);
    return static_cast<int>(cudaGetLastError());
  });
}
