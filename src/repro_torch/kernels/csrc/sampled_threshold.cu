// B4: the sampled selector's whole threshold, one launch: the sample's
// bracket, the refinement and the mid-gap tau.
//
// Replaces the TPU kernel
// repro/kernels/sampled_threshold.py::sampled_threshold_pallas
// (pl.pallas_call at l.75) together with the plain jnp around it: the
// strided sample and its rank bracket (core/selection.py:
// strided_sample, sample_bracket) and the engine's mid-gap tau.  Per row:
// (1) the s sample columns offset + stride * i, and on them the two
// 48-sweep rank bisections on [0, upper_bracket(sample max)] that give the
// estimates lo (rank lo_rank) and hi (rank hi_rank); (2) the clamp, so
// that count(>= lo) >= k > count(>= hi) holds on the full row (falling
// back to 0 or nextafter(max)), then ``iters`` (16) bisection sweeps,
// giving tau_k = lo and count(>= tau_k); (3) the mid-gap tau =
// 0.5 * (tau_k + below), below the largest value < tau_k (0 if none; a NaN
// is not < tau_k).  s, stride, offset and the two ranks are the host's
// (selection._sample_layout, selection.sample_ranks).
//
// Bound on this card: one read of the magnitude plane (4 B per element)
// plus 12 B out per row: about 0.81 ms at 329,929 rows of 2049 (0.54 ms at
// 221,184) at 3.35 TB/s.  The sweeps' compares (17 a value) stay on the
// SM; the sample's sweeps touch one value a lane at 2049 columns.
//
// Design: one warp per row, four rows per CTA of 128 threads, no block
// barrier.  Lane l loads sample value l straight from the row, issued
// before the row's own loads, so the sample's bracket is found while the
// row is in flight: the two rank bisections count by ballot (a lane's
// further sample values, i = l + 32, l + 64, ..., read again from the row,
// by then in L1) and stop once a sweep leaves both brackets as they were,
// bit for bit (every later sweep would repeat it, as in B1).  Lane l holds
// the row's columns l, l + 32, ... in registers (65 at 2049 columns).  One pass computes count(>= lo), count(>= hi) and
// the row maximum together.  Each sweep is a compare-and-count over the
// lane's items and one warp reduction, and every lane updates lo/hi the
// same way.  The first 5 sweeps read the whole row; they hide under the
// row's load.  Then each lane moves its values in [lo, hi) (about 2 of its
// 65 on spectrum rows) into 8 registers, and the last 11 sweeps count those
// alone plus count(>= hi), which is exact while mid stays in [lo, hi].
// Rows where that cannot be shown (a NaN or huge bracket) or a lane has
// more than 8 such values (an all-zero row: every value is in
// [0, 2**-149)) sweep the whole row to the end.  The count of the final tau
// is the count of the sweep that set it; the mid-gap's maximum is one more
// pass over the registers.  The arithmetic is the plain chain's
// (kernels/sampled_threshold.py: sampled_select_plain) op for op -- mid =
// 0.5 * (lo + hi) in round-to-nearest, a NaN counts as not >= and not <, a
// NaN or +inf maximum as torch.amax and upper_bracket give it -- so tau_k,
// count and tau are bitwise equal to it.  A row whose bracket fell back
// adds 1 to ``fallback`` when it is given (tracing's
// exchange.bracket_fallback_rows).  tests/test_torch_compress_threshold_design.py
// walks this routine in numpy; the two change together.
#include "threshold.cuh"

namespace repro {

constexpr int kFullSweeps = 5;  // sweeps over the whole row before the compaction
constexpr int kCandRegs = 8;    // candidates a lane holds after it

// The sample's bracket, as the plain sample_bracket: the sample values are
// s_row[stride * i], i < s; the lane's first (i = lane) is ``first``, -inf
// past the sample.  Lane l holds i = l, l + 32, ...: the first in a
// register, the rest read again from the row (by then in L1) at every
// sweep.  The two rank bisections run side by side, each count a ballot
// and a popc per item a lane, and stop at the first sweep that leaves both
// brackets as they were, bit for bit: every later sweep would repeat it,
// as in B1.  Every lane receives (lo, hi).
__device__ __forceinline__ void sample_bracket(const float* __restrict__ s_row, float first,
                                               int s, int stride, int hi_rank, int lo_rank,
                                               int iters, float& lo, float& hi) {
  const int lane = threadIdx.x & 31;
  float m = first, nan = first;
  bool has_nan = first != first;
  for (int i = lane + 32; i < s; i += 32) {
    const float x = s_row[i * stride];
    m = fmaxf(m, x);
    if (x != x) {
      has_nan = true;
      nan = x;
    }
  }
  const float top = upper_bracket(warp_max_keep_nan(m, has_nan, nan));
  // rank hi_rank's bisection gives the estimate hi, rank lo_rank's lo
  float lo_h = 0.0f, hi_h = top, lo_l = 0.0f, hi_l = top;
  for (int it = 0; it < iters; ++it) {
    const float mid_h = __fmul_rn(0.5f, __fadd_rn(lo_h, hi_h));
    const float mid_l = __fmul_rn(0.5f, __fadd_rn(lo_l, hi_l));
    int c_h = __popc(__ballot_sync(kFullMask, first >= mid_h));
    int c_l = __popc(__ballot_sync(kFullMask, first >= mid_l));
    for (int i0 = 32; i0 < s; i0 += 32) {
      const int i = i0 + lane;
      const float x = i < s ? s_row[i * stride] : -INFINITY;
      c_h += __popc(__ballot_sync(kFullMask, x >= mid_h));
      c_l += __popc(__ballot_sync(kFullMask, x >= mid_l));
    }
    const bool feas_h = c_h >= hi_rank;
    const bool feas_l = c_l >= lo_rank;
    const float moved_h = feas_h ? lo_h : hi_h;  // the end mid replaces
    const float moved_l = feas_l ? lo_l : hi_l;
    lo_h = feas_h ? mid_h : lo_h;
    hi_h = feas_h ? hi_h : mid_h;
    lo_l = feas_l ? mid_l : lo_l;
    hi_l = feas_l ? hi_l : mid_l;
    if (__float_as_uint(mid_h) == __float_as_uint(moved_h) &&
        __float_as_uint(mid_l) == __float_as_uint(moved_l))
      break;
  }
  lo = lo_l;
  hi = lo_h;
}

// N: items per lane (columns l + 32 j, j < N; past the row they hold -inf,
// which no count includes).
template <int N>
__global__ void __launch_bounds__(32 * kRowsPerCta, min_ctas(N))
sampled_threshold_kernel(const float* __restrict__ mag, int rows, int cols, int k, int s,
                         int stride, int offset, int hi_rank, int lo_rank, int sample_iters,
                         int iters, float* __restrict__ tau_k, int* __restrict__ count,
                         float* __restrict__ tau, unsigned long long* __restrict__ fallback) {
  __shared__ float s_cand[kRowsPerCta][kCandRegs][32];
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(rows)) return;  // whole warps only
  const float* m_row = mag + row * cols;
  const float* s_row = m_row + offset;
  const float first = lane < s ? s_row[lane * stride] : -INFINITY;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = 32 * j + lane;
    v[j] = col < cols ? m_row[col] : -INFINITY;
  }
  float lo0, hi0;
  sample_bracket(s_row, first, s, stride, hi_rank, lo_rank, sample_iters, lo0, hi0);

  // the clamp: count(>= lo0), count(>= hi0) and the maximum in one pass
  int c_lo = 0, c_hi = 0;
  float m = -INFINITY, nan = 0.0f;  // nan: the lane's last NaN, else 0
  bool has_nan = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c_lo += v[j] >= lo0 ? 1 : 0;
    c_hi += v[j] >= hi0 ? 1 : 0;
    m = fmaxf(m, v[j]);
    has_nan |= v[j] != v[j];
  }
  if (has_nan) {  // rare: a second pass for the NaN's bits
#pragma unroll
    for (int j = 0; j < N; ++j) nan = v[j] != v[j] ? v[j] : nan;
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

  // the mid-gap: the largest value below tau_k, each value not below it
  // counting as 0, as torch.where(mag < tau_k, mag, 0).amax gives it (the
  // -inf past the row is below every tau_k and changes no maximum)
  float below = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) below = fmaxf(below, v[j] < lo ? v[j] : 0.0f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    below = fmaxf(below, __shfl_xor_sync(kFullMask, below, off));
  if (lane == 0) {
    tau_k[row] = lo;
    count[row] = lo_count;
    tau[row] = __fmul_rn(0.5f, __fadd_rn(lo, below));
    if (fallback != nullptr && (c_lo < k || c_hi >= k)) atomicAdd(fallback, 1ull);
  }
}

}  // namespace repro

REPRO_EXPORT int sampled_select(const float* mag, int rows, int cols, int k, int s, int stride,
                                int offset, int hi_rank, int lo_rank, int sample_iters, int iters,
                                float* tau_k, int* count, float* tau,
                                unsigned long long* fallback, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > cols || stride < 1 || offset < 0 || offset + (s - 1) * stride >= cols)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_lane_items(cols, [&](auto n) {
    constexpr int N = decltype(n)::value;
    const int grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
    sampled_threshold_kernel<N><<<grid, 32 * kRowsPerCta, 0, st>>>(
        mag, rows, cols, k, s, stride, offset, hi_rank, lo_rank, sample_iters, iters, tau_k,
        count, tau, fallback);
    return static_cast<int>(cudaGetLastError());
  });
}
