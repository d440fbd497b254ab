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
// walks this routine in numpy; the two change together.  The routine itself
// is bisect_row in threshold.cuh; B2 runs its sweeps with a whole CTA.
#include "threshold.cuh"

namespace repro {

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
  float t;
  int c;
  bisect_row<N>(v, k, iters, &s_cand[threadIdx.x >> 5][0], t, c);
  if (lane == 0) {
    tau[row] = t;
    count[row] = c;
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
