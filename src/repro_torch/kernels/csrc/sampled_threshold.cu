// B4: sampled-bracket threshold refinement.
//
// Replaces the TPU kernel
// repro/kernels/sampled_threshold.py::sampled_threshold_pallas
// (pl.pallas_call at l.75): per row, clamp the estimated (lo, hi) so that
// count(>= lo) >= k > count(>= hi) holds on the full row (falling back to 0
// or nextafter(max)), then run ``refine_iters`` (16) bisection sweeps.  The
// strided sample and its bracket stay plain PyTorch in the wrapper, as they
// stay plain jnp in the reference.
//
// Bound on this card: one read of the magnitude plane (4 B per element)
// plus 8 B in and 8 B out per row: about 0.54 ms at 221,184 rows of 2049 at
// 3.35 TB/s.
//
// Design: the B1 routine (threshold.cuh) with a clamped starting bracket:
// one CTA of 256 threads per row, the row in registers, 2 clamp counts +
// 16 sweeps + 1 final count, each a block-wide count.  Bitwise equal to the
// plain version.
#include "threshold.cuh"

namespace repro {

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
sampled_threshold_kernel(const float* __restrict__ mag, const float* __restrict__ lo_in,
                         const float* __restrict__ hi_in, int cols, int k, int iters,
                         float* __restrict__ tau, int* __restrict__ count) {
  __shared__ int iscratch[kWarps];
  __shared__ float fscratch[kWarps];
  const size_t row = blockIdx.x;
  float v[ITEMS];
  load_row<ITEMS>(mag + row * cols, cols, v);
  const float t = refine_bracket<ITEMS>(v, lo_in[row], hi_in[row], k, iters, iscratch, fscratch);
  const int c = count_ge<ITEMS>(v, t, iscratch);
  if (threadIdx.x == 0) {
    tau[row] = t;
    count[row] = c;
  }
}

}  // namespace repro

REPRO_EXPORT int sampled_threshold(const float* mag, const float* lo, const float* hi, int rows,
                                   int cols, int k, int iters, float* tau, int* count,
                                   void* stream) {
  using namespace repro;
  const int items = (cols + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_ITEMS(items, sampled_threshold_kernel<ITEMS><<<rows, kThreads, 0, s>>>(
                                  mag, lo, hi, cols, k, iters, tau, count));
  return static_cast<int>(cudaGetLastError());
}
