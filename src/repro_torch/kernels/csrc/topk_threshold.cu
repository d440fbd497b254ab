// B1: per-row top-k threshold by value-axis bisection.
//
// Replaces the TPU kernel repro/kernels/topk_threshold.py::threshold_pallas
// (pl.pallas_call at l.63): per row, 48 bisection sweeps on
// [0, nextafter(row max)] give tau with count(mag >= tau) >= k, plus that
// count.
//
// Bound on this card: one read of the magnitude plane (4 B per element,
// 1.8 GB at 221,184 rows of 2049) and 8 B written per row, so about
// 0.54 ms at 3.35 TB/s.  The 48 sweeps are compare+count work on data that
// never leaves the SM.
//
// Design: one CTA of 256 threads per row.  The row is read from device
// memory once into registers (9 floats per thread at 2049 columns) and
// every sweep is a register compare, a warp shuffle reduction and one
// shared-memory exchange of 8 warp partials (threshold.cuh).  Simple and
// bitwise equal to the plain version; the two __syncthreads per sweep make
// it latency-bound, which a later PR can attack with several rows per CTA.
#include "threshold.cuh"

namespace repro {

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const float* __restrict__ mag, int cols, int k, int iters,
                      float* __restrict__ tau, int* __restrict__ count) {
  __shared__ int iscratch[kWarps];
  __shared__ float fscratch[kWarps];
  const size_t row = blockIdx.x;
  float v[ITEMS];
  load_row<ITEMS>(mag + row * cols, cols, v);
  const float t = bisect_tau<ITEMS>(v, k, iters, iscratch, fscratch);
  const int c = count_ge<ITEMS>(v, t, iscratch);
  if (threadIdx.x == 0) {
    tau[row] = t;
    count[row] = c;
  }
}

}  // namespace repro

REPRO_EXPORT int topk_threshold(const float* mag, int rows, int cols, int k, int iters,
                                float* tau, int* count, void* stream) {
  using namespace repro;
  const int items = (cols + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_ITEMS(items, topk_threshold_kernel<ITEMS><<<rows, kThreads, 0, s>>>(
                                  mag, cols, k, iters, tau, count));
  return static_cast<int>(cudaGetLastError());
}
