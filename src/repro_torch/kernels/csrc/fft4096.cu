// B7: batched 4096-point complex FFT and inverse FFT over re/im planes.
//
// Replaces the TPU kernel repro/kernels/fft4step.py::fft4096_pallas
// (pl.pallas_call at l.138): per row, X[k] = sum_n x[n] exp(-+2*pi*i*k*n/4096),
// the inverse scaled by 1/4096.  The TPU kernel runs Bailey's four-step
// algorithm as 64x64 DFT matmuls because its matrix unit is its only fast
// path (about 3.1 MFLOP per row); this card runs a radix-2 FFT in fp32 on
// its CUDA cores (about 0.25 MFLOP per row).
//
// Bound on this card: read both input planes and write both output planes
// once, 4 x 16 KB per row: about 14.5 GB at 221,184 rows, so about 4.3 ms at
// 3.35 TB/s; the 5 N log2 N flops (0.25 MFLOP per row, about 0.8 ms at the
// fp32 rate) stay below it.
//
// Design: one CTA of 256 threads per row, the row as float2 in 32 KB of
// shared memory, the radix-2 decimation-in-frequency stages of
// fft4096.cuh (B3 runs the same stages as its inverse), twiddles from a
// table computed in double; the bit-reversed order is undone on the write.
// No tensor cores and no TF32.  Tolerance against the plain version (the
// reference's four-step math as fp32 matmuls): max abs error <= 2e-6 *
// max|X| per row, both planes.
#include "fft4096.cuh"

namespace repro {

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
fft4096_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
               const float2* __restrict__ twiddle, float* __restrict__ y_re,
               float* __restrict__ y_im) {
  __shared__ float2 spec[kFftN];
  const size_t off = static_cast<size_t>(blockIdx.x) * kFftN;
  for (int n = threadIdx.x; n < kFftN; n += kThreads)
    spec[n] = make_float2(x_re[off + n], x_im[off + n]);
  __syncthreads();

  fft4096_dif<kInverse>(spec, twiddle);

  const float scale = kInverse ? 1.0f / kFftN : 1.0f;
  for (int n = threadIdx.x; n < kFftN; n += kThreads) {
    const float2 v = spec[fft4096_bitrev(n)];
    y_re[off + n] = v.x * scale;
    y_im[off + n] = v.y * scale;
  }
}

}  // namespace repro

// Planes are contiguous (rows, 4096) float32.  twiddle: 2048 float2,
// exp(+2*pi*i*m/4096) for m < 2048.
REPRO_EXPORT int fft4096(const float* x_re, const float* x_im, int rows, int inverse,
                         const void* twiddle, float* y_re, float* y_im, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* tw = static_cast<const float2*>(twiddle);
  if (inverse)
    fft4096_kernel<true><<<rows, kThreads, 0, s>>>(x_re, x_im, tw, y_re, y_im);
  else
    fft4096_kernel<false><<<rows, kThreads, 0, s>>>(x_re, x_im, tw, y_re, y_im);
  return static_cast<int>(cudaGetLastError());
}
