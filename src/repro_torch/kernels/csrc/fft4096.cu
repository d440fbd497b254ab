// B7: batched 4096-point complex FFT and inverse FFT over re/im planes.
//
// Replaces the TPU kernel repro/kernels/fft4step.py::fft4096_pallas
// (pl.pallas_call at l.138): per row, X[k] = sum_n x[n] exp(-+2*pi*i*k*n/4096),
// the inverse scaled by 1/4096.  The TPU kernel runs Bailey's four-step
// algorithm as 64x64 DFT matmuls because its matrix unit is its only fast
// path (about 3.1 MFLOP per row); this card runs an FFT in fp32 on its CUDA
// cores (about 0.25 MFLOP per row).
//
// Bound on this card: read both input planes and write both output planes
// once, 4 x 16 KB per row: about 14.5 GB at 221,184 rows, so about 4.3 ms at
// 3.35 TB/s; the 5 N log2 N flops (0.25 MFLOP per row, about 0.8 ms at the
// fp32 rate) stay below it.
//
// Design: one CTA of 256 threads per row runs the register-resident
// three-pass radix-16 complex core of fft4096.cuh: pass A loads the row
// straight from device memory (16 coalesced loads per plane and thread),
// passes A and B exchange through a 32 KB XOR-swizzled shared buffer free of
// bank conflicts, pass C writes both planes straight to device memory in
// natural order; twiddles come from the wrapper's double-precision table
// through the read-only cache.  __launch_bounds__(256, 3): ptxas fits 76-78
// registers a thread, no spill, so 3 CTAs (24 warps) share an SM; enough
// loads are in flight to hold device memory near its rate (chip_smoke.py
// prints and checks the counts).  No tensor cores: TF32's 10 mantissa bits
// cannot hold the tolerance (fft4096.cuh).  Tolerance against the plain version (the
// reference's four-step math as fp32 matmuls): max abs error <= 2e-6 *
// max|X| per row, both planes.
#include "fft4096.cuh"

namespace repro {

constexpr int kFftMinBlocks = 3;  // CTAs per SM that the register budget must allow

template <bool kInverse>
__global__ void __launch_bounds__(kThreads, kFftMinBlocks)
fft4096_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
               const float2* __restrict__ twiddle, float* __restrict__ y_re,
               float* __restrict__ y_im) {
  __shared__ FftSmem s;
  const size_t off = static_cast<size_t>(blockIdx.x) * kFftN + threadIdx.x;
  fft4096_row<kInverse>(
      s, twiddle,
      [&](int m) {
        return make_float2(__ldg(x_re + off + kThreads * m), __ldg(x_im + off + kThreads * m));
      },
      [&](int k, float re, float im) {
        y_re[off + kThreads * k] = re;
        y_im[off + kThreads * k] = im;
      });
}

}  // namespace repro

// Planes are contiguous (rows, 4096) float32.  twiddle: fft4step.twiddles()
// (layout in fft4096.cuh).
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
