// The 4096-point complex FFT stages shared by B3 (fused_decompress.cu, the
// inverse) and B7 (fft4096.cu, forward and inverse): an in-place radix-2
// decimation-in-frequency FFT over 32 KB of shared memory, run by the
// block's kThreads threads, in fp32 with twiddles computed in double and
// rounded to float (a 2048-entry table, exp(+2*pi*i*m/4096), that the
// wrapper passes in; the forward transform uses its conjugate).  The result
// is left in bit-reversed order: bin n sits at fft4096_bitrev(n).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kFftN = 4096;
constexpr int kFftHalf = kFftN / 2;
constexpr int kFftLog2 = 12;

__device__ __forceinline__ int fft4096_bitrev(int n) {
  return static_cast<int>(__brev(static_cast<unsigned>(n)) >> (32 - kFftLog2));
}

// Stage s halves the span ``half``; the twiddle of position ``pos`` in its
// group is exp(sign * 2*pi*i * pos * stride / 4096), sign + for the inverse.
// Ends with a block barrier, so the caller may read ``spec`` right away.
template <bool kInverse>
__device__ __forceinline__ void fft4096_dif(float2* spec, const float2* __restrict__ twiddle) {
  for (int half = kFftHalf, stride = 1; half >= 1; half >>= 1, stride <<= 1) {
    for (int bf = threadIdx.x; bf < kFftHalf; bf += kThreads) {
      const int pos = bf & (half - 1);
      const int i = 2 * bf - pos;  // group * 2 * half + pos
      const int j = i + half;
      const float2 u = spec[i];
      const float2 v = spec[j];
      float2 tw = twiddle[pos * stride];
      if (!kInverse) tw.y = -tw.y;
      const float dx = u.x - v.x;
      const float dy = u.y - v.y;
      spec[i] = make_float2(u.x + v.x, u.y + v.y);
      spec[j] = make_float2(dx * tw.x - dy * tw.y, dx * tw.y + dy * tw.x);
    }
    __syncthreads();
  }
}

}  // namespace repro
