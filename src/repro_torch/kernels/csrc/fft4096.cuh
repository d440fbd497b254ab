// The FFT cores of B7 (fft4096.cu, forward and inverse) and B3
// (fused_decompress.cu, the real inverse): register-resident three-pass
// Stockham FFTs, one row per 256 threads (B7) or per 128 threads (B3, two
// rows per CTA), 16 points per thread.  tests/test_torch_fft4096_design.py
// transcribes this file's index arithmetic into numpy (maps, bank
// conflicts, twiddle exponents, and walks against np.fft and the
// reference's Pallas kernel); change the two together.
//
// The complex core, fft4096_row: with 4096 = 16 x 16 x 16,
// n = n0 + 16 n1 + 256 n2, k = k0 + 16 k1 + 256 k2 and W = exp(-+2 pi i / 4096)
// (+ for the inverse), each thread keeps 16 complex points in registers
// through three 16-point DFTs (radix 4 x 4 with constant W16 factors):
//
//   pass A  thread t = n0 + 16 n1 loads x[t + 256 m] (m = n2 = 0..15) through
//           the caller's functor; DFT over n2 -> k0; times W^(t k0); stores
//           at word(n0, n1, k0).                                barrier
//   pass B  thread t = n0 + 16 k0 loads n1 = 0..15 from word(n0, n1, k0);
//           DFT over n1 -> k1; times W^(16 n0 k1); stores in place at
//           word(n0, k1, k0).                                   barrier
//   pass C  thread t = k0 + 16 k1 loads n0 = 0..15 from word(n0, k1, k0);
//           DFT over n0 -> k2; hands X[t + 256 k2] (natural order, scaled by
//           1/4096 for the inverse) to the caller's store functor.
//
// The real inverse core, fft4096_real_inverse_row: x = irfft(X) of a
// Hermitian half spectrum X[0..2048] as one 2048-point complex inverse of
// Z[n] = (X[n] + X*[2048-n]) + i (X[n] - X*[2048-n]) w^n, w = exp(+2 pi i/4096)
// (only the real parts of X[0] and X[2048] count, as in the real part of the
// full inverse), whose output divided by 4096 is z[p] = x[2p] + i x[2p+1]:
// half the transform of the complex core and no mirrored bins.  With
// n = n0 + 16 n1 + 128 n2 and q = q0 + 16 q1 + 128 q2 (n1, q1 < 8), 128
// threads a row: pass A, thread t = n0 + 16 n1, builds Z[t + 128 m] from the
// buffer, DFT16 over n2 -> q0, times w^(2 t q0), word2(n0, n1, q0); pass B,
// thread u = n0 + 16 c, two DFT8s over n1 (q0 = 2c, 2c + 1), times
// w^(32 n0 q1), in place; pass C, thread v = q0 + 16 q1, DFT16 over n0 -> q2,
// hands the thread's (x[2p], x[2p+1]), p = v + 128 q2, to the store functor.
//
// Shared memory is touched twice per point (one exchange after pass A, one
// after pass B) instead of the twelve stages of a radix-2 FFT, with two block
// barriers (three in the real core, whose buffer first holds X), and device
// memory is read and written in coalesced warp rows in natural order (no bit
// reversal).
//
// Exchange layout: re and im as two unpadded float planes.  The word of
// (a, b, c) is
//   word(a, b, c)  = 32 ((b >> 1) + 8 c) + ((a ^ c) & 15) + 16 ((b ^ c) & 1)
//   word2(a, b, c) = 32 ((b >> 1) + 4 c) + ((a ^ c) & 15) + 16 ((b ^ (c >> 1)) & 1)
// an XOR swizzle of the bank under which every warp's 32 accesses of one
// instruction fall in 32 distinct banks.  Each pass computes its word with
// the slot a compile-time constant, at most one XOR besides an immediate
// offset (the forms below; the numpy test holds them to the formulas).
//
// Twiddles: one table of 4096 + 256 + 2048 float2, exp(+2 pi i e / 4096)
// computed in double and rounded to float by the wrapper
// (fft4step.twiddles()), laid out in the order the passes read it, so each
// warp's read is one contiguous span through the read-only cache: entry
// t + 256 k0 holds e = t k0 (complex pass A; the real core's pass A reads
// entry 2t + 256 q0), entry 4096 + n0 + 16 k1 holds e = 16 n0 k1 (pass B;
// the real core reads k1 = 2 q1), entry 4352 + n holds e = n (the real
// core's w^n).  The forward transform negates the imaginary part.  No
// twiddle is made by repeated multiplication.
//
// No tensor cores: a DFT-as-matmul in TF32 keeps 10 mantissa bits, far
// outside the 2e-6 * max|X| per row that the kernels are held to; 3xTF32
// would spend ~9 MFLOP per row.  The FFTs run in fp32 on the CUDA cores.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kFftN = 4096;
constexpr int kFftHalf = kFftN / 2;
constexpr int kFftRadix = 16;
static_assert(kThreads * kFftRadix == kFftN, "one row is 256 threads x 16 points");

constexpr int kFftRealThreads = 128;  // threads per row of the real core
constexpr int kTwB = kFftN;  // table entries of the complex core's pass B
constexpr int kTwHalf = kFftN + 256;  // table entries w^n of the real core

// The complex core's exchange buffer: re and im planes, each at word().
struct __align__(16) FftSmem {
  float re[kFftN];
  float im[kFftN];
};

// The real core's buffer: the half spectrum X[0..2048] at words 0..2048,
// then the 2048-point exchange at word2(); padded to whole float4s.
struct __align__(16) FftRealSmem {
  float re[kFftHalf + 4];
  float im[kFftHalf + 4];
};

// cos(2 pi m / 16), for the in-register DFT's constant factors.
__host__ __device__ constexpr float cos16(int m) {
  constexpr float c[16] = {
      1.0f, 0.92387953251128674f, 0.70710678118654752f, 0.38268343236508977f,
      0.0f, -0.38268343236508977f, -0.70710678118654752f, -0.92387953251128674f,
      -1.0f, -0.92387953251128674f, -0.70710678118654752f, -0.38268343236508977f,
      0.0f, 0.38268343236508977f, 0.70710678118654752f, 0.92387953251128674f};
  return c[m % 16];
}

// (xr, xi) *= (wr, wi)
__device__ __forceinline__ void cmul(float& xr, float& xi, float wr, float wi) {
  const float r = xr * wr - xi * wi;
  xi = xr * wi + xi * wr;
  xr = r;
}

// 4-point DFT in place on (a, b, c, d) = x0..x3: a, b, c, d <- X0..X3.
template <bool kInverse>
__device__ __forceinline__ void dft4(float& ar, float& ai, float& br, float& bi, float& cr,
                                     float& ci, float& dr, float& di) {
  const float t0r = ar + cr, t0i = ai + ci, t1r = ar - cr, t1i = ai - ci;
  const float t2r = br + dr, t2i = bi + di, t3r = br - dr, t3i = bi - di;
  // t3 * (+-i): W4 = exp(-+2 pi i / 4)
  const float rr = kInverse ? -t3i : t3i;
  const float ri = kInverse ? t3r : -t3r;
  ar = t0r + t2r;
  ai = t0i + t2i;
  cr = t0r - t2r;
  ci = t0i - t2i;
  br = t1r + rr;
  bi = t1i + ri;
  dr = t1r - rr;
  di = t1i - ri;
}

// (xr, xi) *= W16^M in the transform's direction.
template <bool kInverse, int M>
__device__ __forceinline__ void mul_w16(float& xr, float& xi) {
  if constexpr (M % 16 == 4) {  // +-i, exact
    const float r = kInverse ? -xi : xi;
    xi = kInverse ? xr : -xr;
    xr = r;
  } else if constexpr (M % 16 != 0) {
    constexpr float wr = cos16(M);
    constexpr float wi = cos16(M + 12);  // sin(x) = cos(x - pi/2)
    cmul(xr, xi, wr, kInverse ? wi : -wi);
  }
}

template <bool kInverse, int J>
__device__ __forceinline__ void dft16_column(float (&re)[16], float (&im)[16]) {
  dft4<kInverse>(re[J], im[J], re[J + 4], im[J + 4], re[J + 8], im[J + 8], re[J + 12], im[J + 12]);
  mul_w16<kInverse, J * 1>(re[J + 4], im[J + 4]);
  mul_w16<kInverse, J * 2>(re[J + 8], im[J + 8]);
  mul_w16<kInverse, J * 3>(re[J + 12], im[J + 12]);
}

// 16-point DFT in registers, natural order in and out: X[k] = sum_n x[n]
// W16^(n k).  n = 4 n1 + n2, k = k1 + 4 k2: DFT4 over n1 for each n2, times
// W16^(n2 k1), DFT4 over n2 for each k1; the output permutation is a
// renaming of registers.
template <bool kInverse>
__device__ __forceinline__ void dft16(float (&re)[16], float (&im)[16]) {
  dft16_column<kInverse, 0>(re, im);
  dft16_column<kInverse, 1>(re, im);
  dft16_column<kInverse, 2>(re, im);
  dft16_column<kInverse, 3>(re, im);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
    dft4<kInverse>(re[4 * k1], im[4 * k1], re[4 * k1 + 1], im[4 * k1 + 1], re[4 * k1 + 2],
                   im[4 * k1 + 2], re[4 * k1 + 3], im[4 * k1 + 3]);
  float tr[16], ti[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tr[i] = re[i];
    ti[i] = im[i];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {  // X[k1 + 4 k2] sits at 4 k1 + k2
    re[k] = tr[4 * (k % 4) + k / 4];
    im[k] = ti[4 * (k % 4) + k / 4];
  }
}

// 8-point DFT in registers O..O+7, natural order in and out: DFT4 of the
// even and of the odd points, the odd ones times W16^(2k), one radix-2 step.
template <bool kInverse, int O>
__device__ __forceinline__ void dft8(float (&re)[16], float (&im)[16]) {
  dft4<kInverse>(re[O], im[O], re[O + 2], im[O + 2], re[O + 4], im[O + 4], re[O + 6], im[O + 6]);
  dft4<kInverse>(re[O + 1], im[O + 1], re[O + 3], im[O + 3], re[O + 5], im[O + 5], re[O + 7],
                 im[O + 7]);
  mul_w16<kInverse, 2>(re[O + 3], im[O + 3]);
  mul_w16<kInverse, 4>(re[O + 5], im[O + 5]);
  mul_w16<kInverse, 6>(re[O + 7], im[O + 7]);
  float er[4], ei[4], odr[4], odi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    er[k] = re[O + 2 * k];
    ei[k] = im[O + 2 * k];
    odr[k] = re[O + 2 * k + 1];
    odi[k] = im[O + 2 * k + 1];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[O + k] = er[k] + odr[k];
    im[O + k] = ei[k] + odi[k];
    re[O + k + 4] = er[k] - odr[k];
    im[O + k + 4] = ei[k] - odi[k];
  }
}

template <bool kInverse>
__device__ __forceinline__ float2 fft_twiddle(const float2* __restrict__ table, int entry) {
  float2 w = __ldg(table + entry);
  if (!kInverse) w.y = -w.y;
  return w;
}

// One row of the complex core: ``load(m)`` returns x[threadIdx.x + 256 m] as
// (re, im), m = 0..15;
// ``store(k, re, im)`` receives X[threadIdx.x + 256 k], k = 0..15, scaled by
// 1/4096 for the inverse.  Every thread of the CTA must call it; pass C still
// reads ``s``, so a caller that reuses it must pass a barrier first.
template <bool kInverse, typename Load, typename Store>
__device__ __forceinline__ void fft4096_row(FftSmem& s, const float2* __restrict__ twiddle,
                                            Load load, Store store) {
  const int t = threadIdx.x;
  const int lo = t & 15;
  const int hi = t >> 4;
  float re[16], im[16];

  // pass A: t = n0 + 16 n1 (lo = n0, hi = n1)
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float2 v = load(m);
    re[m] = v.x;
    im[m] = v.y;
  }
  dft16<kInverse>(re, im);
#pragma unroll
  for (int k0 = 1; k0 < 16; ++k0) {
    const float2 w = fft_twiddle<kInverse>(twiddle, t + kThreads * k0);
    cmul(re[k0], im[k0], w.x, w.y);
  }
#pragma unroll
  for (int k0 = 0; k0 < 16; ++k0) {  // word(lo, hi, k0)
    const int a = (t ^ (k0 | (k0 & 1) << 4)) + 256 * k0;
    s.re[a] = re[k0];
    s.im[a] = im[k0];
  }
  __syncthreads();

  // pass B: t = n0 + 16 k0 (lo = n0, hi = k0), in place
  // word(lo, j, hi) = base_b[j & 1] + 32 (j >> 1)
  const int base_b0 = 256 * hi + (((lo ^ hi) & 15) | (hi & 1) << 4);
  const int base_b[2] = {base_b0, base_b0 ^ 16};
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) {
    const int a = base_b[n1 & 1] + 32 * (n1 >> 1);
    re[n1] = s.re[a];
    im[n1] = s.im[a];
  }
  dft16<kInverse>(re, im);
#pragma unroll
  for (int k1 = 1; k1 < 16; ++k1) {
    const float2 w = fft_twiddle<kInverse>(twiddle, kTwB + lo + 16 * k1);
    cmul(re[k1], im[k1], w.x, w.y);
  }
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) {
    const int a = base_b[k1 & 1] + 32 * (k1 >> 1);
    s.re[a] = re[k1];
    s.im[a] = im[k1];
  }
  __syncthreads();

  // pass C: t = k0 + 16 k1 (lo = k0, hi = k1)
  // word(j, hi, lo) = base_c ^ j
  const int base_c = (32 * (hi >> 1) + 256 * lo + 16 * ((hi ^ lo) & 1)) | lo;
#pragma unroll
  for (int n0 = 0; n0 < 16; ++n0) {
    const int a = base_c ^ n0;
    re[n0] = s.re[a];
    im[n0] = s.im[a];
  }
  dft16<kInverse>(re, im);
  const float scale = kInverse ? 1.0f / kFftN : 1.0f;
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) store(k2, re[k2] * scale, im[k2] * scale);
}

// One row of the real inverse core per 128 threads (t = threadIdx.x & 127):
// ``s`` holds the half spectrum X[0..2048] (bin n at word n of each plane),
// complete for all the CTA's rows when every thread calls this (after a
// barrier); ``store(even, odd)`` receives the thread's outputs, x[2p] in
// even[q2] and x[2p + 1] in odd[q2] for p = t + 128 q2, q2 = 0..15.  Every
// thread of the CTA must call it.
template <typename Store>
__device__ __forceinline__ void fft4096_real_inverse_row(FftRealSmem& s,
                                                         const float2* __restrict__ twiddle,
                                                         Store store) {
  const int t = threadIdx.x & (kFftRealThreads - 1);
  const int lo = t & 15;
  const int hi = t >> 4;  // < 8
  float re[16], im[16];

  // pass A input: Z[n] at n = t + 128 m, from X[n] and X[2048 - n]
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = t + kFftRealThreads * m;
    const float ar = s.re[n], br = s.re[kFftHalf - n];
    float ai = s.im[n], bi = -s.im[kFftHalf - n];
    if (m == 0 && t == 0) ai = bi = 0.0f;  // DC and Nyquist: the real parts only
    float dr = ar - br, di = ai - bi;
    const float2 w = __ldg(twiddle + kTwHalf + n);
    cmul(dr, di, w.x, w.y);
    re[m] = ar + br - di;
    im[m] = ai + bi + dr;
  }
  __syncthreads();  // X is read: the buffer becomes the exchange

  // pass A: t = n0 + 16 n1 (lo = n0, hi = n1)
  dft16</*kInverse=*/true>(re, im);
#pragma unroll
  for (int q0 = 1; q0 < 16; ++q0) {
    const float2 w = __ldg(twiddle + 2 * t + kThreads * q0);  // w^(2 t q0)
    cmul(re[q0], im[q0], w.x, w.y);
  }
#pragma unroll
  for (int q0 = 0; q0 < 16; ++q0) {  // word2(lo, hi, q0)
    const int a = (t ^ (q0 | ((q0 >> 1) & 1) << 4)) + 128 * q0;
    s.re[a] = re[q0];
    s.im[a] = im[q0];
  }
  __syncthreads();

  // pass B: u = n0 + 16 c (lo = n0, hi = c); slot j = n1 + 8 e holds q0 = 2c + e;
  // word2(lo, j & 7, 2 hi + (j >> 3)) = (base_e ^ 16 (j & 1)) + 32 ((j & 7) >> 1)
  const int base_e0 = 256 * hi + ((lo ^ (2 * hi)) & 15) + 16 * (hi & 1);
  const int base_e1 = 256 * hi + 128 + ((lo ^ (2 * hi + 1)) & 15) + 16 * (hi & 1);
  const int base_b[4] = {base_e0, base_e0 ^ 16, base_e1, base_e1 ^ 16};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int a = base_b[2 * (j >> 3) + (j & 1)] + 32 * ((j & 7) >> 1);
    re[j] = s.re[a];
    im[j] = s.im[a];
  }
  dft8</*kInverse=*/true, 0>(re, im);
  dft8</*kInverse=*/true, 8>(re, im);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j & 7) {  // w^(32 n0 q1), q1 = j & 7
      const float2 w = __ldg(twiddle + kTwB + lo + 32 * (j & 7));
      cmul(re[j], im[j], w.x, w.y);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int a = base_b[2 * (j >> 3) + (j & 1)] + 32 * ((j & 7) >> 1);
    s.re[a] = re[j];
    s.im[a] = im[j];
  }
  __syncthreads();

  // pass C: v = q0 + 16 q1 (lo = q0, hi = q1); word2(j, hi, lo) = base_c ^ j
  const int base_c = (32 * ((hi >> 1) + 4 * lo) + 16 * ((hi ^ (lo >> 1)) & 1)) | lo;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    re[j] = s.re[base_c ^ j];
    im[j] = s.im[base_c ^ j];
  }
  dft16</*kInverse=*/true>(re, im);
  const float scale = 1.0f / kFftN;
#pragma unroll
  for (int q2 = 0; q2 < 16; ++q2) {
    re[q2] *= scale;
    im[q2] *= scale;
  }
  store(re, im);
}

}  // namespace repro
