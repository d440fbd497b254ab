// B3: fused dequantize + Hermitian scatter + inverse 4096-point FFT.
//
// Replaces the TPU kernel
// repro/kernels/fused_decompress.py::fused_decompress_pallas (pl.pallas_call
// at l.143): per row, decode the k re/im codes with the row's (eps, P), add
// each kept coefficient into a 4096-bin spectrum (bin i, plus the conjugate
// mirror at 4096 - i for interior bins 1..2047), run an inverse 4096-point
// DFT scaled by 1/4096 and keep the real part.  The TPU kernel builds the
// scatter and the transform out of one-hot and 64x64 DFT matmuls for its
// matrix unit; on this card a shared-memory scatter and an FFT on the CUDA
// cores do the same work with far fewer operations.
//
// Bound on this card: read the payload (2 code planes + the index plane:
// 4 B per slot at uint8 codes and int16 indices, 2.5 KB per row at k = 615)
// and write 4096 floats (16 KB per row): about 4.2 GB at 221,184 rows, so
// about 1.25 ms at 3.35 TB/s.  The transform (a 2048-point complex inverse,
// about 0.12 MFLOP per row) stays below it.
//
// Design: one CTA of 256 threads runs two rows, 128 threads each.  A row's
// half spectrum X[0..2048] is built, zeroed, in the 16 KB buffer of
// fft4096.cuh's real inverse core: 8-bit codes decode through a 256-entry
// table of the row's decode_math values (bitwise the same), 16-bit codes
// call decode_math; the first five slots of each thread are loaded before the
// zeroing so their latency hides behind it; shared-memory atomics add each
// kept coefficient at its bin, with no mirror (every kept bin is distinct and
// padding slots add +0.0, so the sum is exact in any order; an index outside
// [0, 2048] adds nothing).  The core then computes x = irfft(X) as one
// 2048-point complex inverse with the row in registers (half the transform
// of B7's core), and writes x in natural order as float2 pairs.
// Registers (ptxas): 64 a thread for 8-bit codes, __launch_bounds__(256, 4),
// so 4 CTAs (32 warps) share an SM; 80 for 16-bit codes, (256, 3); no spill
// (chip_smoke.py prints and checks the counts).  No tensor
// cores: TF32's 10 mantissa bits cannot hold the tolerance (fft4096.cuh).  Tolerance against
// the plain version (cuFFT irfft): max abs error <= 2e-6 * max|x| per row.
#include "fft4096.cuh"
#include "range_quant.cuh"

namespace repro {

// CTAs per SM that the register budget must allow: 8-bit codes (table
// decode) fit 64 registers a thread; 16-bit codes, which run decode_math per
// slot, take 80
__host__ __device__ constexpr int min_ctas(int code_bytes) { return code_bytes == 1 ? 4 : 3; }
constexpr int kRowsPerCta = kThreads / kFftRealThreads;
constexpr int kPrefetch = 5;  // payload slots per thread loaded ahead of the zeroing (k <= 640)

template <typename CodeT, typename IdxT>
__global__ void __launch_bounds__(kThreads, min_ctas(sizeof(CodeT)))
fused_decompress_kernel(const CodeT* __restrict__ rec, const CodeT* __restrict__ imc,
                        const IdxT* __restrict__ idx, const float* __restrict__ eps,
                        const float* __restrict__ p_codes, int rows, int k, float m_scale,
                        const float2* __restrict__ twiddle, float* __restrict__ out) {
  constexpr bool kTable = sizeof(CodeT) == 1;
  __shared__ FftRealSmem spectra[kRowsPerCta];
  __shared__ float tables[kRowsPerCta][256];
  const int h = threadIdx.x / kFftRealThreads;
  const int t = threadIdx.x % kFftRealThreads;
  // a 32-bit row keeps one register live to the end (rows < 2^31)
  const int row = static_cast<int>(blockIdx.x) * kRowsPerCta + h;
  const bool live = row < rows;  // an odd last row leaves a half idle
  FftRealSmem& s = spectra[h];
  float* table = tables[h];

  float e = 0.0f, p = 0.0f;
  if (live) {
    e = eps[row];
    p = p_codes[row];
  }
  const size_t slot0 = static_cast<size_t>(row) * k;
  const CodeT* rec_row = rec + slot0;
  const CodeT* imc_row = imc + slot0;
  const IdxT* idx_row = idx + slot0;
  uint32_t pre_codes[kPrefetch];  // re code | im code << 16
  int pre_bin[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    const int j = t + kFftRealThreads * i;
    const bool slot = live && j < k;
    pre_codes[i] = slot ? rec_row[j] | static_cast<uint32_t>(imc_row[j]) << 16 : 0u;
    pre_bin[i] = slot ? static_cast<int>(idx_row[j]) : -1;
  }

  float4* zero = reinterpret_cast<float4*>(&s);
  for (int i = t; i < static_cast<int>(sizeof(FftRealSmem) / sizeof(float4));
       i += kFftRealThreads)
    zero[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kTable) {
#pragma unroll
    for (int c = t; c < 256; c += kFftRealThreads)
      table[c] = decode_math(static_cast<float>(c), e, p, m_scale);
  }
  __syncthreads();

  const auto decode = [&](CodeT c) {
    if constexpr (kTable) return table[c];
    else return decode_math(static_cast<float>(c), e, p, m_scale);
  };
  const auto scatter = [&](CodeT code_re, CodeT code_im, int b) {
    if (b < 0 || b > kFftHalf) return;  // a corrupt index adds nothing (as XLA drops it)
    atomicAdd(&s.re[b], decode(code_re));
    atomicAdd(&s.im[b], decode(code_im));
  };
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i)
    scatter(static_cast<CodeT>(pre_codes[i]), static_cast<CodeT>(pre_codes[i] >> 16), pre_bin[i]);
  if (live) {
    for (int j = t + kFftRealThreads * kPrefetch; j < k; j += kFftRealThreads)
      scatter(rec_row[j], imc_row[j], static_cast<int>(idx_row[j]));
  }
  __syncthreads();

  fft4096_real_inverse_row(s, twiddle, [&](const float(&even)[16], const float(&odd)[16]) {
    // The row is read again from %ctaid (volatile, so not kept from above):
    // no register holds it through the transform, whose pass A needs all 64.
    unsigned cta;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
    const int r = static_cast<int>(cta) * kRowsPerCta + h;
    if (r >= rows) return;
    float2* x = reinterpret_cast<float2*>(out + static_cast<size_t>(r) * kFftN) + t;
#pragma unroll
    for (int q2 = 0; q2 < 16; ++q2) x[kFftRealThreads * q2] = make_float2(even[q2], odd[q2]);
  });
}

template <typename CodeT, typename IdxT>
int launch(const void* rec, const void* imc, const void* idx, const float* eps,
           const float* p_codes, int rows, int k, float m_scale, const float2* twiddle,
           float* out, cudaStream_t s) {
  const int ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  fused_decompress_kernel<CodeT, IdxT><<<ctas, kThreads, 0, s>>>(
      static_cast<const CodeT*>(rec), static_cast<const CodeT*>(imc),
      static_cast<const IdxT*>(idx), eps, p_codes, rows, k, m_scale, twiddle, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// code_bytes: 1 (uint8) or 2 (uint16); idx_bytes: 2 (int16) or 4 (int32).
// twiddle: the 4096 + 256 + 2048 float2 of fft4step.twiddles() (layout in
// fft4096.cuh).
REPRO_EXPORT int fused_decompress(const void* rec, const void* imc, const void* idx,
                                  const float* eps, const float* p_codes, int rows, int k,
                                  float m_scale, int code_bytes, int idx_bytes,
                                  const void* twiddle, float* out, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* tw = static_cast<const float2*>(twiddle);
  if (code_bytes == 1 && idx_bytes == 2)
    return launch<uint8_t, int16_t>(rec, imc, idx, eps, p_codes, rows, k, m_scale, tw, out, s);
  if (code_bytes == 1 && idx_bytes == 4)
    return launch<uint8_t, int32_t>(rec, imc, idx, eps, p_codes, rows, k, m_scale, tw, out, s);
  if (code_bytes == 2 && idx_bytes == 2)
    return launch<uint16_t, int16_t>(rec, imc, idx, eps, p_codes, rows, k, m_scale, tw, out, s);
  if (code_bytes == 2 && idx_bytes == 4)
    return launch<uint16_t, int32_t>(rec, imc, idx, eps, p_codes, rows, k, m_scale, tw, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
