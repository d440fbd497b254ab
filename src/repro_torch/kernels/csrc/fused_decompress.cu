// B3: fused dequantize + Hermitian scatter + inverse 4096-point FFT.
//
// Replaces the TPU kernel
// repro/kernels/fused_decompress.py::fused_decompress_pallas (pl.pallas_call
// at l.143): per row, decode the k re/im codes with the row's (eps, P), add
// each kept coefficient into a 4096-bin spectrum (bin i, plus the conjugate
// mirror at 4096 - i for interior bins 1..2047), run an inverse 4096-point
// DFT scaled by 1/4096 and keep the real part.  The TPU kernel builds the
// scatter and the transform out of one-hot and 64x64 DFT matmuls for its
// matrix unit; on this card a shared-memory scatter and a radix-2 FFT do the
// same work with far fewer operations.
//
// Bound on this card: read the payload (2 code planes + the index plane:
// 4 B per slot at uint8 codes and int16 indices, 2.5 KB per row at k = 615)
// and write 4096 floats (16 KB per row): about 4.2 GB at 221,184 rows, so
// about 1.25 ms at 3.35 TB/s.  The FFT's 12 stages of 2048 butterflies
// (about 0.25 MFLOP per row) stay far below the fp32 rate.
//
// Design: one CTA of 256 threads per row.  The spectrum lives in 32 KB of
// shared memory as float2; the scatter uses shared-memory atomics (every
// kept bin is distinct, and padding slots add +0.0, so the sum is exact in
// any order); the transform is an in-place decimation-in-frequency radix-2
// FFT in fp32 with twiddles computed in double and rounded to float (a
// 2048-entry table the wrapper passes in), no tensor cores and no TF32.
// Output order is bit-reversed, undone on the write.  Tolerance against the
// plain version (cuFFT irfft): max abs error <= 2e-6 * max|x| per row.
#include "fft4096.cuh"
#include "range_quant.cuh"

namespace repro {

template <typename CodeT, typename IdxT>
__global__ void __launch_bounds__(kThreads)
fused_decompress_kernel(const CodeT* __restrict__ rec, const CodeT* __restrict__ imc,
                        const IdxT* __restrict__ idx, const float* __restrict__ eps,
                        const float* __restrict__ p_codes, int k, float m_scale,
                        const float2* __restrict__ twiddle, float* __restrict__ out) {
  __shared__ float2 spec[kFftN];
  const size_t row = blockIdx.x;

  for (int i = threadIdx.x; i < kFftN; i += kThreads) spec[i] = make_float2(0.0f, 0.0f);
  __syncthreads();

  const float e = eps[row];
  const float p = p_codes[row];
  const CodeT* rec_row = rec + row * k;
  const CodeT* imc_row = imc + row * k;
  const IdxT* idx_row = idx + row * k;
  for (int s = threadIdx.x; s < k; s += kThreads) {
    const float vr = decode_math(static_cast<float>(rec_row[s]), e, p, m_scale);
    const float vi = decode_math(static_cast<float>(imc_row[s]), e, p, m_scale);
    const int b = static_cast<int>(idx_row[s]);
    if (b < 0 || b > kFftHalf) continue;  // a corrupt index adds nothing (as XLA drops it)
    atomicAdd(&spec[b].x, vr);
    atomicAdd(&spec[b].y, vi);
    if (b >= 1 && b <= kFftHalf - 1) {  // DC and Nyquist are their own mirrors
      atomicAdd(&spec[kFftN - b].x, vr);
      atomicAdd(&spec[kFftN - b].y, -vi);
    }
  }
  __syncthreads();

  fft4096_dif</*kInverse=*/true>(spec, twiddle);

  float* out_row = out + row * kFftN;
  const float scale = 1.0f / kFftN;
  for (int n = threadIdx.x; n < kFftN; n += kThreads) out_row[n] = spec[fft4096_bitrev(n)].x * scale;
}

template <typename CodeT, typename IdxT>
int launch(const void* rec, const void* imc, const void* idx, const float* eps,
           const float* p_codes, int rows, int k, float m_scale, const float2* twiddle,
           float* out, cudaStream_t s) {
  fused_decompress_kernel<CodeT, IdxT><<<rows, kThreads, 0, s>>>(
      static_cast<const CodeT*>(rec), static_cast<const CodeT*>(imc),
      static_cast<const IdxT*>(idx), eps, p_codes, k, m_scale, twiddle, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// code_bytes: 1 (uint8) or 2 (uint16); idx_bytes: 2 (int16) or 4 (int32).
// twiddle: 2048 float2, exp(+2*pi*i*m/4096) for m < 2048.
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
