// B5: range-quant encode (f32 -> N-bit codes) and decode (codes -> f32).
//
// Replaces the TPU kernels repro/kernels/range_quant.py::encode_pallas
// (pl.pallas_call at l.151) and ::decode_pallas (l.187): an elementwise
// pass with one quantizer fit (eps, P, n_neg) per row -- a scalar fit is
// expanded to every row by the wrapper.  The arithmetic is the
// ``__device__`` encode_math / decode_math of range_quant.cuh, which B2 and
// B3 run in registers, op for op the plain version's, so codes and values
// are bitwise equal to it.
//
// Bound on this card: bytes.  Encode reads 4 B and writes 1 B (uint8 codes)
// per value, decode the reverse: at the ops path's 221,184 rows of 640 slots
// about 0.71 GB, so about 0.21 ms at 3.35 TB/s.  The per-value log/exp
// arithmetic (about 30 operations) stays below that at the fp32 rate.
//
// Design: one CTA of 256 threads per row (the row's fit loaded once),
// threads striding over the row's columns, so loads and stores coalesce.
#include "range_quant.cuh"

namespace repro {

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
rq_encode_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                 const float* __restrict__ p_codes, const float* __restrict__ n_neg, int cols,
                 float m_scale, CodeT* __restrict__ codes) {
  const size_t row = blockIdx.x;
  const float e = eps[row];
  const float p = p_codes[row];
  const float nn = n_neg[row];
  const float* x_row = x + row * cols;
  CodeT* c_row = codes + row * cols;
  for (int c = threadIdx.x; c < cols; c += kThreads)
    c_row[c] = static_cast<CodeT>(encode_math(x_row[c], e, p, nn, m_scale));
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
rq_decode_kernel(const CodeT* __restrict__ codes, const float* __restrict__ eps,
                 const float* __restrict__ p_codes, int cols, float m_scale,
                 float* __restrict__ out) {
  const size_t row = blockIdx.x;
  const float e = eps[row];
  const float p = p_codes[row];
  const CodeT* c_row = codes + row * cols;
  float* o_row = out + row * cols;
  for (int c = threadIdx.x; c < cols; c += kThreads)
    o_row[c] = decode_math(static_cast<float>(c_row[c]), e, p, m_scale);
}

}  // namespace repro

// code_bytes is 1 (uint8 codes, n_bits <= 8) or 2 (uint16).  eps, p_codes
// and n_neg are float32 (rows,) vectors.
REPRO_EXPORT int range_quant_encode(const float* x, const float* eps, const float* p_codes,
                                    const float* n_neg, int rows, int cols, float m_scale,
                                    int code_bytes, void* codes, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    rq_encode_kernel<uint8_t><<<rows, kThreads, 0, s>>>(x, eps, p_codes, n_neg, cols, m_scale,
                                                        static_cast<uint8_t*>(codes));
  else if (code_bytes == 2)
    rq_encode_kernel<uint16_t><<<rows, kThreads, 0, s>>>(x, eps, p_codes, n_neg, cols, m_scale,
                                                         static_cast<uint16_t*>(codes));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int range_quant_decode(const void* codes, const float* eps, const float* p_codes,
                                    int rows, int cols, float m_scale, int code_bytes,
                                    float* out, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    rq_decode_kernel<uint8_t><<<rows, kThreads, 0, s>>>(static_cast<const uint8_t*>(codes), eps,
                                                        p_codes, cols, m_scale, out);
  else if (code_bytes == 2)
    rq_decode_kernel<uint16_t><<<rows, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(codes), eps, p_codes, cols, m_scale, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
