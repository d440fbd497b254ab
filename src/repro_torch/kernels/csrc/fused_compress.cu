// B2: fused threshold + pack + quantize of rfft spectrum rows.
//
// Replaces the TPU kernel repro/kernels/fused_compress.py::fused_compress_pallas
// (pl.pallas_call at l.168): per row, the Hermitian-weighted magnitude
// sqrt(re^2 + im^2) * w, the mask mag >= tau (the caller's per-row tau: the
// threshold kernel's, moved to mid-gap), index-ascending compaction of the
// kept bins into k_pad = ceil128(k) slots, and range-quant encode of re and
// im with the row's (eps, P, n_neg).  Slots never filled hold code 0 at
// index 0, as in the reference.
//
// Bound on this card: read re and im once (8 B per bin) and write the
// payload (2 code planes + int32 index: 6 B per slot, 3.75 KB per row at
// k_pad = 640): about 4.4 GB at 221,184 rows of 2049, so about 1.3 ms at
// 3.35 TB/s.  The TPU kernel compacts with a one-hot contraction because a
// TPU has no cheap scatter; here a scatter is cheap.
//
// Design: one CTA of 256 threads per row; the row's re/im/mag stay in
// registers.  Compaction walks the row in rounds of 256 columns: a warp
// ballot gives each thread its rank inside the warp, the 8 warp counts go
// through shared memory, and a running base carries the count of earlier
// rounds, so slot = number of kept bins at lower columns.  Each kept bin
// writes its codes and column straight to its slot; the unfilled tail is
// zeroed once the total is known.  The magnitude and the quantizer run
// with explicit round-to-nearest intrinsics, so codes and indices are
// bitwise equal to the plain version.
#include "range_quant.cuh"

namespace repro {

template <int ITEMS, typename CodeT>
__global__ void __launch_bounds__(kThreads)
fused_compress_kernel(const float* __restrict__ re, const float* __restrict__ im,
                      const float* __restrict__ w, const float* __restrict__ tau_in,
                      const float* __restrict__ eps, const float* __restrict__ p_codes,
                      const float* __restrict__ n_neg, int cols, int k_pad, float m_scale,
                      CodeT* __restrict__ rec, CodeT* __restrict__ imc,
                      int* __restrict__ idx) {
  __shared__ int warp_kept[kWarps];
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* re_row = re + row * cols;
  const float* im_row = im + row * cols;

  float vre[ITEMS], vim[ITEMS], vmag[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int col = j * kThreads + threadIdx.x;
    if (col < cols) {
      vre[j] = re_row[col];
      vim[j] = im_row[col];
      const float sq = __fadd_rn(__fmul_rn(vre[j], vre[j]), __fmul_rn(vim[j], vim[j]));
      vmag[j] = __fmul_rn(sqrtf(sq), w[col]);
    } else {
      vre[j] = 0.0f;
      vim[j] = 0.0f;
      vmag[j] = -INFINITY;
    }
  }

  const float tau = tau_in[row];
  const float e = eps[row];
  const float p = p_codes[row];
  const float nn = n_neg[row];
  CodeT* rec_row = rec + row * k_pad;
  CodeT* imc_row = imc + row * k_pad;
  int* idx_row = idx + row * k_pad;

  int base = 0;  // kept bins in earlier rounds
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int col = j * kThreads + threadIdx.x;
    const bool keep = col < cols && vmag[j] >= tau;
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_total = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const int c = warp_kept[wi];
      before += wi < warp ? c : 0;
      round_total += c;
    }
    __syncthreads();
    const int slot = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (keep && slot < k_pad) {
      rec_row[slot] = static_cast<CodeT>(encode_math(vre[j], e, p, nn, m_scale));
      imc_row[slot] = static_cast<CodeT>(encode_math(vim[j], e, p, nn, m_scale));
      idx_row[slot] = col;
    }
    base += round_total;
  }
  for (int s = base + threadIdx.x; s < k_pad; s += kThreads) {
    rec_row[s] = CodeT(0);
    imc_row[s] = CodeT(0);
    idx_row[s] = 0;
  }
}

template <typename CodeT>
int launch(const float* re, const float* im, const float* w, const float* tau_in,
           const float* eps, const float* p_codes, const float* n_neg, int rows, int cols,
           int k_pad, float m_scale, void* rec, void* imc, int* idx, cudaStream_t s) {
  const int items = (cols + kThreads - 1) / kThreads;
  REPRO_DISPATCH_ITEMS(items, fused_compress_kernel<ITEMS, CodeT><<<rows, kThreads, 0, s>>>(
                                  re, im, w, tau_in, eps, p_codes, n_neg, cols, k_pad, m_scale,
                                  static_cast<CodeT*>(rec), static_cast<CodeT*>(imc), idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// code_bytes is 1 (uint8 codes, n_bits <= 8) or 2 (uint16).
REPRO_EXPORT int fused_compress(const float* re, const float* im, const float* w,
                                const float* tau_in, const float* eps, const float* p_codes,
                                const float* n_neg, int rows, int cols, int k_pad, float m_scale,
                                int code_bytes, void* rec, void* imc, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<uint8_t>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols, k_pad,
                                  m_scale, rec, imc, idx, s);
  if (code_bytes == 2)
    return repro::launch<uint16_t>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols, k_pad,
                                   m_scale, rec, imc, idx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
