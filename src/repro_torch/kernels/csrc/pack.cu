// B6: sparse pack (compact |x| >= tau) and unpack (additive scatter to dense).
//
// Replaces the TPU kernels repro/kernels/pack.py::pack_pallas
// (pl.pallas_call at l.73) and ::unpack_pallas (l.120).  The TPU kernels
// build both out of one-hot contractions, (rows, cols, 128) slabs summed on
// the matrix unit, because a TPU has no cheap scatter; this card scatters
// directly, so neither kernel does more than read its input and write its
// output once.
//
// pack: per row, the elements with |x| >= tau in index order go to slots
// 0, 1, ... of a k-wide (vals f32, idx i32) pair; a count beyond k is cut
// at k (the one-hot sum keeps slot positions < k only), and slots past the
// count hold (0.0, 0).  Design: one CTA of 256 threads per row walks the
// row in rounds of 256 columns, as B2 does: a warp ballot ranks each kept
// element inside its warp, the 8 warp counts go through shared memory, and
// a running base carries the earlier rounds' count; the walk stops once k
// slots are filled.  The values are copied, so the result is bitwise the
// plain version's.  Bound: read the row (4 B per column) and write 8 B per
// slot: at 221,184 rows of 2049 columns and k = 640, about 2.95 GB, so
// about 0.88 ms at 3.35 TB/s.
//
// unpack: dense[r, idx[r, j]] += vals[r, j] for every slot j of a (rows, k)
// pair, into a (rows, cols) zero plane; indices outside [0, cols) add
// nothing.  Design: one CTA per row zeroes the row in shared memory (cols
// floats, dynamic), adds every slot with shared-memory atomics, and writes
// the row out once, coalesced.  The sum is exact in any order while every
// column receives at most one nonzero value (kept sets are distinct
// indices; padding slots add 0.0 at index 0).  Bound: read 8 B per slot and
// write 4 B per column: at 221,184 rows, k = 640 and 2560 columns, about
// 3.40 GB, so about 1.01 ms.
#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, const float* __restrict__ tau, int cols, int k,
            float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ int warp_kept[kWarps];
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* x_row = x + row * cols;
  float* v_row = vals + row * k;
  int* i_row = idx + row * k;
  const float t = tau[row];

  int base = 0;  // kept elements in earlier rounds; the same in every thread
  for (int c0 = 0; c0 < cols && base < k; c0 += kThreads) {
    const int col = c0 + threadIdx.x;
    const float v = col < cols ? x_row[col] : 0.0f;
    const bool keep = col < cols && fabsf(v) >= t;
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
    if (keep && slot < k) {
      v_row[slot] = v;
      i_row[slot] = col;
    }
    base += round_total;
  }
  for (int s = min(base, k) + threadIdx.x; s < k; s += kThreads) {
    v_row[s] = 0.0f;
    i_row[s] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const float* __restrict__ vals, const int* __restrict__ idx, int k, int cols,
              float* __restrict__ dense) {
  extern __shared__ float dense_row[];
  const size_t row = blockIdx.x;
  for (int c = threadIdx.x; c < cols; c += kThreads) dense_row[c] = 0.0f;
  __syncthreads();
  const float* v_row = vals + row * k;
  const int* i_row = idx + row * k;
  for (int s = threadIdx.x; s < k; s += kThreads) {
    const int c = i_row[s];
    if (c >= 0 && c < cols) atomicAdd(&dense_row[c], v_row[s]);
  }
  __syncthreads();
  float* out_row = dense + row * static_cast<size_t>(cols);
  for (int c = threadIdx.x; c < cols; c += kThreads) out_row[c] = dense_row[c];
}

constexpr int kMaxSharedBytes = 232448;  // what one block may use on sm_90

}  // namespace repro

REPRO_EXPORT int pack(const float* x, const float* tau, int rows, int cols, int k, float* vals,
                      int* idx, void* stream) {
  using namespace repro;
  pack_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, tau, cols, k, vals,
                                                                        idx);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int unpack(const float* vals, const int* idx, int rows, int k, int cols,
                        float* dense, void* stream) {
  using namespace repro;
  const int smem = cols * static_cast<int>(sizeof(float));
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unpack_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(vals, idx, k, cols,
                                                                             dense);
  return static_cast<int>(cudaGetLastError());
}
