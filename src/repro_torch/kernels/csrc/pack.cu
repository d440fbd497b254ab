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
// count hold (0.0, 0).  Bound: read the row (4 B per column) and write 8 B
// per slot: at 221,184 rows of 2049 columns and k = 640, about 2.95 GB, so
// about 0.88 ms at 3.35 TB/s.  Design: one CTA of 256 threads per row,
// B2's column map and scan (fused_compress.cu) without the encode, two
// barriers a row:
// 1. Warp w owns the contiguous columns [w*S, (w+1)*S), S = 32*J (J =
//    cols / 256, at most 16); lane l holds w*S + 32j + l (j < J) in
//    registers, one coalesced line per load.  The tail past 8*S (column
//    2048 of 2049) is warp 7's, in rounds of 32.  A ballot per item counts
//    the warp's kept elements; a bit per item remembers the lane's.
// 2. One exclusive scan of the 8 warp counts through shared memory gives
//    each warp its base; a ballot per item then gives each kept element
//    slot = base + kept elements at lower columns of the warp, the plain
//    version's cumsum.  Kept elements with slot < k go to shared memory as
//    (value, column) at their slot (k * 8 B).
// 3. After the second barrier, the k slots go out as 16-byte words of vals
//    and of idx, (0.0, 0) past the count.
// The row is read once (phase 2 reads the tail's columns again, from
// cache) and the values are copied, so the result is bitwise the plain
// version's.
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
#include <type_traits>

#include "common.cuh"

namespace repro {

// J: items per lane in the warps' stretches (cols / 256, at most 16).
// Dynamic shared memory: k floats of values, then k column ints.
template <int J>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, const float* __restrict__ tau, int cols, int k,
            float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float4 smem[];
  __shared__ int warp_kept[kWarps];
  float* s_val = reinterpret_cast<float*>(smem);
  int* s_col = reinterpret_cast<int*>(s_val + k);

  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const float* x_row = x + row * cols;
  const float t = tau[row];
  constexpr int kStretch = 32 * J;
  const int first = warp * kStretch + lane;
  const int tail0 = kWarps * kStretch;  // first tail column
  const bool tail_warp = warp == kWarps - 1;

  // phase 1: the warp's stretch in registers; bit j of keep_bits marks
  // item j kept; the warp's count of kept elements
  constexpr int kItems = J > 0 ? J : 1;  // rows under 256 columns are all tail
  float xv[kItems];
#pragma unroll
  for (int j = 0; j < J; ++j) xv[j] = x_row[first + 32 * j];
  unsigned keep_bits = 0;
  int kept = 0;  // the warp's kept elements so far (the same in every lane)
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool keep = fabsf(xv[j]) >= t;
    keep_bits |= static_cast<unsigned>(keep) << j;
    kept += __popc(__ballot_sync(kFullMask, keep));
  }
  if (tail_warp) {
    for (int col = tail0 + lane; col - lane < cols; col += 32) {
      const bool keep = col < cols && fabsf(x_row[col]) >= t;
      kept += __popc(__ballot_sync(kFullMask, keep));
    }
  }

  // phase 2: one exclusive scan of the warp counts, then the kept elements
  // to their slots in shared memory
  if (lane == 0) warp_kept[warp] = kept;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) {
    const int c = warp_kept[wi];
    base += wi < warp ? c : 0;
    total += c;
  }
  int slot0 = base;  // slot of the warp's next kept element
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool keep = (keep_bits >> j) & 1u;
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    const int slot = slot0 + __popc(ballot & below);
    if (keep && slot < k) {
      s_val[slot] = xv[j];
      s_col[slot] = first + 32 * j;
    }
    slot0 += __popc(ballot);
  }
  if (tail_warp) {
    for (int col = tail0 + lane; col - lane < cols && slot0 < k; col += 32) {
      const float v = col < cols ? x_row[col] : 0.0f;
      const bool keep = col < cols && fabsf(v) >= t;
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      const int slot = slot0 + __popc(ballot & below);
      if (keep && slot < k) {
        s_val[slot] = v;
        s_col[slot] = col;
      }
      slot0 += __popc(ballot);
    }
  }
  __syncthreads();

  // phase 3: the k slots as 16-byte words, (0.0, 0) past the count
  const int filled = min(total, k);
  float4* v_row = reinterpret_cast<float4*>(vals + row * k);
  int4* i_row = reinterpret_cast<int4*>(idx + row * k);
  for (int g = threadIdx.x; g < k / 4; g += kThreads) {
    const int s0 = 4 * g;
    float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int4 c4 = make_int4(0, 0, 0, 0);
    if (s0 < filled) {
      v4 = reinterpret_cast<const float4*>(s_val)[g];
      c4 = reinterpret_cast<const int4*>(s_col)[g];
      v4 = make_float4(v4.x, s0 + 1 < filled ? v4.y : 0.0f, s0 + 2 < filled ? v4.z : 0.0f,
                       s0 + 3 < filled ? v4.w : 0.0f);
      c4 = make_int4(c4.x, s0 + 1 < filled ? c4.y : 0, s0 + 2 < filled ? c4.z : 0,
                     s0 + 3 < filled ? c4.w : 0);
    }
    v_row[g] = v4;
    i_row[g] = c4;
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

// Calls ``launch(std::integral_constant<int, J>{})`` for J = min(items, 16):
// rows wider than 4096 columns leave the rest to warp 7's tail.
template <int J = 0, typename Launch>
int dispatch_stretch(int items, Launch&& launch) {
  if constexpr (J < kMaxItems) {
    if (items > J) return dispatch_stretch<J + 1>(items, launch);
  }
  return launch(std::integral_constant<int, J>{});
}

}  // namespace repro

// k is a multiple of 4 (the wrapper's K_TILE of 128).
REPRO_EXPORT int pack(const float* x, const float* tau, int rows, int cols, int k, float* vals,
                      int* idx, void* stream) {
  using namespace repro;
  return dispatch_stretch(cols / kThreads, [&](auto j) -> int {
    auto kernel = pack_kernel<decltype(j)::value>;
    const int smem = k * 2 * static_cast<int>(sizeof(float));
    if (k % 4 || smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, tau, cols, k, vals,
                                                                        idx);
    return static_cast<int>(cudaGetLastError());
  });
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
