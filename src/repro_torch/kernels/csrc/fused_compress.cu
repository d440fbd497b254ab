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
// 3.35 TB/s.  The encode (two logf, one expf, two IEEE divisions: ~100
// instructions a value) is the largest instruction cost.  The TPU kernel
// compacts with a one-hot contraction because a TPU has no cheap scatter;
// here a scatter into shared memory is cheap.
//
// Design: one CTA of 256 threads per row, in three phases with two barriers.
// 1. Warp w owns the contiguous columns [w*S, (w+1)*S), S = 32*J; lane l
//    holds columns w*S + 32j + l (j < J) in registers, so every load is one
//    coalesced line.  Columns past 8*S (2048 of 2049, 1024 of 1025) are the
//    tail, which warp 7, whose columns are the highest, takes in rounds of
//    32.  A ballot per item counts the warp's kept bins; a bit per item
//    remembers which of the lane's bins are kept.  Nothing leaves the warp.
// 2. One exclusive scan of the 8 warp counts through shared memory gives
//    each warp its base; the warp then walks its items again, and a ballot
//    per item gives each kept bin slot = base + kept bins at lower columns
//    of the warp: the number of kept bins at lower columns of the row, as
//    the plain version's cumsum.  Each kept bin with slot < k_pad writes
//    (re, im, column) to shared memory at its slot.
// 3. After the second barrier every thread encodes 4 consecutive slots with
//    converged lanes (the row's quantizer constants computed once) and
//    writes them as one 4- or 8-byte word per plane and one 16-byte index
//    word; slots past the kept count get code 0 at index 0 in the same pass.
// The magnitude and the quantizer run with explicit round-to-nearest
// intrinsics, so codes and indices are bitwise equal to the plain version.
// tests/test_torch_compress_threshold_design.py walks phases 1 and 2 in
// numpy; the two change together.
//
// With no tau (the reference's tau=None: fused_compress.py l.64-71), a
// separate instantiation (kBisect) bisects each row for k_keep itself
// before phase 1: every thread writes the weighted magnitudes of its columns
// to shared memory (the slot buffers, free until phase 2; -inf past the
// row), and after a barrier warp 0 runs B1's row routine (threshold.cuh
// bisect_row, NaN and +inf rows and the fixed-point stop included) on the
// staged row, lane l reading columns l + 32 j, so tau is B1's on the same
// magnitudes.  A second barrier hands tau to the CTA, and phases 1-3 run
// unchanged.  Its parameters follow the tau-given kernel's, so that
// instantiation's code is unchanged.
#include "range_quant.cuh"
#include "threshold.cuh"

namespace repro {

constexpr int kSlotGroup = 4;  // slots a thread encodes and stores at once

// kSlotGroup float-carried codes as one store word, each converted to CodeT
// as a single code store would convert it
template <typename CodeT> struct CodeWord;
template <> struct CodeWord<uint8_t> {
  using type = uint32_t;
  __device__ static uint32_t code(float c) { return static_cast<uint8_t>(c); }
  __device__ static type pack(const float (&c)[kSlotGroup]) {
    return code(c[0]) | (code(c[1]) << 8) | (code(c[2]) << 16) | (code(c[3]) << 24);
  }
};
template <> struct CodeWord<uint16_t> {
  using type = uint2;
  __device__ static uint32_t code(float c) { return static_cast<uint16_t>(c); }
  __device__ static type pack(const float (&c)[kSlotGroup]) {
    return make_uint2(code(c[0]) | (code(c[1]) << 16), code(c[2]) | (code(c[3]) << 16));
  }
};

// Hermitian-weighted magnitude, as the plain version rounds it.
__device__ __forceinline__ float weighted_mag(float re, float im, float w) {
  return __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))), w);
}

// Items per lane of the bisecting warp at J: cols < 256 (J + 1) gives at
// most 8 J + 8; rows are at most 4096 wide.
__host__ __device__ constexpr int bisect_items(int j) {
  return j < kMaxItems ? 8 * j + 8 : 8 * kMaxItems;
}

// The bisecting warp's view of a row staged in shared memory: item j of
// lane l is column l + 32 j.
struct StagedRow {
  const float* lane_col;  // the row's column l
  __device__ float operator[](int j) const { return lane_col[32 * j]; }
};

// J: items per lane in the warps' stretches (cols / 256, 0..16).  Dynamic
// shared memory: k_pad floats of re, k_pad of im, k_pad column ints (with
// kBisect at least 32 * bisect_items(J) floats, the staged row).  The
// CTAs per SM are stated: 6 (40 registers) up to 2303 columns, which the
// load of the quantizer params after the first barrier makes room for, and
// 3 above; left to itself, ptxas picks 48 or 64 registers for the wider
// rows and spills.  The bisecting instantiations are held to 5 up to 2303
// columns (48 registers; at 6, ptxas spills).
template <int J, typename CodeT, bool kBisect>
__global__ void __launch_bounds__(kThreads, J > 8 ? 3 : kBisect ? 5 : 6)
fused_compress_kernel(const float* __restrict__ re, const float* __restrict__ im,
                      const float* __restrict__ w, const float* __restrict__ tau_in,
                      const float* __restrict__ eps, const float* __restrict__ p_codes,
                      const float* __restrict__ n_neg, int cols, int k_pad, float m_scale,
                      CodeT* __restrict__ rec, CodeT* __restrict__ imc,
                      int* __restrict__ idx, int k_keep, int iters,
                      float* __restrict__ tau_out) {
  extern __shared__ float4 smem[];
  __shared__ int warp_kept[kWarps];
  float* s_re = reinterpret_cast<float*>(smem);
  float* s_im = s_re + k_pad;
  int* s_col = reinterpret_cast<int*>(s_im + k_pad);

  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const float* re_row = re + row * cols;
  const float* im_row = im + row * cols;
  float tau;
  if constexpr (kBisect) {
    __shared__ float s_cand[kCompactAt];
    __shared__ float s_tau;
    constexpr int kN = bisect_items(J);
    for (int col = threadIdx.x; col < 32 * kN; col += kThreads)
      s_re[col] = col < cols ? weighted_mag(re_row[col], im_row[col], w[col]) : -INFINITY;
    __syncthreads();
    if (warp == 0) {
      float t;
      int count;
      bisect_row<kN>(StagedRow{s_re + lane}, k_keep, iters, s_cand, t, count);
      if (lane == 0) {
        s_tau = t;
        tau_out[row] = t;
      }
    }
    __syncthreads();
    tau = s_tau;
  } else {
    tau = tau_in[row];
  }
  constexpr int kStretch = 32 * J;
  const int first = warp * kStretch + lane;
  const int tail0 = kWarps * kStretch;  // first tail column
  const bool tail_warp = warp == kWarps - 1;

  // phase 1: the warp's stretch in registers; bit j of keep_bits marks
  // item j kept; the warp's count of kept bins
  constexpr int kItems = J > 0 ? J : 1;  // rows under 256 columns are all tail
  float vre[kItems], vim[kItems];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    vre[j] = re_row[first + 32 * j];
    vim[j] = im_row[first + 32 * j];
  }
  unsigned keep_bits = 0;
  int kept = 0;  // the warp's kept bins so far (the same in every lane)
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool keep = weighted_mag(vre[j], vim[j], w[first + 32 * j]) >= tau;
    keep_bits |= static_cast<unsigned>(keep) << j;
    kept += __popc(__ballot_sync(kFullMask, keep));
  }
  if (tail_warp) {
    for (int col = tail0 + lane; col - lane < cols; col += 32) {
      const bool keep = col < cols && weighted_mag(re_row[col], im_row[col], w[col]) >= tau;
      kept += __popc(__ballot_sync(kFullMask, keep));
    }
  }

  // phase 2: one exclusive scan of the warp counts, then the kept bins to
  // their slots in shared memory
  if (lane == 0) warp_kept[warp] = kept;
  __syncthreads();
  const float e = eps[row], p = p_codes[row], nn = n_neg[row];  // for phase 3
  int base = 0, total = 0;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) {
    const int c = warp_kept[wi];
    base += wi < warp ? c : 0;
    total += c;
  }
  int slot0 = base;  // slot of the warp's next kept bin
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool keep = (keep_bits >> j) & 1u;
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    const int slot = slot0 + __popc(ballot & below);
    if (keep && slot < k_pad) {
      s_re[slot] = vre[j];
      s_im[slot] = vim[j];
      s_col[slot] = first + 32 * j;
    }
    slot0 += __popc(ballot);
  }
  if (tail_warp) {
    for (int col = tail0 + lane; col - lane < cols && slot0 < k_pad; col += 32) {
      float t_re = 0.0f, t_im = 0.0f;
      bool keep = false;
      if (col < cols) {
        t_re = re_row[col];
        t_im = im_row[col];
        keep = weighted_mag(t_re, t_im, w[col]) >= tau;
      }
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      const int slot = slot0 + __popc(ballot & below);
      if (keep && slot < k_pad) {
        s_re[slot] = t_re;
        s_im[slot] = t_im;
        s_col[slot] = col;
      }
      slot0 += __popc(ballot);
    }
  }
  __syncthreads();

  // phase 3: dense encode of the filled slots, wide stores, zero tail
  const int filled = min(total, k_pad);
  const EncodeRow q = encode_row(e, p, nn);
  using Word = typename CodeWord<CodeT>::type;
  Word* rec_row = reinterpret_cast<Word*>(rec + row * k_pad);
  Word* imc_row = reinterpret_cast<Word*>(imc + row * k_pad);
  int4* idx_row = reinterpret_cast<int4*>(idx + row * k_pad);
  for (int g = threadIdx.x; g < k_pad / kSlotGroup; g += kThreads) {
    const int s0 = g * kSlotGroup;
    float c_re[kSlotGroup] = {}, c_im[kSlotGroup] = {};
    int4 cols4 = make_int4(0, 0, 0, 0);
    if (s0 < filled) {
      const float4 r4 = reinterpret_cast<const float4*>(s_re)[g];
      const float4 i4 = reinterpret_cast<const float4*>(s_im)[g];
      const int4 k4 = reinterpret_cast<const int4*>(s_col)[g];
      const float r[kSlotGroup] = {r4.x, r4.y, r4.z, r4.w};
      const float i[kSlotGroup] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
      for (int u = 0; u < kSlotGroup; ++u) {
        if (s0 + u < filled) {
          c_re[u] = encode_value(r[u], q, m_scale);
          c_im[u] = encode_value(i[u], q, m_scale);
        }
      }
      cols4 = make_int4(k4.x, s0 + 1 < filled ? k4.y : 0, s0 + 2 < filled ? k4.z : 0,
                        s0 + 3 < filled ? k4.w : 0);
    }
    rec_row[g] = CodeWord<CodeT>::pack(c_re);
    imc_row[g] = CodeWord<CodeT>::pack(c_im);
    idx_row[g] = cols4;
  }
}

// Launches the instantiation with J = cols / 256 items per lane (0..16;
// rows up to 4096 wide); with kBisect, the one that bisects for k_keep and
// writes its tau to tau_out.
template <typename CodeT, bool kBisect, int J = 0>
int launch(const float* re, const float* im, const float* w, const float* tau_in,
           const float* eps, const float* p_codes, const float* n_neg, int rows, int cols,
           int k_pad, float m_scale, void* rec, void* imc, int* idx, int k_keep, int iters,
           float* tau_out, cudaStream_t s) {
  if constexpr (J < kMaxItems) {
    if (cols / kThreads != J)
      return launch<CodeT, kBisect, J + 1>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols,
                                           k_pad, m_scale, rec, imc, idx, k_keep, iters,
                                           tau_out, s);
  }
  if (cols < 1 || cols > kThreads * kMaxItems || k_pad % (32 * kSlotGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_compress_kernel<J, CodeT, kBisect>;
  size_t smem = static_cast<size_t>(k_pad) * 3 * sizeof(float);
  const size_t staged = kBisect ? 32 * bisect_items(J) * sizeof(float) : 0;
  if (staged > smem) smem = staged;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<rows, kThreads, smem, s>>>(re, im, w, tau_in, eps, p_codes, n_neg, cols, k_pad,
                                      m_scale, static_cast<CodeT*>(rec),
                                      static_cast<CodeT*>(imc), idx, k_keep, iters, tau_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// code_bytes is 1 (uint8 codes, n_bits <= 8) or 2 (uint16); k_pad is a
// multiple of 128.
REPRO_EXPORT int fused_compress(const float* re, const float* im, const float* w,
                                const float* tau_in, const float* eps, const float* p_codes,
                                const float* n_neg, int rows, int cols, int k_pad, float m_scale,
                                int code_bytes, void* rec, void* imc, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<uint8_t, false>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols,
                                         k_pad, m_scale, rec, imc, idx, 0, 0, nullptr, s);
  if (code_bytes == 2)
    return repro::launch<uint16_t, false>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols,
                                          k_pad, m_scale, rec, imc, idx, 0, 0, nullptr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with no tau: each row bisected for k_keep in ``iters`` sweeps
// (B1's routine); tau_out (rows,) receives it.
REPRO_EXPORT int fused_compress_bisect(const float* re, const float* im, const float* w,
                                       const float* eps, const float* p_codes,
                                       const float* n_neg, int rows, int cols, int k_pad,
                                       float m_scale, int code_bytes, void* rec, void* imc,
                                       int* idx, int k_keep, int iters, float* tau_out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<uint8_t, true>(re, im, w, nullptr, eps, p_codes, n_neg, rows, cols,
                                        k_pad, m_scale, rec, imc, idx, k_keep, iters, tau_out, s);
  if (code_bytes == 2)
    return repro::launch<uint16_t, true>(re, im, w, nullptr, eps, p_codes, n_neg, rows, cols,
                                         k_pad, m_scale, rec, imc, idx, k_keep, iters, tau_out,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}
