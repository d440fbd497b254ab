// B5: range-quant encode (f32 -> N-bit codes) and decode (codes -> f32).
//
// Replaces the TPU kernels repro/kernels/range_quant.py::encode_pallas
// (pl.pallas_call at l.151) and ::decode_pallas (l.187): an elementwise
// pass with one quantizer fit (eps, P, n_neg) per row -- a scalar fit is
// expanded to every row by the wrapper.  Codes and values are bitwise equal
// to the plain version's for every input; a NaN encodes to code 0, as in
// the reference (encode_value alone would give it code P + 1).
//
// Bound on this card: bytes.  Encode reads 4 B and writes 1 B (uint8 codes)
// per value, decode the reverse: at the ops path's 221,184 rows of 640 slots
// about 0.71 GB, so about 0.21 ms at 3.35 TB/s.  Encode as range_quant.cuh
// writes it (encode_value: a logf, an expf and two IEEE divisions, 112 SASS
// instructions a value in a one-value loop) would take about 0.47 ms for
// those 141.6 M values at one warp instruction a clock on every scheduler,
// so the encode here takes a shorter path (about 55 instructions a value)
// that is shown exact value by value, and runs encode_value only where it
// is not.
//
// Design: a CTA of 256 threads takes kRqRows (32) consecutive rows, warp w
// rows 4w .. 4w + 3, so no thread idles at a row's tail and no thread
// divides to find its row.  A row is C chunks of 128 values (C = cols /
// 128: 5 at the ops path's 640 slots, 3 at the chunk=2048 route's 384);
// lane l takes values 4l .. 4l + 3 of each chunk, so every load and store
// instruction of a warp covers 512 (or 128) consecutive bytes, and a lane
// starts the row's C loads before it computes.  Rows of other widths take
// a path that walks the CTA's values one at a time.  The row constants are
// built once per row in shared memory, while the warp's first row loads:
// * decode, 8-bit codes: a table of decode_math over all 256 codes (its
//   divisions by m_scale, a power of two, written as the products by
//   1/m_scale they equal), looked up per value -- as B3's table.  16-bit
//   codes run decode_math per value;
// * encode: encode_row's constants and rcp[q] = 1 / (eps * rq_exp2(q)) for
//   the segments q < kSegs (NaN in entry kSegs).  Per value (a = |x| >
//   eps), the shortcut:
//   - q: g = lg2.approx(a) - (log2_eps - 1e-6), q = floor(g).  encode_value
//     floors g' = (rq_log2(a) - log2_eps) + 1e-6.  With logf within 1 ulp
//     (CUDA's bound), lg2.approx within 2^-20 (PTX: 2^-22.6) and the
//     roundings of values below 64, |g - g'| < 2^-14.5, so q is floor(g')
//     wherever g lies at least kQMargin (2^-12) from an integer and
//     0 <= q < kSegs.  Then log2(a / seg_base) lies within 2^-14 of
//     g' - q, so z = a / seg_base (IEEE) lies in (1, 2).
//   - r: y = a * rcp[q] is within 2^-20 of z; z - 1 and the product by
//     m_scale (a power of two) are exact, so t = (y - 1) * m_scale is
//     within m_scale * 2^-20 of encode_value's (z - 1) * m_scale, and
//     r = rint(t) is its rint wherever t lies at least m_scale * 2^-18
//     from a half-integer.
//   - a <= eps, and the clamps and code, are encode_value's integer-valued
//     arithmetic.
//   Values where a check fails (about 1 in 1,400 at 8/3 bits: a within
//   2^-12 of a segment bound in log2, or of a rounding edge; q >= kSegs;
//   inf; NaN, which is code 0; rows whose eps is not a normal float >=
//   2^-100, or whose codes are not integers of the code type) run
//   encode_value.
// tests/test_torch_range_quant_design.py walks the shortcut and its checks
// in numpy against the plain version; the two change together.
#include "range_quant.cuh"

namespace repro {

constexpr int kRqRows = 32;         // rows a CTA takes
constexpr int kRowsPerWarp = kRqRows / kWarps;
constexpr int kChunk = 128;         // values of a row a warp takes at once, 4 a lane
constexpr int kMaxChunks = 8;       // rows up to 1024 wide take the chunked path
constexpr int kSegs = 32;           // segments q with a table entry (8/3 bits: q < 32)
constexpr float kQMargin = 0x1p-12f;  // least distance of g from an integer
constexpr float kRMargin = 0x1p-18f;  // least distance of t from a half-integer, / m_scale
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23: x + kRound - kRound is rint(x), |x| < 2^22
constexpr float kMinFastEps = 0x1p-100f;

// The shortcut's constants of a row; eps < 0 and rcp NaN on rows it
// cannot serve, which then take encode_value throughout.
struct FastRow {
  float eps, half_eps, log2_eps_1e6, pos_max, neg_max, p_plus_1;
};

// The shortcut serves a row whose eps is a normal float >= 2^-100 (eps / 2
// exact) and whose codes are integers up to code_max (P and n_neg integers,
// P >= 0, P + max(n_neg, 1) <= code_max), as every fit gives; on those
// rows a code's bits are the cast's.
__device__ __forceinline__ bool row_usable(float e, float p, float nn, float code_max) {
  return e >= kMinFastEps && e <= FLT_MAX && p == rintf(p) && nn == rintf(nn) && p >= 0.0f &&
         __fadd_rn(p, fmaxf(nn, 1.0f)) <= code_max;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The code encode_value gives x, or -1 where the shortcut cannot show it
// (NaN included).  rcp: the row's kSegs + 1 reciprocals.
__device__ __forceinline__ float encode_fast(float x, const FastRow& f, const float* rcp,
                                             float m_scale, float r_limit) {
  const float a = fabsf(x);
  // q = floor(g) from rint(g) (the low bits of g + kRound) and the sign of
  // g - rint(g): full-rate adds
  const float g = __fsub_rn(lg2_approx(a), f.log2_eps_1e6);
  const float g_round = __fadd_rn(g, kRound);
  const float n = __fsub_rn(g_round, kRound);
  const float d = __fsub_rn(g, n);
  const bool up = d > 0.0f;
  const float q = up ? n : __fsub_rn(n, 1.0f);
  // q outside [0, kSegs) (as an unsigned, a negative q is large) reads
  // rcp[kSegs], a NaN, which fails the check on t
  const unsigned slot = min(static_cast<unsigned>(__float_as_int(g_round) -
                                                  __float_as_int(kRound) - (up ? 0 : 1)),
                            static_cast<unsigned>(kSegs));
  // t = (y - 1) * m_scale: y * m_scale and the difference are exact
  const float t = __fmaf_rn(__fmul_rn(a, rcp[slot]), m_scale, -m_scale);
  const float r = __fsub_rn(__fadd_rn(t, kRound), kRound);
  const bool carry = r >= m_scale;
  float idx = __fmaf_rn(q, m_scale, carry ? m_scale : r);  // integers: exact
  bool ok = fabsf(d) > kQMargin && fabsf(__fsub_rn(t, r)) < r_limit;
  const bool below = a <= f.eps;  // encode_value's rounding below eps; a == eps is idx 0
  idx = below ? (a < f.half_eps ? -1.0f : 0.0f) : idx;
  ok = ok || below;
  const float lo = fmaxf(idx, -1.0f);
  const float code_pos = __fadd_rn(fminf(lo, f.pos_max), 1.0f);
  const float idx_neg = fminf(lo, f.neg_max);
  const float code_neg = idx_neg < 0.0f ? 0.0f : __fadd_rn(f.p_plus_1, idx_neg);
  return ok ? (x >= 0.0f ? code_pos : code_neg) : -1.0f;
}

// An integer-valued float code 0 .. 65535 as an integer in the low bits
// (above them, garbage the packing drops): its bits after adding 2^23.
__device__ __forceinline__ uint32_t code_bits(float c) {
  return __float_as_uint(__fadd_rn(c, 8388608.0f));
}

// The codes of V values as integers in the low bits: the shortcut, then
// for the values it left (rare; one at a time, picked out of the registers
// by selects) code 0 for a NaN, else encode_value cast as the plain version
// casts.  A value the shortcut left has bits below 2^23's (code -1).
template <typename CodeT, int V>
__device__ __forceinline__ void encode_values(const float (&x)[V], uint32_t (&c)[V],
                                              const FastRow& f, const float* rcp,
                                              const EncodeRow& row, float m_scale,
                                              float r_limit) {
  uint32_t sign = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float code = encode_fast(x[v], f, rcp, m_scale, r_limit);
    sign |= __float_as_uint(code);
    c[v] = code_bits(code);
  }
  if (sign >> 31) {
    unsigned rest = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) rest |= static_cast<unsigned>(c[v] < 0x4b000000u) << v;
    while (rest) {
      const int pick = __ffs(rest) - 1;
      rest &= rest - 1;
      float xv = x[0];
#pragma unroll
      for (int v = 1; v < V; ++v) xv = v == pick ? x[v] : xv;
      const uint32_t exact = xv != xv ? 0u : static_cast<CodeT>(encode_value(xv, row, m_scale));
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] = v == pick ? exact : c[v];
    }
  }
}

// The CTA's rows: encode_row's constants, the shortcut's, the reciprocals.
template <typename CodeT>
__device__ __forceinline__ void build_encode_rows(const float* eps, const float* p_codes,
                                                  const float* n_neg, int row0, int n_rows,
                                                  EncodeRow* rows, FastRow* fast,
                                                  float (*rcp)[kSegs + 1]) {
  constexpr float kCodeMax = static_cast<float>(static_cast<CodeT>(~0u));
  for (int i = threadIdx.x; i < n_rows * (kSegs + 1); i += kThreads) {
    const int r = i / (kSegs + 1), q = i % (kSegs + 1);
    const float e = eps[row0 + r];
    const float seg = __fmul_rn(e, rq_exp2(static_cast<float>(q)));
    // 1 / seg within 2^-24 (a normal result)
    const bool usable = q < kSegs && row_usable(e, p_codes[row0 + r], n_neg[row0 + r],
                                                kCodeMax) && seg >= FLT_MIN && seg <= 0x1p125f;
    rcp[r][q] = usable ? __frcp_rn(seg) : __int_as_float(0x7fffffff);
  }
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const float e = eps[row0 + r], p = p_codes[row0 + r], nn = n_neg[row0 + r];
    const EncodeRow q = encode_row(e, p, nn);
    rows[r] = q;
    fast[r] = {row_usable(e, p, nn, kCodeMax) ? e : -1.0f, __fmul_rn(e, 0.5f),
               __fsub_rn(q.log2_eps, 1e-6f), q.pos_max, q.neg_max, __fadd_rn(p, 1.0f)};
  }
}

// Four codes of a lane's chunk as one word of the code type's width.
template <typename CodeT> struct CodeQuad;
template <> struct CodeQuad<uint8_t> {
  using type = uint32_t;
  __device__ static type pack(const uint32_t (&c)[4]) {
    return __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
  }
  __device__ static uint32_t code(type w, int u) { return (w >> (8 * u)) & 0xffu; }
};
template <> struct CodeQuad<uint16_t> {
  using type = uint2;
  __device__ static type pack(const uint32_t (&c)[4]) {
    return make_uint2(__byte_perm(c[0], c[1], 0x5410), __byte_perm(c[2], c[3], 0x5410));
  }
  __device__ static uint32_t code(type w, int u) {
    return ((u < 2 ? w.x : w.y) >> (16 * (u & 1))) & 0xffffu;
  }
};

// C: chunks of 128 values a row (1 .. kMaxChunks), with 16-byte aligned
// planes; C = 0: any width, one value at a time.
template <typename CodeT, int C>
__global__ void __launch_bounds__(kThreads, 3)
rq_encode_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                 const float* __restrict__ p_codes, const float* __restrict__ n_neg, int rows,
                 int cols, float m_scale, CodeT* __restrict__ codes) {
  __shared__ EncodeRow s_rows[kRqRows];
  __shared__ FastRow s_fast[kRqRows];
  __shared__ float s_rcp[kRqRows][kSegs + 1];
  const int row0 = blockIdx.x * kRqRows;
  const int n_rows = min(kRqRows, rows - row0);
  const float r_limit = __fsub_rn(0.5f, __fmul_rn(m_scale, kRMargin));
  if constexpr (C > 0) {
    using Quad = CodeQuad<CodeT>;
    const int lane = threadIdx.x & 31;
    const int first = (threadIdx.x >> 5) * kRowsPerWarp;  // the warp's first row in the CTA
    float4 v[C];
    const auto load = [&](int r) {
      const float4* src =
          reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * cols);
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = src[j * (kChunk / 4) + lane];
    };
    if (first < n_rows) load(first);  // flies while the tables are built
    build_encode_rows<CodeT>(eps, p_codes, n_neg, row0, n_rows, s_rows, s_fast, s_rcp);
    __syncthreads();
#pragma unroll 1
    for (int r = first; r < min(first + kRowsPerWarp, n_rows); ++r) {
      if (r > first) load(r);
      auto* dst =
          reinterpret_cast<typename Quad::type*>(codes + static_cast<size_t>(row0 + r) * cols);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float xv[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
        uint32_t c[4];
        encode_values<CodeT>(xv, c, s_fast[r], s_rcp[r], s_rows[r], m_scale, r_limit);
        dst[j * (kChunk / 4) + lane] = Quad::pack(c);
      }
    }
  } else {
    build_encode_rows<CodeT>(eps, p_codes, n_neg, row0, n_rows, s_rows, s_fast, s_rcp);
    __syncthreads();
    const size_t base = static_cast<size_t>(row0) * cols;
    for (int i = threadIdx.x; i < n_rows * cols; i += kThreads) {
      const int r = i / cols;
      const float v[1] = {x[base + i]};
      uint32_t c[1];
      encode_values<CodeT>(v, c, s_fast[r], s_rcp[r], s_rows[r], m_scale, r_limit);
      codes[base + i] = static_cast<CodeT>(c[0]);
    }
  }
}

// decode_math with its divisions by m_scale written as the products by
// inv_m = 1 / m_scale they equal: m_scale is a power of two, so both are the
// one rounding of the same real number (and no result here is denormal).
__device__ __forceinline__ float decode_entry(float c, float eps, float p_codes, float m_scale,
                                              float inv_m) {
  const bool is_zero = c == 0.0f;
  const bool is_pos = c >= 1.0f && c <= p_codes;
  float idx = is_pos ? __fsub_rn(c, 1.0f) : __fsub_rn(__fsub_rn(c, p_codes), 1.0f);
  idx = fmaxf(idx, 0.0f);
  const float q = floorf(__fmul_rn(idx, inv_m));
  const float r = __fsub_rn(idx, __fmul_rn(q, m_scale));
  const float mag = __fmul_rn(__fmul_rn(eps, rq_exp2(q)), __fadd_rn(1.0f, __fmul_rn(r, inv_m)));
  const float val = is_pos ? mag : -mag;
  return is_zero ? 0.0f : val;
}

// 8-bit codes: the CTA's rows' tables of every code's value; 16-bit codes:
// decode_math per value.  C as for the encode.
template <typename CodeT, int C>
__global__ void __launch_bounds__(kThreads, 3)
rq_decode_kernel(const CodeT* __restrict__ codes, const float* __restrict__ eps,
                 const float* __restrict__ p_codes, int rows, int cols, float m_scale,
                 float* __restrict__ out) {
  constexpr bool kTable = sizeof(CodeT) == 1;
  __shared__ float s_table[kTable ? kRqRows : 1][256];
  __shared__ float s_eps[kRqRows], s_p[kRqRows];
  const int row0 = blockIdx.x * kRqRows;
  const int n_rows = min(kRqRows, rows - row0);
  const auto value = [&](int r, uint32_t c) {
    if constexpr (kTable) return s_table[r][c];
    else return decode_math(static_cast<float>(c), s_eps[r], s_p[r], m_scale);
  };
  const auto build = [&]() {
    if constexpr (kTable) {
      const float inv_m = __frcp_rn(m_scale);
      for (int i = threadIdx.x; i < n_rows * 256; i += kThreads)
        s_table[i >> 8][i & 255] = decode_entry(static_cast<float>(i & 255),
                                                eps[row0 + (i >> 8)], p_codes[row0 + (i >> 8)],
                                                m_scale, inv_m);
    } else {
      for (int r = threadIdx.x; r < n_rows; r += kThreads) {
        s_eps[r] = eps[row0 + r];
        s_p[r] = p_codes[row0 + r];
      }
    }
  };
  if constexpr (C > 0) {
    using Quad = CodeQuad<CodeT>;
    const int lane = threadIdx.x & 31;
    const int first = (threadIdx.x >> 5) * kRowsPerWarp;
    typename Quad::type w[C];
    const auto load = [&](int r) {
      const auto* src = reinterpret_cast<const typename Quad::type*>(
          codes + static_cast<size_t>(row0 + r) * cols);
#pragma unroll
      for (int j = 0; j < C; ++j) w[j] = src[j * (kChunk / 4) + lane];
    };
    if (first < n_rows) load(first);  // flies while the tables are built
    build();
    __syncthreads();
#pragma unroll 1
    for (int r = first; r < min(first + kRowsPerWarp, n_rows); ++r) {
      if (r > first) load(r);
      float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * cols);
#pragma unroll
      for (int j = 0; j < C; ++j)
        dst[j * (kChunk / 4) + lane] = make_float4(value(r, Quad::code(w[j], 0)),
                                                   value(r, Quad::code(w[j], 1)),
                                                   value(r, Quad::code(w[j], 2)),
                                                   value(r, Quad::code(w[j], 3)));
    }
  } else {
    build();
    __syncthreads();
    const size_t base = static_cast<size_t>(row0) * cols;
    for (int i = threadIdx.x; i < n_rows * cols; i += kThreads)
      out[base + i] = value(i / cols, codes[base + i]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Launches the chunked instantiation for C = cols / 128 where 128 | cols,
// C <= kMaxChunks and both planes are 16-byte aligned, else C = 0.
template <bool kEncode, typename CodeT, int C = 1>
int launch(const void* in, const float* eps, const float* p_codes, const float* n_neg, int rows,
           int cols, float m_scale, void* out, cudaStream_t s) {
  const bool chunked = cols % kChunk == 0 && cols / kChunk <= kMaxChunks && aligned16(in) &&
                       aligned16(out);
  if constexpr (C <= kMaxChunks) {
    if (!chunked || cols / kChunk != C)
      return launch<kEncode, CodeT, C + 1>(in, eps, p_codes, n_neg, rows, cols, m_scale, out, s);
  }
  constexpr int kC = C <= kMaxChunks ? C : 0;
  const int grid = (rows + kRqRows - 1) / kRqRows;
  if constexpr (kEncode)
    rq_encode_kernel<CodeT, kC><<<grid, kThreads, 0, s>>>(static_cast<const float*>(in), eps,
                                                         p_codes, n_neg, rows, cols, m_scale,
                                                         static_cast<CodeT*>(out));
  else
    rq_decode_kernel<CodeT, kC><<<grid, kThreads, 0, s>>>(static_cast<const CodeT*>(in), eps,
                                                         p_codes, rows, cols, m_scale,
                                                         static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// code_bytes is 1 (uint8 codes, n_bits <= 8) or 2 (uint16).  eps, p_codes
// and n_neg are float32 (rows,) vectors.
REPRO_EXPORT int range_quant_encode(const float* x, const float* eps, const float* p_codes,
                                    const float* n_neg, int rows, int cols, float m_scale,
                                    int code_bytes, void* codes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<true, uint8_t>(x, eps, p_codes, n_neg, rows, cols, m_scale, codes, s);
  if (code_bytes == 2)
    return repro::launch<true, uint16_t>(x, eps, p_codes, n_neg, rows, cols, m_scale, codes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int range_quant_decode(const void* codes, const float* eps, const float* p_codes,
                                    int rows, int cols, float m_scale, int code_bytes,
                                    float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<false, uint8_t>(codes, eps, p_codes, nullptr, rows, cols, m_scale, out,
                                         s);
  if (code_bytes == 2)
    return repro::launch<false, uint16_t>(codes, eps, p_codes, nullptr, rows, cols, m_scale, out,
                                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}
