// Range-quant encode/decode as device functions: the arithmetic of
// repro_torch/kernels/range_quant.py (and of the reference's encode_math /
// decode_math), op for op, for the fused compress and decompress kernels.
//
// Bitwise contract with the plain PyTorch version on the same card:
// * every product and sum is an explicit round-to-nearest intrinsic, so no
//   a*b+c is contracted into an FMA whatever -fmad says;
// * exp2 and log2 are spelled as the reference lowers them,
//   exp(float32(ln2) * x) and log(x) / float32(ln2), with the same expf/logf
//   PyTorch's CUDA kernels call; rounding uses rintf (half to even), as
//   torch.round does.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kLn2 = 0.693147182464599609375f;  // float32(ln 2)

__device__ __forceinline__ float rq_exp2(float x) { return expf(__fmul_rn(x, kLn2)); }

__device__ __forceinline__ float rq_log2(float x) { return __fdiv_rn(logf(x), kLn2); }

// The row's quantizer constants: what encode_math computes from (eps, P,
// n_neg) alone.  A kernel that encodes many values of one row computes them
// once; the per-value arithmetic below is unchanged, so the codes are too.
struct EncodeRow {
  float eps, log2_eps, p_codes, pos_max, neg_max;
};

__device__ __forceinline__ EncodeRow encode_row(float eps, float p_codes, float n_neg) {
  return {eps, rq_log2(eps), p_codes, __fsub_rn(p_codes, 1.0f),
          __fsub_rn(fmaxf(n_neg, 1.0f), 1.0f)};
}

// f32 value -> float-carried code (0 .. 2**N - 1) under the row's constants.
__device__ __forceinline__ float encode_value(float x, const EncodeRow& row, float m_scale) {
  const float eps = row.eps;
  const float a = fabsf(x);
  const bool pos = x >= 0.0f;
  const float safe_a = fmaxf(a, eps);
  float q = floorf(__fadd_rn(__fsub_rn(rq_log2(safe_a), row.log2_eps), 1e-6f));
  const float seg_base = __fmul_rn(eps, rq_exp2(q));
  float r = rintf(__fmul_rn(__fsub_rn(__fdiv_rn(safe_a, seg_base), 1.0f), m_scale));
  const bool carry = r >= m_scale;
  q = carry ? __fadd_rn(q, 1.0f) : q;
  r = carry ? 0.0f : r;
  float idx = __fadd_rn(__fmul_rn(q, m_scale), r);
  if (a < eps) idx = __fmul_rn(a, 2.0f) >= eps ? 0.0f : -1.0f;
  const float idx_pos = fminf(fmaxf(idx, -1.0f), row.pos_max);
  const float idx_neg = fminf(fmaxf(idx, -1.0f), row.neg_max);
  return pos ? (idx_pos < 0.0f ? 0.0f : __fadd_rn(idx_pos, 1.0f))
             : (idx_neg < 0.0f ? 0.0f : __fadd_rn(__fadd_rn(row.p_codes, idx_neg), 1.0f));
}

// f32 value -> float-carried code (0 .. 2**N - 1).
__device__ __forceinline__ float encode_math(float x, float eps, float p_codes, float n_neg,
                                             float m_scale) {
  return encode_value(x, encode_row(eps, p_codes, n_neg), m_scale);
}

// float-carried code -> f32 value.
__device__ __forceinline__ float decode_math(float c, float eps, float p_codes, float m_scale) {
  const bool is_zero = c == 0.0f;
  const bool is_pos = c >= 1.0f && c <= p_codes;
  float idx = is_pos ? __fsub_rn(c, 1.0f) : __fsub_rn(__fsub_rn(c, p_codes), 1.0f);
  idx = fmaxf(idx, 0.0f);
  const float q = floorf(__fdiv_rn(idx, m_scale));
  const float r = __fsub_rn(idx, __fmul_rn(q, m_scale));
  const float mag = __fmul_rn(__fmul_rn(eps, rq_exp2(q)), __fadd_rn(1.0f, __fdiv_rn(r, m_scale)));
  const float val = is_pos ? mag : -mag;
  return is_zero ? 0.0f : val;
}

}  // namespace repro
