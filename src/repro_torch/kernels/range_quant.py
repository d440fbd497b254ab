"""Range-quant encode/decode math on float-carried planes (port of
``repro.kernels.range_quant.encode_math`` / ``decode_math``).

These are the plain PyTorch versions of the arithmetic the fused compress
and decompress kernels run in registers; ``csrc/range_quant.cuh`` holds the
same expressions as CUDA ``__device__`` functions, op for op, so the kernels
and these functions agree bitwise on the same device.  Parameters (eps, P,
n_neg) are float32 tensors that broadcast against the plane (scalars, or
``(rows, 1)`` columns for one fit per row).

The standalone encode/decode kernels (``encode_pallas`` / ``decode_pallas``)
are not ported yet (ROADMAP queue 2, B5).
"""

from __future__ import annotations

import torch

from repro_torch.core.quantizer import exp2, log2

__all__ = ["encode_math", "decode_math"]


def encode_math(x, eps, p_codes, n_neg, m_scale: float) -> torch.Tensor:
    """Range-quant ENCODE of an f32 plane -> float-carried codes."""
    a = torch.abs(x)
    pos = x >= 0
    safe_a = torch.maximum(a, eps)
    q = torch.floor(log2(safe_a) - log2(eps) + 1e-6)
    seg_base = eps * exp2(q)
    r = torch.round((safe_a / seg_base - 1.0) * m_scale)
    carry = r >= m_scale
    q = torch.where(carry, q + 1.0, q)
    r = torch.where(carry, torch.zeros_like(r), r)
    idx = q * m_scale + r
    # below-eps: nearest of {0, eps}
    below = torch.where(a * 2.0 >= eps, 0.0, -1.0)
    idx = torch.where(a < eps, below, idx)
    idx_pos = torch.minimum(torch.clamp_min(idx, -1.0), p_codes - 1.0)
    idx_neg = torch.minimum(torch.clamp_min(idx, -1.0),
                            torch.clamp_min(n_neg, 1.0) - 1.0)
    zero = torch.zeros_like(idx)
    return torch.where(
        pos,
        torch.where(idx_pos < 0, zero, idx_pos + 1.0),
        torch.where(idx_neg < 0, zero, p_codes + idx_neg + 1.0),
    )


def decode_math(c, eps, p_codes, m_scale: float) -> torch.Tensor:
    """Range-quant DECODE of an f32-carried code plane."""
    is_zero = c == 0.0
    is_pos = (c >= 1.0) & (c <= p_codes)
    idx = torch.where(is_pos, c - 1.0, c - p_codes - 1.0)
    idx = torch.clamp_min(idx, 0.0)
    q = torch.floor(idx / m_scale)
    r = idx - q * m_scale
    mag = eps * exp2(q) * (1.0 + r / m_scale)
    val = torch.where(is_pos, mag, -mag)
    return torch.where(is_zero, torch.zeros_like(val), val)
