"""B5: range-quant encode/decode (port of ``repro.kernels.range_quant``:
``encode_math`` / ``decode_math`` and the kernels ``encode_pallas`` /
``decode_pallas``).

``encode_math`` / ``decode_math`` are the arithmetic on float-carried
planes; the fused compress and decompress kernels run it in registers, and
``csrc/range_quant.cuh`` holds the same expressions as CUDA ``__device__``
functions, op for op, so the kernels and these functions agree bitwise on
the same device.  Their parameters (eps, P, n_neg) are float32 tensors that
broadcast against the plane (scalars, or ``(rows, 1)`` columns for one fit
per row).

:func:`encode` and :func:`decode` are the standalone kernels
(``csrc/range_quant.cu``): a ``(rows, cols)`` plane with one fit for the
whole plane (scalars) or one per row (``(rows,)`` vectors); codes are uint8
for ``n_bits <= 8``, else uint16.  Their plain versions are the math above
with the dtype casts, and kernel and plain version are bitwise equal for
every input (a NaN encodes to code 0 in both, as in the reference).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizer import exp2, log2
from repro_torch.kernels import _checks
from repro_torch.kernels.build import Kernel, kernel_op, ptr

__all__ = ["ENCODE_KERNEL", "DECODE_KERNEL", "encode_math", "decode_math", "encode",
           "encode_plain", "decode", "decode_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENCODE_KERNEL = Kernel(
    "range_quant_encode", "range_quant.cu",
    replaces="src/repro/kernels/range_quant.py:151",
    entry="range_quant_encode",
    argtypes=[_P, _P, _P, _P, _I, _I, _F, _I, _P, _P],
)
DECODE_KERNEL = Kernel(
    "range_quant_decode", "range_quant.cu",
    replaces="src/repro/kernels/range_quant.py:187",
    entry="range_quant_decode",
    argtypes=[_P, _P, _P, _I, _I, _F, _I, _P, _P],
)


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


def encode_plain(x2d, eps, p_codes, *, n_bits: int = 8, m_bits: int = 3) -> torch.Tensor:
    """Plain PyTorch version of :func:`encode`."""
    rows = x2d.shape[0]
    eps_r, p_r, n_neg_r = (v[:, None] for v in _checks.encode_row_params(
        eps, p_codes, n_bits, rows, x2d.device))
    codes = encode_math(x2d.float(), eps_r, p_r, n_neg_r, float(1 << m_bits))
    return codes.to(_checks.code_dtype(n_bits))


def _encode(x2d, eps, p_codes, n_bits: int, m_bits: int) -> torch.Tensor:
    if _checks.on_cpu(x2d):
        return encode_plain(x2d, eps, p_codes, n_bits=n_bits, m_bits=m_bits)
    rows, cols = x2d.shape
    _checks.require("x", x2d, torch.float32)
    eps_r, p_r, n_neg_r = _checks.encode_row_params(eps, p_codes, n_bits, rows, x2d.device)
    codes = torch.empty((rows, cols), dtype=_checks.code_dtype(n_bits), device=x2d.device)
    if codes.numel():
        ENCODE_KERNEL.launch(x2d.device, ptr(x2d), ptr(eps_r), ptr(p_r), ptr(n_neg_r), rows,
                             cols, float(1 << m_bits), codes.element_size(), ptr(codes))
    return codes


_ENCODE_OP = kernel_op(ENCODE_KERNEL.name, "(Tensor x, Tensor eps, Tensor p_codes, int n_bits, "
                       "int m_bits) -> Tensor", _encode,
                       lambda x2d, eps, p, n_bits, m_bits: x2d.new_empty(
                           x2d.shape, dtype=_checks.code_dtype(n_bits)))


def encode(x2d, eps, p_codes, *, n_bits: int = 8, m_bits: int = 3) -> torch.Tensor:
    """f32 ``(rows, cols)`` -> uint8/uint16 codes.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    eps, p_codes = _checks.as_tensors(eps, p_codes, x2d.device)
    return _ENCODE_OP(x2d, eps, p_codes, n_bits, m_bits)


def decode_plain(codes2d, eps, p_codes, *, n_bits: int = 8, m_bits: int = 3) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode`."""
    del n_bits  # the code type carries it
    eps_r, p_r = (v[:, None] for v in _checks.row_params(eps, p_codes, codes2d.shape[0],
                                                          codes2d.device))
    return decode_math(codes2d.float(), eps_r, p_r, float(1 << m_bits))


def _decode(codes2d, eps, p_codes, n_bits: int, m_bits: int) -> torch.Tensor:
    if _checks.on_cpu(codes2d):
        return decode_plain(codes2d, eps, p_codes, n_bits=n_bits, m_bits=m_bits)
    rows, cols = codes2d.shape
    _checks.require("codes", codes2d, _checks.code_dtype(n_bits))
    eps_r, p_r = _checks.row_params(eps, p_codes, rows, codes2d.device)
    out = torch.empty((rows, cols), dtype=torch.float32, device=codes2d.device)
    if out.numel():
        DECODE_KERNEL.launch(codes2d.device, ptr(codes2d), ptr(eps_r), ptr(p_r), rows, cols,
                             float(1 << m_bits), codes2d.element_size(), ptr(out))
    return out


_DECODE_OP = kernel_op(DECODE_KERNEL.name, "(Tensor codes, Tensor eps, Tensor p_codes, "
                       "int n_bits, int m_bits) -> Tensor", _decode,
                       lambda codes2d, *args: codes2d.new_empty(codes2d.shape,
                                                                dtype=torch.float32))


def decode(codes2d, eps, p_codes, *, n_bits: int = 8, m_bits: int = 3) -> torch.Tensor:
    """uint8/uint16 codes ``(rows, cols)`` -> f32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    eps, p_codes = _checks.as_tensors(eps, p_codes, codes2d.device)
    return _DECODE_OP(codes2d, eps, p_codes, n_bits, m_bits)
