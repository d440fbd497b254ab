"""B3: fused dequantize + Hermitian scatter + inverse 4096-point FFT (port of
``repro.kernels.fused_decompress.fused_decompress_pallas``).

Per row: decode the k re/im codes with scalar or per-row (eps, P), add each
kept coefficient into its rfft bin (the kernel also adds the conjugate
mirror at ``4096 - i`` for interior bins and runs a full complex inverse
FFT; the plain version lets ``irfft`` apply the same Hermitian symmetry),
and return the real ``(rows, 4096)`` signal.  Padding slots (code 0 at
index 0) decode to 0.0 and add nothing, so any payload width works.

The CUDA kernel is ``csrc/fused_decompress.cu``; it agrees with the plain
version within 2e-6 * max|x| per row (both are fp32 FFTs, summed in
different orders).  Its transform is the real inverse core of
``csrc/fft4096.cuh``: the irfft as one 2048-point complex inverse of the
packed half spectrum, with B7's twiddle table.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _checks, fft4step
from repro_torch.kernels.build import Kernel, kernel_op, ptr
from repro_torch.kernels.range_quant import decode_math

__all__ = ["KERNEL", "CHUNK", "fused_decompress", "fused_decompress_plain"]

CHUNK = fft4step.CHUNK
_BINS = CHUNK // 2 + 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "fused_decompress", "fused_decompress.cu",
    replaces="src/repro/kernels/fused_decompress.py:143",
    entry="fused_decompress",
    argtypes=[_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P, _P, _P],
)


def fused_decompress_plain(re_codes, im_codes, idx, eps, p_codes, *, m_bits: int = 3):
    """Plain PyTorch version: decode, additive scatter into the 2049 rfft
    bins, ``irfft`` to (rows, 4096) f32."""
    rows, k = re_codes.shape
    eps_r, p_r = (v[:, None] for v in _checks.row_params(eps, p_codes, rows, re_codes.device))
    m_scale = float(1 << m_bits)
    re = decode_math(re_codes.float(), eps_r, p_r, m_scale)
    im = decode_math(im_codes.float(), eps_r, p_r, m_scale)
    bins = idx.long()
    spec_re = torch.zeros((rows, _BINS), dtype=torch.float32, device=re.device)
    spec_im = torch.zeros((rows, _BINS), dtype=torch.float32, device=re.device)
    spec_re.scatter_add_(-1, bins, re)
    spec_im.scatter_add_(-1, bins, im)
    return torch.fft.irfft(torch.complex(spec_re, spec_im), n=CHUNK, dim=-1)


def _fused_decompress(re_codes, im_codes, idx, eps, p_codes, m_bits: int):
    if _checks.on_cpu(re_codes):
        return fused_decompress_plain(re_codes, im_codes, idx, eps, p_codes, m_bits=m_bits)
    rows, k = re_codes.shape
    dev = re_codes.device
    code_types = (torch.uint8, torch.uint16)
    _checks.require("re_codes", re_codes, code_types)
    _checks.require("im_codes", im_codes, re_codes.dtype, shape=(rows, k), device=dev)
    _checks.require("idx", idx, (torch.int16, torch.int32), shape=(rows, k), device=dev)
    eps_r, p_r = _checks.row_params(eps, p_codes, rows, dev)
    out = torch.empty((rows, CHUNK), dtype=torch.float32, device=dev)
    if rows:
        KERNEL.launch(dev, ptr(re_codes), ptr(im_codes), ptr(idx), ptr(eps_r), ptr(p_r), rows, k,
                      float(1 << m_bits), re_codes.element_size(), idx.element_size(),
                      ptr(fft4step.twiddles(dev)), ptr(out))
    return out


_OP = kernel_op(KERNEL.name, "(Tensor re_codes, Tensor im_codes, Tensor idx, Tensor eps, "
                "Tensor p_codes, int m_bits) -> Tensor", _fused_decompress,
                lambda re_codes, *args: re_codes.new_empty((re_codes.shape[0], CHUNK),
                                                           dtype=torch.float32))


def fused_decompress(re_codes, im_codes, idx, eps, p_codes, *, m_bits: int = 3):
    """Quantized payload planes -> (rows, 4096) f32 time-domain chunks.

    ``re_codes``/``im_codes`` are uint8 or uint16 ``(rows, k)``; ``idx`` is
    int16 or int32 bin indices in [0, 2048]; ``eps``/``p_codes`` are scalars
    or ``(rows,)`` vectors.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    eps, p_codes = _checks.as_tensors(eps, p_codes, re_codes.device)
    return _OP(re_codes, im_codes, idx, eps, p_codes, m_bits)
