"""B2: fused threshold + pack + quantize (port of
``repro.kernels.fused_compress.fused_compress_pallas``).

Per row of rfft spectrum planes: the Hermitian-weighted magnitude
``sqrt(re^2 + im^2) * w``, the mask ``mag >= tau``, index-ascending
compaction of the kept bins into ``k_pad = ceil128(k_keep)`` slots, and
range-quant encode of re and im with scalar or per-row quantizer params.
Slots never filled hold code 0 at index 0.  The engine passes the
threshold kernel's mid-gap tau; with ``tau=None`` each row is bisected for
``k_keep`` first (``selection.bisect_tau``, B1's function), as the
reference kernel does, and that tau is returned.  The CUDA kernel is
``csrc/fused_compress.cu`` (:data:`KERNEL` with a tau, :data:`BISECT_KERNEL`
without: the whole CTA runs B1's sweeps until few values are left in the
bracket, then one warp takes the k-th largest magnitude from those and
replays the rest of the bisection from it); codes, indices and tau are
bitwise equal to the plain version on the same input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import selection
from repro_torch.kernels import _checks
from repro_torch.kernels.build import Kernel, kernel_op, ptr
from repro_torch.kernels.range_quant import encode_math

__all__ = ["KERNEL", "BISECT_KERNEL", "K_TILE", "pad_k", "fused_compress",
           "fused_compress_plain"]

K_TILE = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "fused_compress", "fused_compress.cu",
    replaces="src/repro/kernels/fused_compress.py:168",
    entry="fused_compress",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P],
)
BISECT_KERNEL = Kernel(
    "fused_compress_bisect", "fused_compress.cu",
    replaces="src/repro/kernels/fused_compress.py:168",
    entry="fused_compress_bisect",
    argtypes=[_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _I, _I, _P],
)


def pad_k(k: int) -> int:
    """Payload width: the keep count rounded up to the 128-slot tile."""
    return ((k + K_TILE - 1) // K_TILE) * K_TILE


def fused_compress_plain(re2d, im2d, weights, eps, p_codes, tau=None, *, k_keep: int,
                         n_bits: int = 8, m_bits: int = 3):
    """Plain PyTorch version: (re_codes, im_codes, idx i32, tau (rows,1))."""
    rows, cols = re2d.shape
    k = pad_k(k_keep)
    eps_r, p_r, n_neg_r = (v[:, None] for v in _checks.encode_row_params(
        eps, p_codes, n_bits, rows, re2d.device))
    mag = torch.sqrt(re2d * re2d + im2d * im2d) * weights.reshape(1, -1)
    if tau is None:
        tau = selection.bisect_tau(mag, k_keep)
    tau = tau.reshape(rows, 1).float()
    mask = mag >= tau
    pos = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    r_i, c_i = torch.nonzero(mask & (pos < k), as_tuple=True)
    slot = pos[r_i, c_i].long()
    out_dtype = _checks.code_dtype(n_bits)
    m_scale = float(1 << m_bits)
    codes = []
    for plane in (re2d, im2d):
        c = encode_math(plane[r_i, c_i], eps_r[r_i, 0], p_r[r_i, 0], n_neg_r[r_i, 0], m_scale)
        # index_put has no uint16 kernel: scatter the converted codes as int32
        out = torch.zeros((rows, k), dtype=torch.int32, device=re2d.device)
        out[r_i, slot] = c.to(out_dtype).to(torch.int32)
        codes.append(out.to(out_dtype))
    idx = torch.zeros((rows, k), dtype=torch.int32, device=re2d.device)
    idx[r_i, slot] = c_i.to(torch.int32)
    return codes[0], codes[1], idx, tau


def _fused_compress(re2d, im2d, weights, eps, p_codes, tau, k_keep: int, n_bits: int,
                    m_bits: int):
    """The op's body: (re_codes, im_codes, idx), and with ``tau`` None the
    bisected tau too."""
    if _checks.on_cpu(re2d):
        out = fused_compress_plain(re2d, im2d, weights, eps, p_codes, tau, k_keep=k_keep,
                                   n_bits=n_bits, m_bits=m_bits)
        return out if tau is None else out[:3]
    rows, cols = re2d.shape
    dev = re2d.device
    _checks.require("re", re2d, torch.float32)
    _checks.require("im", im2d, torch.float32, shape=(rows, cols), device=dev)
    w = weights.reshape(cols)
    _checks.require("weights", w, torch.float32, device=dev)
    eps_r, p_r, n_neg_r = _checks.encode_row_params(eps, p_codes, n_bits, rows, dev)
    k = pad_k(k_keep)
    out_dtype = _checks.code_dtype(n_bits)
    rec = torch.empty((rows, k), dtype=out_dtype, device=dev)
    imc = torch.empty((rows, k), dtype=out_dtype, device=dev)
    idx = torch.empty((rows, k), dtype=torch.int32, device=dev)
    m_scale = float(1 << m_bits)
    if tau is None:
        tau = torch.empty((rows,), dtype=torch.float32, device=dev)
        if rows:
            BISECT_KERNEL.launch(dev, ptr(re2d), ptr(im2d), ptr(w), ptr(eps_r), ptr(p_r),
                                 ptr(n_neg_r), rows, cols, k, m_scale, rec.element_size(),
                                 ptr(rec), ptr(imc), ptr(idx), k_keep, selection.BISECT_ITERS,
                                 ptr(tau))
        return rec, imc, idx, tau.reshape(rows, 1)
    tau = tau.reshape(rows).float().contiguous()
    _checks.require("tau", tau, torch.float32, device=dev)
    if rows:
        KERNEL.launch(dev, ptr(re2d), ptr(im2d), ptr(w), ptr(tau), ptr(eps_r), ptr(p_r),
                      ptr(n_neg_r), rows, cols, k, m_scale, rec.element_size(),
                      ptr(rec), ptr(imc), ptr(idx))
    return rec, imc, idx


def _payload(re2d, k_keep, n_bits):
    rows = re2d.shape[0]
    k = pad_k(k_keep)
    code = re2d.new_empty((rows, k), dtype=_checks.code_dtype(n_bits))
    return code, torch.empty_like(code), re2d.new_empty((rows, k), dtype=torch.int32)


_OP = kernel_op(
    KERNEL.name, "(Tensor re, Tensor im, Tensor weights, Tensor eps, Tensor p_codes, Tensor tau, "
    "int k_keep, int n_bits, int m_bits) -> (Tensor, Tensor, Tensor)", _fused_compress,
    lambda re2d, im2d, w, eps, p, tau, k_keep, n_bits, m_bits: _payload(re2d, k_keep, n_bits))
_BISECT_OP = kernel_op(
    BISECT_KERNEL.name, "(Tensor re, Tensor im, Tensor weights, Tensor eps, Tensor p_codes, "
    "int k_keep, int n_bits, int m_bits) -> (Tensor, Tensor, Tensor, Tensor)",
    lambda re2d, im2d, w, eps, p, k_keep, n_bits, m_bits: _fused_compress(
        re2d, im2d, w, eps, p, None, k_keep, n_bits, m_bits),
    lambda re2d, im2d, w, eps, p, k_keep, n_bits, m_bits: _payload(re2d, k_keep, n_bits) + (
        re2d.new_empty((re2d.shape[0], 1), dtype=torch.float32),))


def fused_compress(re2d, im2d, weights, eps, p_codes, tau=None, *, k_keep: int,
                   n_bits: int = 8, m_bits: int = 3):
    """(rows, cols) spectrum planes and per-row ``tau`` -> (re_codes,
    im_codes, idx i32, tau (rows, 1)).

    With ``tau=None`` each row's tau is bisected for ``k_keep`` first, as
    B1 bisects it, and returned.  Codes are uint8 for ``n_bits <= 8``, else
    uint16; the payload width is ``pad_k(k_keep)``.  ``eps``/``p_codes``
    are scalars (one fit) or ``(rows,)`` vectors (one fit per row).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    eps, p_codes = _checks.as_tensors(eps, p_codes, re2d.device)
    if tau is None:
        return _BISECT_OP(re2d, im2d, weights, eps, p_codes, k_keep, n_bits, m_bits)
    return _OP(re2d, im2d, weights, eps, p_codes, tau, k_keep, n_bits, m_bits) + (
        tau.reshape(re2d.shape[0], 1).float(),)
