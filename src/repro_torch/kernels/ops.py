"""The kernel-composed pipeline (port of ``repro.kernels.ops``): the paper's
compress/decompress on ``(rows, 4096)`` chunks built from the standalone
kernels alone -- B7 for both transforms, B1 for the threshold, B6 for pack
and unpack, B5 for encode and decode.

Each function calls kernel wrappers, which pick by device: on a CUDA tensor
every stage is a kernel launch, on a CPU tensor the kernels' plain versions.
The wrappers also keep the shapes the kernels demand: :func:`pad_k` rounds
the kept budget up to the 128-slot tile, and the rfft semantics (the first
2049 of the 4096 bins) are applied here.
"""

from __future__ import annotations

import torch

from repro_torch.core import fft as cfft
from repro_torch.kernels import fft4step, pack, range_quant, topk_threshold

__all__ = [
    "RFFT_BINS",
    "pad_k",
    "quant_encode",
    "quant_decode",
    "threshold_select",
    "pack_threshold",
    "unpack_dense",
    "rfft4096",
    "irfft4096",
    "compress_chunks",
    "decompress_chunks",
]

RFFT_BINS = fft4step.CHUNK // 2 + 1


def pad_k(k: int, tile: int = pack.K_TILE) -> int:
    """The kept budget rounded up to the tile (at least one tile)."""
    return max(tile, ((k + tile - 1) // tile) * tile)


def quant_encode(x2d, quantizer):
    cfg = quantizer.config
    return range_quant.encode(x2d.contiguous(), quantizer.eps, quantizer.p_codes,
                              n_bits=cfg.n_bits, m_bits=cfg.m_bits)


def quant_decode(codes2d, quantizer):
    cfg = quantizer.config
    return range_quant.decode(codes2d.contiguous(), quantizer.eps, quantizer.p_codes,
                              n_bits=cfg.n_bits, m_bits=cfg.m_bits)


def threshold_select(mag2d, k: int):
    return topk_threshold.threshold(mag2d, k=k)


def pack_threshold(x2d, tau, k: int):
    return pack.pack(x2d, tau, k=pad_k(k))


def unpack_dense(vals, idx, cols: int):
    pad = (-cols) % pack.F_TILE
    dense = pack.unpack(vals.contiguous(), idx, cols=cols + pad)
    return dense[:, :cols]


def rfft4096(x2d):
    """(rows, 4096) real -> (re, im), each (rows, 2049)."""
    x = x2d.float().contiguous()
    re, im = fft4step.fft4096(x, torch.zeros_like(x), inverse=False)
    return re[:, :RFFT_BINS], im[:, :RFFT_BINS]


def irfft4096(re, im):
    """(rows, 2049) rfft spectrum -> (rows, 4096) real (Hermitian inverse)."""
    # Hermitian completion: X[N - k] = conj(X[k]) for k = 1 .. N/2 - 1
    full_re = torch.cat([re, re[:, 1:-1].flip(-1)], dim=-1)
    full_im = torch.cat([im, -im[:, 1:-1].flip(-1)], dim=-1)
    out_re, _ = fft4step.fft4096(full_re, full_im, inverse=True)
    return out_re


def compress_chunks(x2d, k: int, quantizer):
    """rfft -> weighted-magnitude threshold -> pack -> quantize re/im.
    Returns (re_codes, im_codes, idx, tau), each of width ``pad_k(k)``."""
    re, im = rfft4096(x2d)
    w = cfft.hermitian_weights(fft4step.CHUNK, re.device)
    mag = torch.sqrt(re * re + im * im) * w
    tau, _ = threshold_select(mag, k)
    # pack the kept bins' indices from the magnitude plane, then gather re
    # and im at them (slots past the count carry 0)
    mvals, idx = pack_threshold(mag, tau, k)
    del mag
    valid = mvals != 0
    re_k = torch.gather(re, -1, idx.long()) * valid
    im_k = torch.gather(im, -1, idx.long()) * valid
    del re, im
    return quant_encode(re_k, quantizer), quant_encode(im_k, quantizer), idx, tau


def decompress_chunks(re_c, im_c, idx, quantizer, orig_len: int):
    """Inverse of :func:`compress_chunks` -> flat f32 of ``orig_len``."""
    re_k = quant_decode(re_c, quantizer)
    im_k = quant_decode(im_c, quantizer)
    pad = (-RFFT_BINS) % pack.F_TILE
    re = unpack_dense(re_k, idx, RFFT_BINS + pad)[:, :RFFT_BINS]
    im = unpack_dense(im_k, idx, RFFT_BINS + pad)[:, :RFFT_BINS]
    del re_k, im_k
    return irfft4096(re, im).reshape(-1)[:orig_len]
