"""Baseline gradient compressors the paper compares against (port of
``repro.core.baselines``; Table I, Fig. 12).

* :class:`TernGrad`     -- Wen et al. 2017: stochastic ternary {-1, 0, 1} * s.
* :class:`QSGD`         -- Alistarh et al. 2017: stochastic uniform levels of
                           |g| / ||g||_2, one norm per 4096-value bucket.
* :class:`DGCTopK`      -- Lin et al. 2017 / Aji-Heafield 2017: time-domain
                           top-k keeping raw f32 values (+ 16-bit indices).
* :class:`AjiThreshold` -- the absolute-value thresholding variant.
* :class:`OneBitSGD`    -- Seide et al. 2014: sign * mean(|g|); the caller
                           keeps the error-feedback residual.

They follow ``FFTCompressor``'s protocol, so reducers treat them alike.  The
stochastic ones take an optional ``torch.Generator`` (the reference's PRNG
key); without one they round deterministically, as the reference does
without a key.  Plain PyTorch: the reference's are plain ``jnp``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fft as cfft
from repro_torch.core import packing, sparsify

__all__ = ["ScaledCodes", "TernGrad", "QSGD", "DGCTopK", "AjiThreshold", "OneBitSGD"]


@dataclasses.dataclass
class ScaledCodes:
    """Codes + scale payload; ``orig_len`` is the unpadded length."""

    codes: torch.Tensor
    scale: torch.Tensor
    orig_len: int


def _ratio(comp, n: int) -> float:
    return 32.0 * n / comp.wire_bits(n)


class TernGrad:
    """g -> s * ternary, s = max|g|; E[compress(g)] = g (unbiased)."""

    bits_per_value = 2

    def compress(self, x_flat: torch.Tensor, generator=None) -> ScaledCodes:
        s = torch.clamp_min(torch.amax(torch.abs(x_flat)), 1e-30)
        p = torch.abs(x_flat) / s
        if generator is None:
            b = (p >= 0.5).to(torch.int8)
        else:
            b = torch.bernoulli(p, generator=generator).to(torch.int8)
        codes = torch.sign(x_flat).to(torch.int8) * b
        return ScaledCodes(codes, s, x_flat.shape[0])

    def decompress(self, payload: ScaledCodes) -> torch.Tensor:
        return payload.codes.float() * payload.scale

    def wire_bits(self, n: int) -> int:
        return self.bits_per_value * n + 32

    def ratio(self, n: int) -> float:
        return _ratio(self, n)


class QSGD:
    """Stochastic uniform quantization onto ``levels`` levels of
    |g| / ||g||_2, with one norm per ``bucket`` values (the QSGD paper's
    practical variant: one global norm over 1e8 values would collapse every
    value to the lowest level)."""

    def __init__(self, levels: int = 16, bucket: int = 4096):  # 4-bit default
        self.levels = levels
        self.bucket = bucket

    @property
    def bits_per_value(self) -> int:
        return max(1, (self.levels - 1).bit_length()) + 1  # + sign bit

    def compress(self, x_flat: torch.Tensor, generator=None) -> ScaledCodes:
        x2d, n = cfft.pad_to_chunks(x_flat, self.bucket)
        norm = torch.clamp_min(torch.linalg.vector_norm(x2d, dim=-1, keepdim=True), 1e-30)
        y = torch.abs(x2d) / norm * self.levels
        lo = torch.floor(y)
        frac = y - lo
        if generator is None:
            up = frac >= 0.5
        else:
            up = torch.bernoulli(frac, generator=generator).bool()
        q = torch.clamp(lo + up.float(), 0, self.levels)
        codes = (torch.sign(x2d) * q).to(torch.int8)
        return ScaledCodes(codes, norm, n)

    def decompress(self, payload: ScaledCodes) -> torch.Tensor:
        dense = payload.codes.float() / self.levels * payload.scale
        return dense.reshape(-1)[: payload.orig_len]

    def wire_bits(self, n: int) -> int:
        n_buckets = max(1, -(-n // self.bucket))
        return self.bits_per_value * n + 32 * n_buckets

    def ratio(self, n: int) -> float:
        return _ratio(self, n)


@dataclasses.dataclass
class DGCTopK:
    """Time-domain top-k with raw f32 values (DGC's wire format); the
    payload is ``(values, int32 indices, orig_len)``."""

    theta: float = 0.99
    chunk: int = cfft.DEFAULT_CHUNK
    index_bits: int = 16

    def compress(self, x_flat: torch.Tensor, generator=None):
        del generator
        x2d, n = cfft.pad_to_chunks(x_flat, self.chunk)
        k = sparsify.keep_count(self.chunk, self.theta)
        idx = sparsify.topk_select(torch.abs(x2d), k)
        vals = packing.pack_by_indices(x2d, idx)
        return vals, idx.to(torch.int32), n

    def decompress(self, payload) -> torch.Tensor:
        vals, idx, n = payload
        dense = packing.unpack_by_indices(vals, idx, self.chunk)
        return dense.reshape(-1)[:n]

    def wire_bits(self, n: int) -> int:
        n_chunks = max(1, -(-n // self.chunk))
        k = sparsify.keep_count(self.chunk, self.theta)
        return n_chunks * k * (32 + self.index_bits)

    def ratio(self, n: int) -> float:
        return _ratio(self, n)


@dataclasses.dataclass
class AjiThreshold:
    """|g| >= tau thresholding, tau the theta-quantile of each chunk: with
    static shapes that is the per-chunk top-k boundary, so it is
    :class:`DGCTopK`'s selection."""

    theta: float = 0.99
    chunk: int = cfft.DEFAULT_CHUNK

    def _topk(self) -> DGCTopK:
        return DGCTopK(self.theta, self.chunk)

    def compress(self, x_flat: torch.Tensor, generator=None):
        return self._topk().compress(x_flat, generator)

    def decompress(self, payload) -> torch.Tensor:
        return self._topk().decompress(payload)

    def wire_bits(self, n: int) -> int:
        return self._topk().wire_bits(n)

    def ratio(self, n: int) -> float:
        return _ratio(self, n)


class OneBitSGD:
    """sign(g) * mean(|g|); the caller keeps the error-feedback residual."""

    def compress(self, x_flat: torch.Tensor, generator=None) -> ScaledCodes:
        del generator
        s = torch.mean(torch.abs(x_flat))
        codes = (x_flat >= 0).to(torch.int8) * 2 - 1
        return ScaledCodes(codes, s, x_flat.shape[0])

    def decompress(self, payload: ScaledCodes) -> torch.Tensor:
        return payload.codes.float() * payload.scale

    def wire_bits(self, n: int) -> int:
        return n + 32

    def ratio(self, n: int) -> float:
        return _ratio(self, n)
