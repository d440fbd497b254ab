"""The compressor protocol and payloads (port of ``repro.core.compressor``:
``FFTCompressor`` and its payloads).

    gradient --rFFT--> spectrum --theta-drop--> sparse --range-quant--> codes
             --pack--> (values, indices) payload --> wire

Stage execution is delegated to an engine backend (``kernels/engine.py``):
``reference`` (plain PyTorch ops), ``cuda`` (the hand-written kernels), or
``auto`` (``cuda`` for a CUDA tensor; on the CPU ``cuda``'s plain
versions where the config is kernel-eligible, else ``reference``).  Every
backend emits the same payload layout.  The entry points are the monolithic
``compress``/``decompress`` (one quantizer fit for the whole buffer), the
per-bucket loop ``compress_buckets`` (one fit per bucket) and the stacked
bucket executor ``compress_stacked``/``decompress_stacked`` (one fit per
bucket, one batched pass).  ``TimeDomainCompressor`` and the other
baselines are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import fft as cfft
from repro_torch.core.quantizer import FittedQuantizer

__all__ = [
    "FFTCompressorConfig",
    "FFTPayload",
    "StackedPayload",
    "stack_bucket_quant",
    "valid_chunk_mask",
    "FFTCompressor",
]


def valid_chunk_mask(sizes, max_chunks: int, chunk: int, device=None) -> torch.Tensor:
    """(n_buckets, max_chunks, 1) mask of the real chunk rows of a stacked
    bucket matrix: False on the zero-padding rows the uniform width added."""
    counts = torch.tensor([-(-int(s) // chunk) for s in sizes], device=device)
    return (torch.arange(max_chunks, device=device)[None, :] < counts[:, None])[:, :, None]


def stack_bucket_quant(q: FittedQuantizer) -> FittedQuantizer:
    """Vector fit (leaves ``(n_buckets,)``) -> leaves ``(n_buckets, 1, 1)``,
    which broadcast against ``(n_buckets, max_chunks, k)`` planes."""
    return q.map(lambda t: t.reshape(-1, 1, 1))


@dataclasses.dataclass
class FFTPayload:
    """One payload: quantized kept spectrum + int16 bin indices + fit."""

    re: torch.Tensor  # (c, k) codes, or f32 when quantization is off
    im: torch.Tensor
    idx: torch.Tensor  # (c, k) int16
    quant: Optional[FittedQuantizer]
    orig_len: int
    chunk: int


@dataclasses.dataclass
class StackedPayload:
    """Struct-of-arrays payload of one whole bucketed exchange: every plane
    carries a leading bucket axis, ``(n_buckets, max_chunks, k)``; the fit's
    leaves are ``(n_buckets, 1, 1)``.  A gathered payload has one more
    leading (worker) axis on every plane and leaf.  Rows past a bucket's
    true chunk count are padding: code 0 at index 0..k-1, decoding to 0."""

    re: torch.Tensor
    im: torch.Tensor
    idx: torch.Tensor
    quant: Optional[FittedQuantizer]
    sizes: Tuple[int, ...]
    chunk: int

    def chunk_counts(self) -> Tuple[int, ...]:
        return tuple(-(-s // self.chunk) for s in self.sizes)

    def bucket_payloads(self) -> list:
        """Slice back to the per-bucket payloads (true chunk rows only)."""
        out = []
        for b, (size, c_b) in enumerate(zip(self.sizes, self.chunk_counts())):
            q = None if self.quant is None else self.quant.map(lambda t: t[b, 0, 0])
            out.append(FFTPayload(self.re[b, :c_b], self.im[b, :c_b], self.idx[b, :c_b],
                                  q, size, self.chunk))
        return out


@dataclasses.dataclass(frozen=True)
class FFTCompressorConfig:
    """Static knobs of the paper's pipeline."""

    theta: float = 0.7  # frequency drop-out ratio
    n_bits: int = 8
    m_bits: int = 3
    chunk: int = cfft.DEFAULT_CHUNK
    quantize: bool = True
    range_mode: str = "auto"  # "auto": per-call min/max; "fixed": use fixed_range
    fixed_range: Tuple[float, float] = (-1.0, 1.0)  # paper: [-1,1] AlexNet, [-6,6] ResNet
    index_bits: int = 16
    backend: str = "reference"  # reference | cuda | auto (kernels/engine.py)
    selector: str = "sort"  # sort | sampled | bisect | auto (core/selection.py)
    sample_rate: float = 1.0 / 64.0
    tau_refine_iters: int = 16
    selector_seed: int = 0

    def __post_init__(self):
        if self.chunk > 32767:
            raise ValueError(f"chunk must be <= 32767 (int16 indices), got {self.chunk}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        from repro_torch.core.selection import SELECTOR_NAMES

        if self.selector not in SELECTOR_NAMES:
            raise ValueError(
                f"unknown selector {self.selector!r}; expected one of {SELECTOR_NAMES}")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got {self.sample_rate}")
        if self.tau_refine_iters < 1:
            raise ValueError(f"tau_refine_iters must be >= 1, got {self.tau_refine_iters}")
        from repro_torch.kernels.engine import BACKEND_NAMES

        if self.backend not in BACKEND_NAMES:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKEND_NAMES}")


class FFTCompressor:
    """The paper's pipeline; owns the config and delegates stage execution
    to the engine backend named by ``config.backend``."""

    def __init__(self, config: Optional[FFTCompressorConfig] = None):
        from repro_torch.kernels import engine

        self.config = config if config is not None else FFTCompressorConfig()
        self.backend = engine.get_backend(self.config.backend)

    def compress(self, x_flat: torch.Tensor) -> FFTPayload:
        """One monolithic payload of the whole flat buffer (one fit)."""
        return self.backend.compress(self.config, x_flat)

    def decompress(self, payload: FFTPayload) -> torch.Tensor:
        """Inverse of :meth:`compress` -> flat f32 of ``payload.orig_len``."""
        return self.backend.decompress(payload)

    def compress_buckets(self, bucket_flats) -> list:
        """Per-bucket loop: one payload, and one quantizer fit, per bucket."""
        return self.backend.compress_buckets(self.config, bucket_flats)

    def compress_stacked(self, stacked: torch.Tensor, sizes) -> StackedPayload:
        """Compress every bucket row of a ``(n_buckets, padded_size)`` matrix
        (``bucketing.stack_buckets``) in one batched pass, one quantizer fit
        per bucket."""
        return self.backend.compress_stacked(self.config, stacked, sizes)

    def decompress_stacked(self, payload: StackedPayload) -> torch.Tensor:
        """Inverse of :meth:`compress_stacked` -> ``(n_buckets, padded_size)``."""
        return self.backend.decompress_stacked(payload)

    def decompress_spectrum(self, payload) -> torch.Tensor:
        """Payload -> dense complex spectrum ``(..., chunk//2+1)``."""
        return self.backend.decompress_spectrum(payload)

    def wire_bits(self, n: int) -> int:
        """Static wire estimate of one monolithic payload of ``n`` values."""
        from repro_torch.kernels import engine

        return engine.wire_bits(self.config, n)
