"""The compressor protocol and payloads (port of ``repro.core.compressor``).

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
bucket, one batched pass).

The paper's comparison compressors share the protocol (``compress``,
``decompress``, ``wire_bits``, ``ratio``): ``TimeDomainCompressor`` (top-k
of the raw chunk values with the same range quantizer; Fig. 12),
``QuantOnlyCompressor`` and ``NoCompression``; ``core/baselines.py`` holds
the rest.  They are plain PyTorch, as the reference's are plain ``jnp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import fft as cfft
from repro_torch.core import packing, selection, sparsify
from repro_torch.core.quantizer import (
    FittedQuantizer,
    RangeQuantConfig,
    decode as q_decode,
    encode as q_encode,
    fit_quantizer,
)

__all__ = [
    "FFTCompressorConfig",
    "FFTPayload",
    "StackedPayload",
    "drop_outside_indices",
    "stack_bucket_quant",
    "valid_chunk_mask",
    "FFTCompressor",
    "TimeDomainCompressor",
    "QuantOnlyCompressor",
    "NoCompression",
]


def valid_chunk_mask(sizes, max_chunks: int, chunk: int, device=None) -> torch.Tensor:
    """(n_buckets, max_chunks, 1) mask of the real chunk rows of a stacked
    bucket matrix: False on the zero-padding rows the uniform width added.
    The counts are copied to ``device``: on a card the host waits for it."""
    tracing.count("host_syncs")
    counts = torch.tensor([-(-int(s) // chunk) for s in sizes], device=device)
    return (torch.arange(max_chunks, device=device)[None, :] < counts[:, None])[:, :, None]


def stack_bucket_quant(q: FittedQuantizer) -> FittedQuantizer:
    """Vector fit (leaves ``(n_buckets,)``) -> leaves ``(n_buckets, 1, 1)``,
    which broadcast against ``(n_buckets, max_chunks, k)`` planes."""
    return q.map(lambda t: t.reshape(-1, 1, 1))


@dataclasses.dataclass
class FFTPayload:
    """One payload: quantized kept spectrum + int16 bin indices + fit.
    ``has_im=False`` marks a purely real (time-domain) payload, whose ``im``
    plane is empty, ``(c, 0)``, so the collectives move one value plane."""

    re: torch.Tensor  # (c, k) codes, or f32 when quantization is off
    im: torch.Tensor  # (c, k), or (c, 0) when has_im is False
    idx: torch.Tensor  # (c, k) int16
    quant: Optional[FittedQuantizer]
    orig_len: int
    chunk: int
    has_im: bool = True

    def validate(self, level: str = "cheap") -> torch.Tensor:
        """Structural sanity check -> bool tensor: index bounds against the
        chunk width, finite float value planes, sane quantizer params
        (``full``'s checksum comparison lives in ``comms.faults``, which
        knows the compress-time checksums)."""
        return _validate_planes(self, level)

    def to_bytes(self) -> bytes:
        """A self-describing blob (``core.bytecodec``)."""
        from repro_torch.core import bytecodec

        return bytecodec.to_bytes(self)

    @staticmethod
    def from_bytes(blob: bytes, device) -> "FFTPayload":
        """The payload of a blob of either package, on ``device``."""
        return _from_bytes(blob, device, FFTPayload)


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
    has_im: bool = True

    def chunk_counts(self) -> Tuple[int, ...]:
        return tuple(-(-s // self.chunk) for s in self.sizes)

    def bucket_payloads(self) -> list:
        """Slice back to the per-bucket payloads (true chunk rows only)."""
        out = []
        for b, (size, c_b) in enumerate(zip(self.sizes, self.chunk_counts())):
            q = None if self.quant is None else self.quant.map(lambda t: t[b, 0, 0])
            out.append(FFTPayload(self.re[b, :c_b], self.im[b, :c_b], self.idx[b, :c_b],
                                  q, size, self.chunk, self.has_im))
        return out

    def validate(self, level: str = "cheap") -> torch.Tensor:
        """See :meth:`FFTPayload.validate`."""
        return _validate_planes(self, level)

    def to_bytes(self) -> bytes:
        """A self-describing blob (``core.bytecodec``)."""
        from repro_torch.core import bytecodec

        return bytecodec.to_bytes(self)

    @staticmethod
    def from_bytes(blob: bytes, device) -> "StackedPayload":
        """The payload of a blob of either package, on ``device``."""
        return _from_bytes(blob, device, StackedPayload)


def _from_bytes(blob: bytes, device, cls):
    from repro_torch.core import bytecodec

    payload = bytecodec.from_bytes(blob, device)
    if not isinstance(payload, cls):
        raise ValueError(f"blob holds a {type(payload).__name__}, not a {cls.__name__}")
    return payload


def _validate_planes(payload, level: str) -> torch.Tensor:
    """The checks shared by both payloads, as one bool tensor."""
    ok = torch.ones((), dtype=torch.bool, device=payload.idx.device)
    if level == "off":
        return ok
    ok = ok & (payload.idx >= 0).all() & (payload.idx < payload.chunk).all()
    for plane in (payload.re, payload.im):
        if plane.is_floating_point() and plane.numel():
            ok = ok & torch.isfinite(plane).all()
    q = payload.quant
    if q is not None:
        ok = ok & torch.isfinite(q.eps).all() & (q.eps > 0).all()
        ok = ok & torch.isfinite(q.vmax).all() & torch.isfinite(q.vmin).all()
        ok = ok & (q.vmin <= q.vmax).all()
        ok = ok & ((q.p_codes >= 1) & (q.p_codes <= q.config.n_codes - 2)).all()
    return ok


def drop_outside_indices(payload):
    """The payload with every slot whose index lies outside the decoder's
    bins (``chunk//2 + 1`` for a spectrum, ``chunk`` in the time domain)
    pointed at bin 0 with code 0, which decodes to 0: the reference's jnp
    scatter drops such slots, torch's raises, and on the card a bad index
    would be a bad memory access.  A payload without such slots comes back
    with the same values."""
    width = payload.chunk // 2 + 1 if payload.has_im else payload.chunk
    bad = (payload.idx < 0) | (payload.idx >= width)
    zero = torch.zeros((), dtype=payload.re.dtype, device=payload.re.device)
    out = dataclasses.replace(payload, idx=torch.where(bad, 0, payload.idx),
                              re=torch.where(bad, zero, payload.re))
    if payload.im.numel():
        out = dataclasses.replace(out, im=torch.where(bad, zero, payload.im))
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
        tracing.count("exchange.compress_passes")
        return self.backend.compress(self.config, x_flat)

    def decompress(self, payload: FFTPayload) -> torch.Tensor:
        """Inverse of :meth:`compress` -> flat f32 of ``payload.orig_len``."""
        return self.backend.decompress(payload)

    def compress_buckets(self, bucket_flats) -> list:
        """Per-bucket loop: one payload, and one quantizer fit, per bucket."""
        tracing.count("exchange.compress_passes")
        return self.backend.compress_buckets(self.config, bucket_flats)

    def compress_stacked(self, stacked: torch.Tensor, sizes) -> StackedPayload:
        """Compress every bucket row of a ``(n_buckets, padded_size)`` matrix
        (``bucketing.stack_buckets``) in one batched pass, one quantizer fit
        per bucket."""
        tracing.count("exchange.compress_passes")
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


def _empty_im(vals: torch.Tensor) -> torch.Tensor:
    """The empty imaginary plane of a purely real payload."""
    return vals.new_zeros(vals.shape[:-1] + (0,))


class TimeDomainCompressor:
    """DGC/Aji-style top-k of the raw chunk values with the same range
    quantizer (the paper's Fig. 12: frequency against time domain at the
    same theta).  Plain PyTorch, as the reference's is plain ``jnp``."""

    def __init__(self, config: Optional[FFTCompressorConfig] = None):
        self.config = config if config is not None else FFTCompressorConfig()
        self._qcfg = RangeQuantConfig(self.config.n_bits, self.config.m_bits)

    def _select(self, x: torch.Tensor, k: int) -> torch.Tensor:
        cfg = self.config
        idx, _ = selection.select_indices(
            torch.abs(x), k, cfg.selector, sample_rate=cfg.sample_rate,
            refine_iters=cfg.tau_refine_iters, seed=cfg.selector_seed)
        return idx

    def compress(self, x_flat: torch.Tensor, generator=None) -> FFTPayload:
        """One payload of the whole buffer, one quantizer fit; deterministic
        (``generator`` is accepted for the protocol and unused)."""
        del generator
        cfg = self.config
        x2d, n = cfft.pad_to_chunks(x_flat.float(), cfg.chunk)
        k = sparsify.keep_count(cfg.chunk, cfg.theta)
        idx = self._select(x2d, k)
        vals = packing.pack_by_indices(x2d, idx)
        quant = None
        if cfg.quantize:
            quant = fit_quantizer(vals.min(), vals.max(), self._qcfg)
            vals = q_encode(vals, quant)
        return FFTPayload(vals, _empty_im(vals), idx.to(torch.int16), quant, n, cfg.chunk,
                          has_im=False)

    def decompress(self, payload: FFTPayload) -> torch.Tensor:
        vals = payload.re
        if payload.quant is not None:
            vals = q_decode(vals, payload.quant)
        dense = packing.unpack_by_indices(vals.float(), payload.idx, payload.chunk)
        return dense.reshape(-1)[: payload.orig_len]

    def compress_stacked(self, stacked: torch.Tensor, sizes) -> StackedPayload:
        """One batched selection over the ``(n_buckets, padded_size)``
        matrix and one quantizer fit per bucket, the padding chunks masked
        out of its range."""
        cfg = self.config
        sizes = tuple(int(s) for s in sizes)
        n_buckets, padded = stacked.shape
        c_max = padded // cfg.chunk
        x3 = stacked.reshape(n_buckets, c_max, cfg.chunk).float()
        k = sparsify.keep_count(cfg.chunk, cfg.theta)
        idx = self._select(x3, k)
        vals = packing.pack_by_indices(x3, idx)
        quant = None
        if cfg.quantize:
            valid = valid_chunk_mask(sizes, c_max, cfg.chunk, stacked.device)
            lo = torch.where(valid, vals, float("inf")).amin(dim=(1, 2))
            hi = torch.where(valid, vals, -float("inf")).amax(dim=(1, 2))
            quant = stack_bucket_quant(fit_quantizer(lo, hi, self._qcfg))
            vals = q_encode(vals, quant)
        return StackedPayload(vals, _empty_im(vals), idx.to(torch.int16), quant, sizes,
                              cfg.chunk, has_im=False)

    def decompress_stacked(self, payload: StackedPayload) -> torch.Tensor:
        vals = payload.re
        if payload.quant is not None:
            vals = q_decode(vals, payload.quant)
        n_buckets, c_max, k = vals.shape
        dense = packing.unpack_by_indices(vals.float().reshape(n_buckets * c_max, k),
                                          payload.idx.reshape(n_buckets * c_max, k),
                                          payload.chunk)
        return dense.reshape(n_buckets, c_max * payload.chunk)

    def wire_bits(self, n: int) -> int:
        cfg = self.config
        n_chunks = max(1, -(-n // cfg.chunk))
        k = sparsify.keep_count(cfg.chunk, cfg.theta)
        value_bits = cfg.n_bits if cfg.quantize else 32
        return n_chunks * k * (value_bits + cfg.index_bits) + 4 * 32

    def ratio(self, n: int) -> float:
        return 32.0 * n / self.wire_bits(n)


class QuantOnlyCompressor:
    """Range-based N-bit quantization without sparsification (ablation)."""

    def __init__(self, n_bits: int = 8, m_bits: int = 3):
        self._qcfg = RangeQuantConfig(n_bits, m_bits)
        self.n_bits = n_bits

    def compress(self, x_flat: torch.Tensor, generator=None):
        del generator
        quant = fit_quantizer(x_flat.min(), x_flat.max(), self._qcfg)
        return q_encode(x_flat, quant), quant

    def decompress(self, payload):
        codes, quant = payload
        return q_decode(codes, quant)

    def wire_bits(self, n: int) -> int:
        return n * self.n_bits + 4 * 32

    def ratio(self, n: int) -> float:
        return 32.0 * n / self.wire_bits(n)


class NoCompression:
    """Identity compressor (the paper's 'orig' baseline)."""

    def compress(self, x_flat: torch.Tensor, generator=None):
        del generator
        return x_flat

    def decompress(self, payload):
        return payload

    def wire_bits(self, n: int) -> int:
        return 32 * n

    def ratio(self, n: int) -> float:
        return 1.0
