"""Compressor engine: stage-execution backends (port of
``repro.kernels.engine``).

Every backend implements the compressor's entry points: ``compress`` /
``decompress`` (one monolithic payload, one quantizer fit),
``compress_buckets`` (the per-bucket loop), ``compress_stacked`` /
``decompress_stacked`` (every bucket in one batched pass, one fit per
bucket) and ``decompress_spectrum``.

* ``reference`` -- plain PyTorch ops: rfft -> selector -> gather ->
  range-quant encode (one bucket at a time in ``compress_stacked``); packs
  magnitude-descending under the ``sort`` selector and index-ascending under
  the threshold selectors.
* ``cuda``      -- the hand-written kernels, mirroring the reference's
  ``PallasBackend`` line for line: ``torch.fft.rfft`` for the forward
  transform (as the reference keeps XLA's rfft), the threshold kernel (B4
  under ``sampled``, which also gives the mid-gap tau; B1 under
  ``sort``/``bisect``, the mid-gap then plain ops) and the range fit as
  plain ops, then ONE fused compress launch (B2) over every
  chunk row; decompress is ONE fused decompress launch (B3).  Where the
  config does not fuse end to end it degrades stage by stage: with
  ``quantize=False`` compress runs the threshold kernel, the pack kernel
  (B6) and a gather; a quantized payload chunked at other than 4096 decodes
  with the range-quant kernel (B5) and then scatters and irffts as plain
  ops.
* ``auto``      -- ``cuda`` for every input on a CUDA device (it degrades
  stage by stage where the config does not fuse, so nothing on the card
  runs as plain ops); on the CPU, compress takes ``cuda`` (the kernels'
  plain versions) where ``kernel_eligibility`` holds and ``reference``
  otherwise, and decompress takes ``reference``.

Each kernel wrapper picks by device (a CPU tensor runs the kernel's plain
version, a CUDA tensor the kernel), so the ``cuda`` backend runs on the CPU
through the plain versions in the tests.
``decompress_spectrum`` is shared by every backend and stays plain.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import fft as cfft
from repro_torch.core import packing, selection, sparsify
from repro_torch.core.compressor import (
    FFTPayload,
    StackedPayload,
    drop_outside_indices,
    stack_bucket_quant,
    valid_chunk_mask,
)
from repro_torch.core.quantizer import (
    RangeQuantConfig,
    decode as q_decode,
    encode as q_encode,
    fit_quantizer,
)
from repro_torch.kernels import (fused_compress, fused_decompress, ops, range_quant,
                                 sampled_threshold, topk_threshold)

__all__ = [
    "BACKEND_NAMES",
    "KERNEL_CHUNK",
    "CompressorBackend",
    "ReferenceBackend",
    "CudaBackend",
    "AutoBackend",
    "get_backend",
    "kernel_eligibility",
    "wire_bits",
]

BACKEND_NAMES = ("reference", "cuda", "auto")
KERNEL_CHUNK = fused_decompress.CHUNK


def _keep_k(cfg) -> int:
    return sparsify.keep_count(cfg.chunk // 2 + 1, cfg.theta)


def _weighted_magnitude(re, im, w):
    """The canonical ranking magnitude every backend uses: sqrt(re²+im²)·w
    (the fused kernel's in-register form; a complex abs can differ by an
    ulp and flip kept-set boundaries)."""
    return torch.sqrt(re * re + im * im) * w


def _qcfg(cfg) -> RangeQuantConfig:
    return RangeQuantConfig(cfg.n_bits, cfg.m_bits)


def _selector_tau(cfg, mag, k: int, sel: str):
    return selection.selector_tau(mag, k, sel, sample_rate=cfg.sample_rate,
                                  refine_iters=cfg.tau_refine_iters, seed=cfg.selector_seed)


def _kernel_taus(cfg, mag2d, k: int, sel: str):
    """Threshold-kernel dispatch: (tau_k, the mid-gap tau), each (r,1).
    One threshold-kernel pass defines the kept set, count(>= tau_k) >= k;
    the mid-gap tau sits in the middle of the gap to the largest dropped
    magnitude, where an ulp of recompute noise inside the fused kernel
    cannot flip a comparison.  ``sampled`` runs the sampled kernel (B4),
    which gives both in its one launch; ``sort`` and ``bisect`` run the full
    bisection kernel (B1) and the mid-gap as plain ops."""
    if sel == "sampled":
        tau_k, _, tau = sampled_threshold.sampled_select(
            mag2d, k=k, sample_rate=cfg.sample_rate,
            refine_iters=cfg.tau_refine_iters, seed=cfg.selector_seed)
        return tau_k, tau
    tau_k, _ = topk_threshold.threshold(mag2d, k=k)
    return tau_k, selection.mid_gap(mag2d, tau_k)


def _pack_unquantized(cfg, re, im, mag, k: int, sel: str):
    """The per-stage route for ``quantize=False``: the threshold kernel, the
    pack kernel (B6) on the magnitudes, and a gather of re and im at the
    packed indices -> (re_k, im_k, idx int16), each ``(rows, k)``."""
    with tracing.span("exchange.select"):
        tau, _ = _kernel_taus(cfg, mag, k, sel)
    with tracing.span("exchange.encode"):
        mvals, idx = ops.pack_threshold(mag, tau, k)  # width pad_k(k)
        valid = mvals != 0
        bins = idx.long()
        re_k = torch.gather(re, -1, bins) * valid
        im_k = torch.gather(im, -1, bins) * valid
        return re_k[:, :k], im_k[:, :k], idx[:, :k].to(torch.int16)


def _masked_range(mask, re, im, dims):
    """(lo, hi) of re and im over ``mask``, reduced over ``dims``."""
    lo = torch.minimum(torch.where(mask, re, torch.inf).amin(dim=dims),
                       torch.where(mask, im, torch.inf).amin(dim=dims))
    hi = torch.maximum(torch.where(mask, re, -torch.inf).amax(dim=dims),
                       torch.where(mask, im, -torch.inf).amax(dim=dims))
    return lo, hi


def _bucket_rows(quant, n_buckets: int, c_max: int):
    """Per-bucket (eps, P) -> per-row vectors (each bucket's fit repeated
    over its chunk rows)."""
    return (quant.eps.reshape(n_buckets).repeat_interleave(c_max),
            quant.p_codes.reshape(n_buckets).repeat_interleave(c_max))


def _scatter_spectrum(idx, kept_re, kept_im, f_bins: int) -> torch.Tensor:
    """Additive scatter of kept coefficients into dense complex rows
    ``(..., f_bins)``; polymorphic over the leading axes.  Padding slots
    (0 at index 0) add nothing."""
    lead = kept_re.shape[:-1]
    k = kept_re.shape[-1]
    rows_i = idx.reshape(-1, k).long()
    out = []
    for kept in (kept_re, kept_im):
        dense = torch.zeros((rows_i.shape[0], f_bins), dtype=torch.float32,
                            device=kept.device)
        dense.scatter_add_(-1, rows_i, kept.reshape(-1, k).float())
        out.append(dense)
    return torch.complex(out[0], out[1]).reshape(lead + (f_bins,))


def wire_bits(cfg, n: int) -> int:
    """Static wire estimate of one monolithic payload."""
    n_chunks = max(1, -(-n // cfg.chunk))
    k = _keep_k(cfg)
    value_bits = 2 * (cfg.n_bits if cfg.quantize else 32)
    return n_chunks * k * (value_bits + cfg.index_bits) + 4 * 32


def kernel_eligibility(cfg) -> Tuple[bool, str]:
    """Is the fully fused kernel pipeline available for this config?"""
    reasons = []
    if cfg.chunk != KERNEL_CHUNK:
        reasons.append(f"chunk={cfg.chunk} != {KERNEL_CHUNK} (fused_decompress is "
                       "specialized to 4096-pt chunks)")
    if not cfg.quantize:
        reasons.append("quantize=False (the fused kernels quantize in-register)")
    return (not reasons, "; ".join(reasons))


class CompressorBackend:
    """Stage-execution strategy behind the compressor protocol."""

    name = "base"

    def compress(self, cfg, x_flat: torch.Tensor) -> FFTPayload:
        raise NotImplementedError

    def compress_buckets(self, cfg, bucket_flats: Sequence[torch.Tensor]) -> list:
        """Per-bucket loop: each bucket fits its OWN quantizer range."""
        return [self.compress(cfg, b) for b in bucket_flats]

    def compress_stacked(self, cfg, stacked: torch.Tensor, sizes) -> StackedPayload:
        raise NotImplementedError

    def decompress_spectrum(self, payload) -> torch.Tensor:
        """Payload -> dense complex spectrum (..., chunk//2+1); batch-aware
        over leading axes (buckets, workers)."""
        re, im = payload.re, payload.im
        if payload.quant is not None:
            re, im = q_decode(re, payload.quant), q_decode(im, payload.quant)
        return _scatter_spectrum(payload.idx, re, im, payload.chunk // 2 + 1)

    def decompress(self, payload: FFTPayload) -> torch.Tensor:
        """FFTPayload -> flat f32 of ``payload.orig_len``."""
        return cfft.chunked_irfft(self.decompress_spectrum(payload), payload.orig_len,
                                  payload.chunk)

    def decompress_stacked(self, payload: StackedPayload) -> torch.Tensor:
        """StackedPayload -> ``(n_buckets, padded_size)`` time domain."""
        return cfft.irfft_rows(self.decompress_spectrum(payload), payload.chunk)


class ReferenceBackend(CompressorBackend):
    """Plain ops; per-bucket quantizer ranges mask the zero-padding chunks
    out of ``compress_stacked``.  A threshold selector's sentinel index
    (``cols``, in a row with fewer than k values >= tau, such as an all-NaN
    row) packs NaN and is dropped when decoded, as the reference's jnp
    gather and scatter treat it; the cuda backend's kernels emit no such
    index."""

    name = "reference"

    def decompress_spectrum(self, payload) -> torch.Tensor:
        return super().decompress_spectrum(drop_outside_indices(payload))

    def compress(self, cfg, x_flat):
        with tracing.span("exchange.fft"):
            freqs, n = cfft.chunked_rfft(x_flat, cfg.chunk)
        k = _keep_k(cfg)
        with tracing.span("exchange.select"):
            w = cfft.hermitian_weights(cfg.chunk, x_flat.device)
        with tracing.span("exchange.fft"):
            re_p, im_p = freqs.real.contiguous(), freqs.imag.contiguous()
        with tracing.span("exchange.select"):
            mag = _weighted_magnitude(re_p, im_p, w)
            sel = selection.resolve_selector(cfg.selector, mag.shape[-1])
            if sel == "sort":
                idx = sparsify.topk_select(mag, k)
                tau = None
            else:
                # threshold selector: tau + one count-and-compact pass; slots
                # come out index-ascending (the cuda backend's order)
                tau = _selector_tau(cfg, mag, k, sel)
                idx = selection.count_compact(mag, tau, k)
        with tracing.span("exchange.encode"):
            re = packing.pack_by_indices(re_p, idx)
            im = packing.pack_by_indices(im_p, idx)
        quant = None
        if cfg.quantize:
            with tracing.span("exchange.fit"):
                if tau is None:
                    quant = self._fit(cfg, re, im)
                else:
                    # fit over the PRE-truncation tau mask -- the set the cuda
                    # backend fits over, so codes agree under every selector
                    quant = self._fit_masked(cfg, re_p, im_p, mag >= tau)
            with tracing.span("exchange.encode"):
                re, im = q_encode(re, quant), q_encode(im, quant)
        with tracing.span("exchange.encode"):
            return FFTPayload(re, im, idx.to(torch.int16), quant, n, cfg.chunk)

    def _fit(self, cfg, re, im):
        if cfg.range_mode == "fixed":
            lo, hi = cfg.fixed_range
            return fit_quantizer(lo, hi, _qcfg(cfg), device=re.device)
        lo = torch.minimum(re.amin(), im.amin())
        hi = torch.maximum(re.amax(), im.amax())
        return fit_quantizer(lo, hi, _qcfg(cfg))

    def _fit_masked(self, cfg, re_p, im_p, mask):
        """Range fit over masked spectrum planes -- expression for
        expression the cuda backend's fit."""
        if cfg.range_mode == "fixed":
            lo, hi = cfg.fixed_range
            return fit_quantizer(lo, hi, _qcfg(cfg), device=re_p.device)
        lo, hi = _masked_range(mask, re_p, im_p, None)
        return fit_quantizer(lo, hi, _qcfg(cfg))

    def compress_stacked(self, cfg, stacked, sizes):
        sizes = tuple(int(s) for s in sizes)
        n_buckets, padded = stacked.shape
        c_max = padded // cfg.chunk
        k = _keep_k(cfg)
        with tracing.span("exchange.select"):
            w = cfft.hermitian_weights(cfg.chunk, stacked.device)
            sel = selection.resolve_selector(cfg.selector, cfg.chunk // 2 + 1)
        with tracing.span("exchange.fit"):
            rows = torch.arange(c_max, device=stacked.device)
        res_re, res_im, res_idx, quants = [], [], [], []
        for b, x2d in enumerate(stacked.reshape(n_buckets, c_max, cfg.chunk)):
            c_b = -(-sizes[b] // cfg.chunk)
            with tracing.span("exchange.fft"):
                freqs = torch.fft.rfft(x2d.float(), dim=-1).to(torch.complex64)
                re_p, im_p = freqs.real.contiguous(), freqs.imag.contiguous()
            with tracing.span("exchange.select"):
                mag = _weighted_magnitude(re_p, im_p, w)
                if sel == "sort":
                    idx = sparsify.topk_select(mag, k)
                    tau = None
                else:
                    tau = _selector_tau(cfg, mag, k, sel)
                    idx = selection.count_compact(mag, tau, k)
            with tracing.span("exchange.encode"):
                re = packing.pack_by_indices(re_p, idx)
                im = packing.pack_by_indices(im_p, idx)
            if cfg.quantize:
                with tracing.span("exchange.fit"):
                    if cfg.range_mode == "fixed":
                        lo, hi = cfg.fixed_range
                    elif tau is None:
                        lo, hi = _masked_range((rows < c_b)[:, None], re, im, None)
                    else:
                        # pre-truncation tau mask, padding rows excluded
                        lo, hi = _masked_range((mag >= tau) & (rows < c_b)[:, None], re_p,
                                               im_p, None)
                    quant = fit_quantizer(lo, hi, _qcfg(cfg), device=stacked.device)
                with tracing.span("exchange.encode"):
                    re, im = q_encode(re, quant), q_encode(im, quant)
                quants.append(quant)
            res_re.append(re)
            res_im.append(im)
            res_idx.append(idx)
        quant = None
        if cfg.quantize:
            q0 = quants[0]
            with tracing.span("exchange.fit"):
                quant = stack_bucket_quant(type(q0)(
                    q0.config, *(torch.stack([getattr(q, f) for q in quants])
                                 for f in ("eps", "p_codes", "vmax", "vmin"))))
        with tracing.span("exchange.encode"):
            return StackedPayload(torch.stack(res_re), torch.stack(res_im),
                                  torch.stack(res_idx).to(torch.int16), quant, sizes,
                                  cfg.chunk)


class CudaBackend(CompressorBackend):
    """The hand-written kernels on the hot stages (mirrors the reference's
    ``PallasBackend``), per-stage kernels where the config does not fuse.

    compress:   rfft -> threshold kernel -> mid-gap tau -> range fit -> ONE
                fused compress launch over every chunk row -> slice the
                128-slot padding down to the keep count.  ``quantize=False``:
                threshold kernel -> pack kernel -> gather.
    decompress: ONE fused decompress launch (quantized, 4096-pt chunks);
                otherwise the range-quant decode kernel (quantized) and the
                shared scatter + irfft."""

    name = "cuda"

    @staticmethod
    def _planes(x2d):
        """rfft of (rows, chunk) -> contiguous re, im planes."""
        with tracing.span("exchange.fft"):
            freqs = torch.fft.rfft(x2d, dim=-1)
            return freqs.real.contiguous(), freqs.imag.contiguous()

    def compress(self, cfg, x_flat):
        with tracing.span("exchange.flat"):
            x2d, n = cfft.pad_to_chunks(x_flat.float(), cfg.chunk)
        re, im = self._planes(x2d)
        del x2d
        k = _keep_k(cfg)
        with tracing.span("exchange.select"):
            w = cfft.hermitian_weights(cfg.chunk, x_flat.device)
            mag = _weighted_magnitude(re, im, w)
            sel = selection.resolve_selector(cfg.selector, mag.shape[-1])
        if not cfg.quantize:
            return FFTPayload(*_pack_unquantized(cfg, re, im, mag, k, sel), None, n, cfg.chunk)
        with tracing.span("exchange.select"):
            _, tau = _kernel_taus(cfg, mag, k, sel)
        with tracing.span("exchange.fit"):
            if cfg.range_mode == "fixed":
                lo, hi = cfg.fixed_range
            else:
                lo, hi = _masked_range(mag >= tau, re, im, None)
            del mag
            quant = fit_quantizer(lo, hi, _qcfg(cfg), device=re.device)
        with tracing.span("exchange.encode"):
            rec, imc, idx, _ = fused_compress.fused_compress(
                re, im, w, quant.eps, quant.p_codes, tau, k_keep=k, n_bits=cfg.n_bits,
                m_bits=cfg.m_bits)
            return FFTPayload(rec[:, :k].contiguous(), imc[:, :k].contiguous(),
                              idx[:, :k].to(torch.int16), quant, n, cfg.chunk)

    def compress_stacked(self, cfg, stacked, sizes):
        sizes = tuple(int(s) for s in sizes)
        n_buckets, padded = stacked.shape
        c_max = padded // cfg.chunk
        rows = n_buckets * c_max
        re, im = self._planes(stacked.reshape(rows, cfg.chunk).float())
        k = _keep_k(cfg)
        with tracing.span("exchange.select"):
            w = cfft.hermitian_weights(cfg.chunk, stacked.device)
            mag = _weighted_magnitude(re, im, w)
            sel = selection.resolve_selector(cfg.selector, mag.shape[-1])
        if not cfg.quantize:
            re_k, im_k, idx = _pack_unquantized(cfg, re, im, mag, k, sel)
            return StackedPayload(re_k.reshape(n_buckets, c_max, k),
                                  im_k.reshape(n_buckets, c_max, k),
                                  idx.reshape(n_buckets, c_max, k), None, sizes, cfg.chunk)

        # the same one-threshold / mid-gap-tau contract as compress, over
        # every bucket's chunk rows in one threshold-kernel launch
        with tracing.span("exchange.select"):
            _, tau = _kernel_taus(cfg, mag, k, sel)
        with tracing.span("exchange.fit"):
            if cfg.range_mode == "fixed":
                lo = torch.full((n_buckets,), cfg.fixed_range[0], device=stacked.device)
                hi = torch.full((n_buckets,), cfg.fixed_range[1], device=stacked.device)
            else:
                # per-bucket fit over the kept set; padding rows (all-zero
                # chunks: tau 0, mask all-true) are excluded
                mask = (mag >= tau) & valid_chunk_mask(
                    sizes, c_max, cfg.chunk, stacked.device).reshape(rows, 1)
                lo, hi = _masked_range(mask.reshape(n_buckets, c_max, -1),
                                       re.reshape(n_buckets, c_max, -1),
                                       im.reshape(n_buckets, c_max, -1), (1, 2))
                del mask
            del mag
            quant = stack_bucket_quant(fit_quantizer(lo, hi, _qcfg(cfg)))
            # per-bucket params -> per-row vectors for the single fused launch
            eps_rows, p_rows = _bucket_rows(quant, n_buckets, c_max)
        with tracing.span("exchange.encode"):
            rec, imc, idx, _ = fused_compress.fused_compress(
                re, im, w, eps_rows, p_rows, tau, k_keep=k, n_bits=cfg.n_bits,
                m_bits=cfg.m_bits)
            return StackedPayload(
                rec[:, :k].reshape(n_buckets, c_max, k).contiguous(),
                imc[:, :k].reshape(n_buckets, c_max, k).contiguous(),
                idx[:, :k].to(torch.int16).reshape(n_buckets, c_max, k),
                quant, sizes, cfg.chunk)

    def decompress(self, payload: FFTPayload) -> torch.Tensor:
        if payload.quant is not None and payload.chunk == KERNEL_CHUNK:
            x2d = fused_decompress.fused_decompress(
                payload.re.contiguous(), payload.im.contiguous(), payload.idx.contiguous(),
                payload.quant.eps, payload.quant.p_codes, m_bits=payload.quant.config.m_bits)
            return x2d.reshape(-1)[: payload.orig_len]
        if payload.quant is not None:
            payload = FFTPayload(ops.quant_decode(payload.re, payload.quant),
                                 ops.quant_decode(payload.im, payload.quant),
                                 payload.idx, None, payload.orig_len, payload.chunk)
        return super().decompress(payload)

    def decompress_stacked(self, payload: StackedPayload) -> torch.Tensor:
        if payload.quant is None:
            return super().decompress_stacked(payload)
        n_buckets, c_max, k = payload.re.shape
        rows = n_buckets * c_max
        eps_rows, p_rows = _bucket_rows(payload.quant, n_buckets, c_max)
        qcfg = payload.quant.config
        if payload.chunk == KERNEL_CHUNK:
            x2d = fused_decompress.fused_decompress(
                payload.re.reshape(rows, k).contiguous(),
                payload.im.reshape(rows, k).contiguous(),
                payload.idx.reshape(rows, k).contiguous(), eps_rows, p_rows,
                m_bits=qcfg.m_bits)
            return x2d.reshape(n_buckets, c_max * KERNEL_CHUNK)
        re, im = (range_quant.decode(plane.reshape(rows, k).contiguous(), eps_rows, p_rows,
                                     n_bits=qcfg.n_bits, m_bits=qcfg.m_bits)
                  .reshape(n_buckets, c_max, k) for plane in (payload.re, payload.im))
        return super().decompress_stacked(
            StackedPayload(re, im, payload.idx, None, payload.sizes, payload.chunk))


class AutoBackend(CompressorBackend):
    """``cuda`` for every input on a CUDA device: it runs the fused kernels
    where the config fuses and degrades stage by stage where it does not
    (payloads carry no backend tag).  On the CPU, compress runs ``cuda``'s
    plain versions where the config fuses and ``reference`` otherwise;
    decompress runs ``reference``."""

    name = "auto"

    def __init__(self):
        self._reference = ReferenceBackend()
        self._cuda = CudaBackend()

    def _pick(self, cfg, x) -> CompressorBackend:
        if x.device.type == "cuda" or kernel_eligibility(cfg)[0]:
            return self._cuda
        return self._reference

    def _pick_payload(self, payload) -> CompressorBackend:
        return self._cuda if payload.re.device.type == "cuda" else self._reference

    def compress(self, cfg, x_flat):
        return self._pick(cfg, x_flat).compress(cfg, x_flat)

    def compress_stacked(self, cfg, stacked, sizes):
        return self._pick(cfg, stacked).compress_stacked(cfg, stacked, sizes)

    def decompress(self, payload):
        return self._pick_payload(payload).decompress(payload)

    def decompress_stacked(self, payload):
        return self._pick_payload(payload).decompress_stacked(payload)


_BACKENDS = {"reference": ReferenceBackend(), "cuda": CudaBackend(), "auto": AutoBackend()}


def get_backend(name: str) -> CompressorBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor backend {name!r}; expected one of {BACKEND_NAMES}") from None
