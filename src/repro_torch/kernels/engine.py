"""Compressor engine: stage-execution backends (port of
``repro.kernels.engine``, the stacked entry points).

* ``reference`` -- plain PyTorch ops: rfft -> selector -> gather ->
  range-quant encode, one bucket at a time; packs magnitude-descending under
  the ``sort`` selector and index-ascending under the threshold selectors.
* ``cuda``      -- the hand-written kernels, mirroring the reference's
  ``PallasBackend`` line for line: ``torch.fft.rfft`` for the forward
  transform (as the reference keeps XLA's rfft), the threshold kernel (B4
  under ``sampled``, B1 under ``sort``/``bisect``), the mid-gap tau and the
  masked per-bucket fit as plain ops, then ONE fused compress launch (B2)
  over every bucket row; the local roundtrip decompresses with ONE fused
  decompress launch (B3).
* ``auto``      -- ``cuda`` whenever ``kernel_eligibility`` holds, else
  ``reference``.

The engine picks by eligibility; each kernel wrapper picks by device (a CPU
tensor runs the kernel's plain version, a CUDA tensor the kernel), so the
``cuda`` backend runs on the CPU through the plain versions in the tests.
``decompress_spectrum`` is shared by every backend and stays plain.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import fft as cfft
from repro_torch.core import packing, selection, sparsify
from repro_torch.core.compressor import (
    StackedPayload,
    stack_bucket_quant,
    valid_chunk_mask,
)
from repro_torch.core.quantizer import (
    RangeQuantConfig,
    decode as q_decode,
    encode as q_encode,
    fit_quantizer,
)
from repro_torch.kernels import (fused_compress, fused_decompress, sampled_threshold,
                                 topk_threshold)

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


def _kernel_tau(cfg, mag2d, k: int, sel: str):
    """Threshold-kernel dispatch: (tau (r,1), count).  ``sort`` and
    ``bisect`` both run the full bisection kernel (B1); ``sampled`` runs the
    sampled-bracket kernel (B4)."""
    if sel == "sampled":
        return sampled_threshold.sampled_select(
            mag2d, k=k, sample_rate=cfg.sample_rate,
            refine_iters=cfg.tau_refine_iters, seed=cfg.selector_seed)
    return topk_threshold.threshold(mag2d, k=k)


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

    def compress_stacked(self, cfg, stacked: torch.Tensor, sizes) -> StackedPayload:
        raise NotImplementedError

    def decompress_spectrum(self, payload) -> torch.Tensor:
        """Payload -> dense complex spectrum (..., chunk//2+1); batch-aware
        over leading axes (buckets, workers)."""
        re, im = payload.re, payload.im
        if payload.quant is not None:
            re, im = q_decode(re, payload.quant), q_decode(im, payload.quant)
        return _scatter_spectrum(payload.idx, re, im, payload.chunk // 2 + 1)

    def decompress_stacked(self, payload: StackedPayload) -> torch.Tensor:
        """StackedPayload -> ``(n_buckets, padded_size)`` time domain."""
        return cfft.irfft_rows(self.decompress_spectrum(payload), payload.chunk)


class ReferenceBackend(CompressorBackend):
    """Plain ops, one bucket at a time; per-bucket quantizer ranges mask the
    zero-padding chunks out."""

    name = "reference"

    def compress_stacked(self, cfg, stacked, sizes):
        sizes = tuple(int(s) for s in sizes)
        n_buckets, padded = stacked.shape
        c_max = padded // cfg.chunk
        k = _keep_k(cfg)
        w = cfft.hermitian_weights(cfg.chunk, stacked.device)
        sel = selection.resolve_selector(cfg.selector, cfg.chunk // 2 + 1)
        rows = torch.arange(c_max, device=stacked.device)
        res_re, res_im, res_idx, quants = [], [], [], []
        for b, x2d in enumerate(stacked.reshape(n_buckets, c_max, cfg.chunk)):
            c_b = -(-sizes[b] // cfg.chunk)
            freqs = torch.fft.rfft(x2d.float(), dim=-1).to(torch.complex64)
            re_p, im_p = freqs.real.contiguous(), freqs.imag.contiguous()
            mag = _weighted_magnitude(re_p, im_p, w)
            if sel == "sort":
                idx = sparsify.topk_select(mag, k)
                tau = None
            else:
                tau = _selector_tau(cfg, mag, k, sel)
                idx = selection.count_compact(mag, tau, k)
            re = packing.pack_by_indices(re_p, idx)
            im = packing.pack_by_indices(im_p, idx)
            if cfg.quantize:
                if tau is None:
                    valid = (rows < c_b)[:, None]
                    lo = torch.minimum(torch.where(valid, re, torch.inf).amin(),
                                       torch.where(valid, im, torch.inf).amin())
                    hi = torch.maximum(torch.where(valid, re, -torch.inf).amax(),
                                       torch.where(valid, im, -torch.inf).amax())
                else:
                    # pre-truncation tau mask, padding rows excluded
                    m = (mag >= tau) & (rows < c_b)[:, None]
                    lo = torch.minimum(torch.where(m, re_p, torch.inf).amin(),
                                       torch.where(m, im_p, torch.inf).amin())
                    hi = torch.maximum(torch.where(m, re_p, -torch.inf).amax(),
                                       torch.where(m, im_p, -torch.inf).amax())
                quant = fit_quantizer(lo, hi, _qcfg(cfg), device=stacked.device)
                re, im = q_encode(re, quant), q_encode(im, quant)
                quants.append(quant)
            res_re.append(re)
            res_im.append(im)
            res_idx.append(idx)
        quant = None
        if cfg.quantize:
            q0 = quants[0]
            quant = stack_bucket_quant(type(q0)(
                q0.config, *(torch.stack([getattr(q, f) for q in quants])
                             for f in ("eps", "p_codes", "vmax", "vmin"))))
        return StackedPayload(torch.stack(res_re), torch.stack(res_im),
                              torch.stack(res_idx).to(torch.int16), quant, sizes, cfg.chunk)


class CudaBackend(CompressorBackend):
    """The hand-written kernels on the hot stages (mirrors the reference's
    ``PallasBackend.compress_stacked`` / ``decompress_stacked``).

    compress:   rfft -> threshold kernel -> mid-gap tau -> masked per-bucket
                fit -> ONE fused compress launch over every bucket row ->
                slice the 128-slot padding down to the keep count.
    decompress: ONE fused decompress launch (quantized, 4096-pt chunks)."""

    name = "cuda"

    def compress_stacked(self, cfg, stacked, sizes):
        eligible, reason = kernel_eligibility(cfg)
        if not eligible:
            raise NotImplementedError(
                f"cuda backend: {reason}; the per-stage kernels this needs (B5 "
                "range-quant, B6 pack) are not ported yet (ROADMAP.md queue 2) -- "
                "use backend='auto' or 'reference'")
        sizes = tuple(int(s) for s in sizes)
        n_buckets, padded = stacked.shape
        c_max = padded // cfg.chunk
        rows = n_buckets * c_max
        x2d = stacked.reshape(rows, cfg.chunk).float()
        freqs = torch.fft.rfft(x2d, dim=-1)
        re = freqs.real.contiguous()
        im = freqs.imag.contiguous()
        del freqs
        k = _keep_k(cfg)
        w = cfft.hermitian_weights(cfg.chunk, stacked.device)
        mag = _weighted_magnitude(re, im, w)
        sel = selection.resolve_selector(cfg.selector, mag.shape[-1])

        # one threshold pass defines the kept set; its tau moves to the
        # middle of the gap to the largest dropped magnitude, where an ulp of
        # recompute noise inside the fused kernel cannot flip a comparison
        tau_k, _ = _kernel_tau(cfg, mag, k, sel)
        below = torch.where(mag < tau_k, mag, 0.0).amax(dim=-1, keepdim=True)
        tau = 0.5 * (tau_k + below)
        # per-bucket fit over the kept set; padding rows (all-zero chunks:
        # tau 0, mask all-true) are excluded
        mask = (mag >= tau) & valid_chunk_mask(
            sizes, c_max, cfg.chunk, stacked.device).reshape(rows, 1)
        del mag
        m3 = mask.reshape(n_buckets, c_max, -1)
        re3 = re.reshape(n_buckets, c_max, -1)
        im3 = im.reshape(n_buckets, c_max, -1)
        lo = torch.minimum(torch.where(m3, re3, torch.inf).amin(dim=(1, 2)),
                           torch.where(m3, im3, torch.inf).amin(dim=(1, 2)))
        hi = torch.maximum(torch.where(m3, re3, -torch.inf).amax(dim=(1, 2)),
                           torch.where(m3, im3, -torch.inf).amax(dim=(1, 2)))
        del mask, m3
        quant = stack_bucket_quant(fit_quantizer(lo, hi, _qcfg(cfg)))
        # per-bucket params -> per-row vectors for the single fused launch
        eps_rows = quant.eps.reshape(n_buckets).repeat_interleave(c_max)
        p_rows = quant.p_codes.reshape(n_buckets).repeat_interleave(c_max)
        rec, imc, idx, _ = fused_compress.fused_compress(
            re, im, w, eps_rows, p_rows, tau, k_keep=k, n_bits=cfg.n_bits, m_bits=cfg.m_bits)
        return StackedPayload(
            rec[:, :k].reshape(n_buckets, c_max, k).contiguous(),
            imc[:, :k].reshape(n_buckets, c_max, k).contiguous(),
            idx[:, :k].to(torch.int16).reshape(n_buckets, c_max, k),
            quant, sizes, cfg.chunk)

    def decompress_stacked(self, payload: StackedPayload) -> torch.Tensor:
        if payload.quant is None:
            return super().decompress_stacked(payload)
        if payload.chunk != KERNEL_CHUNK:
            raise NotImplementedError(
                f"cuda backend: chunk={payload.chunk} != {KERNEL_CHUNK} needs the "
                "standalone range-quant decode kernel (B5), not ported yet "
                "(ROADMAP.md queue 2) -- use backend='auto' or 'reference'")
        n_buckets, c_max, k = payload.re.shape
        rows = n_buckets * c_max
        eps_rows = payload.quant.eps.reshape(n_buckets).repeat_interleave(c_max)
        p_rows = payload.quant.p_codes.reshape(n_buckets).repeat_interleave(c_max)
        x2d = fused_decompress.fused_decompress(
            payload.re.reshape(rows, k).contiguous(), payload.im.reshape(rows, k).contiguous(),
            payload.idx.reshape(rows, k).contiguous(), eps_rows, p_rows,
            m_bits=payload.quant.config.m_bits)
        return x2d.reshape(n_buckets, c_max * KERNEL_CHUNK)


class AutoBackend(CompressorBackend):
    """``cuda`` when the config (or payload) fits the fused kernels end to
    end, ``reference`` otherwise."""

    name = "auto"

    def __init__(self):
        self._reference = ReferenceBackend()
        self._cuda = CudaBackend()

    def compress_stacked(self, cfg, stacked, sizes):
        eligible, _ = kernel_eligibility(cfg)
        backend = self._cuda if eligible else self._reference
        return backend.compress_stacked(cfg, stacked, sizes)

    def decompress_stacked(self, payload):
        if payload.quant is not None and payload.chunk == KERNEL_CHUNK:
            return self._cuda.decompress_stacked(payload)
        return self._reference.decompress_stacked(payload)


_BACKENDS = {"reference": ReferenceBackend(), "cuda": CudaBackend(), "auto": AutoBackend()}


def get_backend(name: str) -> CompressorBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor backend {name!r}; expected one of {BACKEND_NAMES}") from None
