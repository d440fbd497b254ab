"""Exchange strategies for compressed gradient buckets (port of
``repro.comms.transport``: ``Transport.run(layout=...)`` and the
``sequenced`` transport).

``run(flat, comp=..., layout=..., group=...)`` with ``group=None`` and no
``torch.distributed`` process group is a one-worker exchange (the worker
axis has length 1); with ``local=True`` it is the local compress ->
decompress roundtrip that error feedback accumulates against.

The ``sequenced`` transport compresses every bucket in one batched pass
(``compress_stacked``) and all_gathers the ``StackedPayload`` one plane at a
time (``torch.distributed.all_gather_into_tensor``).  Each worker's payload
is dequantized and scattered into its spectrum (``decompress_spectrum``),
the spectra are averaged in worker order by a left-to-right fold, and one
irfft per chunk row returns to the time domain (FFT linearity).

The ``allgather``, ``psum``, ``hierarchical`` and ``reduce_scatter``
transports, the per-bucket loop and the streamed ``plan=`` dispatch are not
ported yet.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from repro_torch.comms import bucketing
from repro_torch.core import fft as cfft
from repro_torch.core.compressor import StackedPayload

__all__ = ["Transport", "SequencedTransport", "get_transport", "TRANSPORT_NAMES",
           "PORTED_TRANSPORTS"]

TRANSPORT_NAMES = ("allgather", "sequenced", "psum", "hierarchical", "reduce_scatter")
PORTED_TRANSPORTS = ("sequenced",)


def _compress_stacked(flat: torch.Tensor, layout, comp) -> StackedPayload:
    """ONE batched compress of every bucket (one quantizer fit per bucket)."""
    return comp.compress_stacked(bucketing.stack_buckets(flat, layout), layout.sizes())


def _ordered_worker_mean(parts: List[torch.Tensor]) -> torch.Tensor:
    """Mean over workers as a left-to-right fold, ``((w0 + w1) + w2) ... / P``
    as ``acc * (1/P)``: the reference's fold, which fixes the sum order so
    every worker and every run gets bitwise the same mean."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc * (1.0 / len(parts))


def _world(group) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _gather_plane(t: torch.Tensor, world: int, group) -> torch.Tensor:
    """all_gather one plane -> (world, *t.shape).  The plane travels as raw
    bytes, so every dtype (int16 indices, uint8 codes) takes the same path on
    every backend."""
    src = t.contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    out = torch.empty((world * raw.numel(),), dtype=torch.uint8, device=raw.device)
    dist.all_gather_into_tensor(out, raw, group=group)
    return out.view(src.dtype).reshape((world,) + tuple(src.shape))


def all_gather_payload(payload: StackedPayload, group=None) -> List[StackedPayload]:
    """The payloads of every worker, in rank order (one all_gather per
    plane and per fit leaf); ``[payload]`` when there is one worker."""
    world = _world(group)
    if world == 1:
        return [payload]
    planes = [_gather_plane(t, world, group) for t in (payload.re, payload.im, payload.idx)]
    quant = None
    if payload.quant is not None:
        q = payload.quant
        leaves = [_gather_plane(t, world, group) for t in (q.eps, q.p_codes, q.vmax, q.vmin)]
    out = []
    for w in range(world):
        if payload.quant is not None:
            quant = type(payload.quant)(payload.quant.config, *(leaf[w] for leaf in leaves))
        out.append(StackedPayload(planes[0][w], planes[1][w], planes[2][w], quant,
                                  payload.sizes, payload.chunk))
    return out


class Transport:
    """Exchange interface; :meth:`run` is the single public entry point."""

    name = "base"

    def run(self, flat: torch.Tensor, *, comp, layout, local: bool = False,
            group=None) -> torch.Tensor:
        """The cross-worker mean of ``flat`` over ``group`` (the default
        process group, or one worker when none is initialized), or with
        ``local=True`` this worker's compress -> decompress reconstruction.
        Returns a flat tensor shaped like ``flat``."""
        if local:
            return self._roundtrip_flat(flat, layout, comp)
        return self._exchange_flat(flat, layout, comp, group)

    def _exchange_flat(self, flat, layout, comp, group) -> torch.Tensor:
        raise NotImplementedError

    def _roundtrip_flat(self, flat, layout, comp) -> torch.Tensor:
        raise NotImplementedError


class SequencedTransport(Transport):
    """One all_gather of the whole exchange's ``StackedPayload`` (one
    collective per plane), per-bucket quantizer ranges."""

    name = "sequenced"

    def _exchange_flat(self, flat, layout, comp, group):
        payload = _compress_stacked(flat, layout, comp)
        gathered = all_gather_payload(payload, group)
        del payload
        spectra = [comp.decompress_spectrum(p) for p in gathered]
        mean = _ordered_worker_mean(spectra)  # (B, max_chunks, f)
        del spectra
        return bucketing.unstack_buckets(cfft.irfft_rows(mean, layout.chunk), layout)

    def _roundtrip_flat(self, flat, layout, comp):
        payload = _compress_stacked(flat, layout, comp)
        return bucketing.unstack_buckets(comp.decompress_stacked(payload), layout)


_TRANSPORTS = {"sequenced": SequencedTransport()}


def get_transport(name: str) -> Transport:
    if name in _TRANSPORTS:
        return _TRANSPORTS[name]
    if name in TRANSPORT_NAMES + ("auto",):
        raise NotImplementedError(
            f"transport {name!r} is not ported yet (ported: {PORTED_TRANSPORTS}); "
            "see ROADMAP.md queue 1 for the order the rest arrive in")
    raise ValueError(f"unknown transport {name!r}; expected one of {TRANSPORT_NAMES}")
