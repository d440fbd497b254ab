"""Exchange strategies for compressed gradient buckets (port of
``repro.comms.transport``: ``Transport.run(layout=...)``, the ``allgather``
and ``sequenced`` transports, and the per-bucket loop).

``run(flat, comp=..., layout=..., group=...)`` with ``group=None`` and no
``torch.distributed`` process group is a one-worker exchange (the worker
axis has length 1); with ``local=True`` it is the local compress ->
decompress roundtrip that error feedback accumulates against, at the
transport's own granularity.

Every exchange all_gathers payloads one plane at a time
(``torch.distributed.all_gather_into_tensor``), dequantizes and scatters
each worker's payload into its spectrum (``decompress_spectrum``), averages
the spectra in worker order by a left-to-right fold, and returns to the
time domain with one irfft per chunk row (FFT linearity).

* ``allgather`` -- ONE monolithic payload of the whole buffer, one
  quantizer fit over all of it (the reference CLI's default).
* ``sequenced`` -- per-bucket quantizer fits.  ``stacked=True`` compresses
  every bucket in one batched pass (``compress_stacked``) and gathers the
  one ``StackedPayload``; ``stacked=False`` is the per-bucket loop, one
  payload and one gather per bucket.  Both give the same mean; the loop is
  slower (one round of launches per bucket) but holds one bucket's spectrum
  at a time, so it peaks lower in device memory.

The ``psum``, ``hierarchical`` and ``reduce_scatter`` transports and the
streamed ``plan=`` dispatch are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

from repro_torch.comms import bucketing
from repro_torch.core import fft as cfft
from repro_torch.core.compressor import StackedPayload

__all__ = ["Transport", "AllGatherTransport", "SequencedTransport", "get_transport",
           "TRANSPORT_NAMES", "PORTED_TRANSPORTS"]

TRANSPORT_NAMES = ("allgather", "sequenced", "psum", "hierarchical", "reduce_scatter")
PORTED_TRANSPORTS = ("allgather", "sequenced")


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


def all_gather_payload(payload, group=None) -> list:
    """The payloads (``FFTPayload`` or ``StackedPayload``) of every worker,
    in rank order (one all_gather per plane and per fit leaf);
    ``[payload]`` when there is one worker."""
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
        out.append(dataclasses.replace(payload, re=planes[0][w], im=planes[1][w],
                                       idx=planes[2][w], quant=quant))
    return out


def _gather_mean_payload(payload, comp, group) -> torch.Tensor:
    """All_gather one monolithic payload -> the flat mean reconstruction:
    the worker-ordered mean of the decompressed spectra, one irfft."""
    spectra = [comp.decompress_spectrum(p) for p in all_gather_payload(payload, group)]
    mean = _ordered_worker_mean(spectra)
    del spectra
    return cfft.chunked_irfft(mean, payload.orig_len, payload.chunk)


class Transport:
    """Exchange interface; :meth:`run` is the single public entry point.
    Subclasses implement the flat hooks (whole buffer + bucket layout) and
    the per-bucket loop hooks."""

    name = "base"

    def run(self, flat: torch.Tensor, *, comp, layout, local: bool = False, group=None,
            stacked: bool = True) -> torch.Tensor:
        """The cross-worker mean of ``flat`` over ``group`` (the default
        process group, or one worker when none is initialized), or with
        ``local=True`` this worker's compress -> decompress reconstruction.
        ``stacked`` picks the batched single-collective path (default) or
        the per-bucket loop.  Returns a flat tensor shaped like ``flat``."""
        if local:
            return self._roundtrip_flat(flat, layout, comp, stacked)
        return self._exchange_flat(flat, layout, comp, group, stacked)

    # -- per-bucket loop hooks ----------------------------------------------

    def _exchange_buckets(self, buckets, comp, group) -> List[torch.Tensor]:
        raise NotImplementedError

    def _roundtrip_buckets(self, buckets, comp) -> List[torch.Tensor]:
        return [comp.decompress(p) for p in comp.compress_buckets(buckets)]

    # -- flat hooks: the per-bucket loop unless a transport overrides them --

    def _exchange_flat(self, flat, layout, comp, group, stacked: bool = True) -> torch.Tensor:
        del stacked  # the loop ignores the flag
        buckets = bucketing.split_buckets(flat, layout)
        return bucketing.concat_buckets(self._exchange_buckets(buckets, comp, group), layout)

    def _roundtrip_flat(self, flat, layout, comp, stacked: bool = True) -> torch.Tensor:
        del stacked
        buckets = bucketing.split_buckets(flat, layout)
        return bucketing.concat_buckets(self._roundtrip_buckets(buckets, comp), layout)


class AllGatherTransport(Transport):
    """ONE monolithic payload all_gather, one global quantizer fit; the
    bucket layout and ``stacked`` play no part."""

    name = "allgather"

    def _exchange_flat(self, flat, layout, comp, group, stacked=True):
        return _gather_mean_payload(comp.compress(flat), comp, group)

    def _roundtrip_flat(self, flat, layout, comp, stacked=True):
        return comp.decompress(comp.compress(flat))


class SequencedTransport(Transport):
    """Bucketed all_gather with per-bucket quantizer ranges: ONE gather of
    the whole exchange's ``StackedPayload`` (stacked), or one per bucket
    (the loop)."""

    name = "sequenced"

    def _exchange_buckets(self, buckets, comp, group):
        return [_gather_mean_payload(p, comp, group) for p in comp.compress_buckets(buckets)]

    def _exchange_flat(self, flat, layout, comp, group, stacked=True):
        if not stacked:
            return super()._exchange_flat(flat, layout, comp, group, stacked)
        payload = _compress_stacked(flat, layout, comp)
        gathered = all_gather_payload(payload, group)
        del payload
        spectra = [comp.decompress_spectrum(p) for p in gathered]
        mean = _ordered_worker_mean(spectra)  # (B, max_chunks, f)
        del spectra
        return bucketing.unstack_buckets(cfft.irfft_rows(mean, layout.chunk), layout)

    def _roundtrip_flat(self, flat, layout, comp, stacked=True):
        if not stacked:
            return super()._roundtrip_flat(flat, layout, comp, stacked)
        payload = _compress_stacked(flat, layout, comp)
        return bucketing.unstack_buckets(comp.decompress_stacked(payload), layout)


_TRANSPORTS = {t.name: t for t in (AllGatherTransport(), SequencedTransport())}


def get_transport(name: str) -> Transport:
    if name in _TRANSPORTS:
        return _TRANSPORTS[name]
    if name in TRANSPORT_NAMES + ("auto",):
        raise NotImplementedError(
            f"transport {name!r} is not ported yet (ported: {PORTED_TRANSPORTS}); "
            "see ROADMAP.md queue 1 for the order the rest arrive in")
    raise ValueError(f"unknown transport {name!r}; expected one of {TRANSPORT_NAMES}")
