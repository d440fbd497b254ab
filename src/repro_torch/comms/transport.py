"""Exchange strategies for compressed gradient buckets (port of
``repro.comms.transport``: ``Transport.run(layout=...)``, the ``allgather``,
``sequenced`` and ``psum`` transports, and the per-bucket loop).

``run(flat, comp=..., layout=..., group=...)`` with ``group=None`` and no
``torch.distributed`` process group is a one-worker exchange (the worker
axis has length 1, and no collective runs); with ``local=True`` it is the
local compress -> decompress roundtrip that error feedback accumulates
against, at the transport's own granularity.

The gather transports all_gather payloads one plane at a time
(``torch.distributed.all_gather_into_tensor``).  For a spectral compressor
(one with ``decompress_spectrum``) they dequantize and scatter each
worker's payload into its spectrum, average the spectra in worker order by
a left-to-right fold, and return to the time domain with one irfft per
chunk row (FFT linearity); for any other compressor (the time-domain and
quantization baselines) they average the workers' decompressed buffers in
the same order.

* ``allgather`` -- ONE monolithic payload of the whole buffer, one
  quantizer fit over all of it (the reference CLI's default).
* ``sequenced`` -- per-bucket quantizer fits.  ``stacked=True`` compresses
  every bucket in one batched pass (``compress_stacked``) and gathers the
  one ``StackedPayload``; ``stacked=False`` (or a compressor without
  ``compress_stacked``) is the per-bucket loop, one payload and one gather
  per bucket.  Both give the same mean; the loop is slower (one round of
  launches per bucket) but holds one bucket's spectrum at a time, so it
  peaks lower in device memory.
* ``psum`` -- each worker dequantizes its own payload and ONE SUM
  all_reduce of the dense ``stack([spec.real, spec.imag])`` planes, times
  1/P, gives the mean spectrum; then one irfft.  The stacked path reduces
  every bucket's planes in one collective, the loop one per bucket.  With
  two workers its mean is bitwise the ``sequenced`` one.

``run(..., plan=...)`` takes a ``scheduler.StreamPlan`` instead of a
``layout``: one dispatch per readiness group over the group's flat slice
and sub-layout, first-ready first, reassembled in index order -- bitwise
the ``layout=`` result (``comms/scheduler.py``).  ``monitor=`` (a
``comms.faults.ExchangeMonitor``) sees every payload this worker creates
for the exchange before it reaches a collective, and makes every payload
it decodes safe to decode; the local roundtrip (``local=True``, what error
feedback accumulates against) is not monitored: the residual never crosses
the wire.

The two-level topology (``launch/mesh.py``): ``group=`` also takes a
``launch.mesh.Mesh``.  The flat transports and ``reduce_scatter`` run over
its ``flat`` group; ``hierarchical`` needs its two hops,
``(mesh.node, mesh.local)`` (:func:`two_level_axes`), and refuses a flat
group.

* ``hierarchical`` -- a dense rfft of the stacked rows (no top-k), ONE SUM
  all_reduce of the ``(2, n_buckets, max_chunks, f)`` plane stack over the
  island's ``local`` group times 1/local, and one irfft give the node mean
  (FFT linearity); every worker of the island compresses that node mean
  (the only lossy step), the compressed payloads are gathered over the
  ``node`` group (one per island) and folded in node order into the mean
  spectrum, then one irfft.  With ``local == 1`` the rfft -> irfft still
  runs, as in the reference, so the node mean is not bitwise ``flat``.  The
  loop sums the raw time-domain buckets over ``local`` instead (equal by
  linearity), a non-spectral compressor sums the stacked rows.  Its error
  feedback roundtrip is this worker's own compress of ``flat``, not of the
  node mean.
* ``reduce_scatter`` -- each worker dequantizes its own payload into the
  ``(n_buckets, 2, max_chunks, f)`` planes (buckets leading, zero rows
  padding the bucket count to a multiple of P); ONE
  ``reduce_scatter_tensor`` hands rank i the summed planes of buckets
  ``[i*B'/P, (i+1)*B'/P)``, which it scales by 1/P and inverts on its own
  rows only; ONE ``all_gather_into_tensor`` of the time-domain rows
  rebuilds the buffer.  The loop (and a compressor without
  ``compress_stacked``) is the ``psum`` loop.  With one worker its mean is
  bitwise ``psum``'s (the same ops on the same shapes); with more, the
  collective's sum order is the backend's, so it agrees with ``psum`` to
  rounding.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

from repro_torch.comms import bucketing
from repro_torch.core import fft as cfft
from repro_torch.core.compressor import StackedPayload
from repro_torch.core.quantizer import FittedQuantizer
from repro_torch.dist_util import world_size
from repro_torch.launch.mesh import Mesh

__all__ = ["Transport", "AllGatherTransport", "SequencedTransport", "SpectrumPsumTransport",
           "HierarchicalTransport", "ReduceScatterTransport", "get_transport",
           "all_gather_payload", "assemble_index_order", "two_level_axes", "TRANSPORT_NAMES"]

TRANSPORT_NAMES = ("allgather", "sequenced", "psum", "hierarchical", "reduce_scatter")


def two_level_axes(group) -> tuple:
    """Validate a hierarchical exchange's group spec -> (node_group,
    local_group).  A two-axis mesh gives its two hops; a pair is taken as
    (node, local).  The hierarchical transport is the only one whose two
    hops ride different links, so a flat group is refused: the caller must
    say which group is the fabric and which the fast link."""
    if isinstance(group, Mesh) and len(group.sizes) == 2:
        return group.node, group.local
    if isinstance(group, (tuple, list)) and len(group) == 2 and not any(
            isinstance(g, (str, Mesh)) for g in group):
        return tuple(group)
    raise ValueError(f"hierarchical transport needs group=(node_group, local_group) or a "
                     f"two-level mesh (launch.mesh.make_two_level_mesh), got {group!r}")


def assemble_index_order(flat: torch.Tensor, plan, run_group) -> torch.Tensor:
    """``run_group(lo, hi, sub_layout)`` -- the result for ``flat[lo:hi]`` --
    for every group of ``plan`` in readiness order, each written to its own
    slice of one output buffer, which is then in index order (the reference
    concatenates the reversed results; writing in place holds one group's
    result at a time beside the output instead of all of them)."""
    out = torch.empty_like(flat, dtype=torch.float32)
    for lo, hi, sub in plan.group_slices():
        out[lo:hi] = run_group(lo, hi, sub)
    return out


def _monitored(payload, monitor):
    return payload if monitor is None else monitor.on_payload(payload)


def _compress_all(buckets, comp, monitor=None) -> list:
    """Per-bucket payloads, one quantizer fit per bucket."""
    if hasattr(comp, "compress_buckets"):
        payloads = comp.compress_buckets(buckets)
    else:
        payloads = [comp.compress(b) for b in buckets]
    return [_monitored(p, monitor) for p in payloads]


def _can_stack(comp) -> bool:
    return hasattr(comp, "compress_stacked")


def _compress_stacked(flat: torch.Tensor, layout, comp, monitor=None) -> StackedPayload:
    """ONE batched compress of every bucket (one quantizer fit per bucket)."""
    return _monitored(comp.compress_stacked(bucketing.stack_buckets(flat, layout),
                                            layout.sizes()), monitor)


def _stacked_roundtrip(flat: torch.Tensor, layout, comp) -> torch.Tensor:
    """This worker's stacked compress -> decompress, back to the flat layout."""
    payload = _compress_stacked(flat, layout, comp)
    return bucketing.unstack_buckets(comp.decompress_stacked(payload), layout)


def _ordered_worker_mean(parts: List[torch.Tensor]) -> torch.Tensor:
    """Mean over workers as a left-to-right fold, ``((w0 + w1) + w2) ... / P``
    as ``acc * (1/P)``: the reference's fold, which fixes the sum order so
    every worker and every run gets bitwise the same mean."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc * (1.0 / len(parts))


def _sum_over_workers(t: torch.Tensor, group) -> torch.Tensor:
    """SUM all_reduce of ``t`` (a fresh buffer, reduced in place); no
    collective with one worker."""
    if world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """SUM all_reduce of a copy of ``t``, times 1/P (``t`` as it is, times
    1.0, with one worker)."""
    world = world_size(group)
    return _sum_over_workers(t.clone() if world > 1 else t, group) * (1.0 / world)


def _gather_plane(t: torch.Tensor, world: int, group) -> torch.Tensor:
    """all_gather one plane -> (world, *t.shape).  The plane travels as raw
    bytes, so every dtype (int16 indices, uint8 or int8 codes) takes the
    same path on every backend; an empty plane (a real payload's ``im``)
    moves nothing."""
    src = t.contiguous()
    if src.numel() == 0:
        return src.new_empty((world,) + tuple(src.shape))
    raw = src.reshape(-1).view(torch.uint8)
    out = torch.empty((world * raw.numel(),), dtype=torch.uint8, device=raw.device)
    dist.all_gather_into_tensor(out, raw, group=group)
    return out.view(src.dtype).reshape((world,) + tuple(src.shape))


def all_gather_payload(payload, group=None) -> list:
    """The payloads of every worker, in rank order: one all_gather per tensor
    field of the payload dataclass (``FFTPayload``, ``StackedPayload``,
    ``ScaledCodes``) and per leaf of its quantizer fit; ``[payload]`` when
    there is one worker."""
    world = world_size(group)
    if world == 1:
        return [payload]
    gathered = {}
    for field in dataclasses.fields(payload):
        value = getattr(payload, field.name)
        if isinstance(value, torch.Tensor):
            gathered[field.name] = _gather_plane(value, world, group)
        elif isinstance(value, FittedQuantizer):
            gathered[field.name] = value.map(lambda t: _gather_plane(t, world, group))
    return [dataclasses.replace(payload, **{
        name: value.map(lambda t: t[w]) if isinstance(value, FittedQuantizer) else value[w]
        for name, value in gathered.items()}) for w in range(world)]


def _decompress(comp, payload, stacked: bool, monitor=None) -> torch.Tensor:
    """What the workers' mean runs over: the payload's spectrum where the
    compressor has ``decompress_spectrum`` (the mean then takes one irfft),
    else its decompressed buffer."""
    if monitor is not None:
        payload = monitor.admit(payload)
    if hasattr(comp, "decompress_spectrum"):
        return comp.decompress_spectrum(payload)
    return comp.decompress_stacked(payload) if stacked else comp.decompress(payload)


def _gather_mean_payload(payload, comp, group, stacked: bool = False,
                         monitor=None) -> torch.Tensor:
    """All_gather one payload -> the worker-ordered mean of the decompressed
    spectra (or buffers)."""
    gathered = all_gather_payload(payload, group)
    del payload
    return _ordered_worker_mean([_decompress(comp, p, stacked, monitor) for p in gathered])


def _psum_mean_payload(payload, comp, group, stacked: bool = False,
                       monitor=None) -> torch.Tensor:
    """Decompress locally -> SUM all_reduce -> * 1/P.  A spectrum travels
    as its stacked real and imag planes: the all_reduce moves the DENSE
    dequantized spectrum, as the reference's ``psum`` does (its semantics,
    not a sparse all-reduce)."""
    inv_p = 1.0 / world_size(group)
    local = _decompress(comp, payload, stacked, monitor)
    del payload
    if not local.is_complex():
        return _sum_over_workers(local, group) * inv_p
    summed = _sum_over_workers(torch.stack([local.real, local.imag]), group)
    del local
    return torch.complex(summed[0], summed[1]) * inv_p


def _bucket_buffer(mean: torch.Tensor, payload) -> torch.Tensor:
    """One payload's mean as its flat buffer: a mean spectrum takes one
    chunked irfft."""
    if mean.is_complex():
        return cfft.chunked_irfft(mean, payload.orig_len, payload.chunk)
    return mean


def _stacked_buffer(mean: torch.Tensor, layout) -> torch.Tensor:
    """The stacked mean back to the flat layout: a mean spectrum
    ``(n_buckets, max_chunks, f)`` takes one batched irfft."""
    if mean.is_complex():
        mean = cfft.irfft_rows(mean, layout.chunk)
    return bucketing.unstack_buckets(mean, layout)


class Transport:
    """Exchange interface; :meth:`run` is the single public entry point.
    A subclass sets ``_reduce``, its worker reduction of one payload, and
    overrides the flat hooks where its granularity is not the bucket's."""

    name = "base"

    def run(self, flat: torch.Tensor, *, comp, layout=None, plan=None, local: bool = False,
            group=None, stacked: bool = True, monitor=None) -> torch.Tensor:
        """The cross-worker mean of ``flat`` over ``group`` (the default
        process group, or one worker when none is initialized; a mesh, or
        for ``hierarchical`` its ``(node, local)`` pair), or with
        ``local=True`` this worker's compress -> decompress reconstruction.
        ``layout`` dispatches once over the whole buffer; ``plan`` (a
        ``scheduler.StreamPlan``, exclusive with ``layout``) once per
        readiness group.  ``stacked`` picks the batched single-collective
        path (default) or the per-bucket loop; ``monitor`` (exchange only)
        sees every outgoing payload.  Returns a flat tensor shaped like
        ``flat``."""
        if not local:
            group = self._group(group)
        if plan is not None:
            if layout is not None:
                raise ValueError("run() takes layout= or plan=, not both")
            return assemble_index_order(flat, plan, lambda lo, hi, sub: self._run_one(
                flat[lo:hi], sub, comp, local, group, stacked, monitor))
        if layout is None:
            raise ValueError("run() needs a layout= or a plan=")
        return self._run_one(flat, layout, comp, local, group, stacked, monitor)

    def _group(self, group):
        """The group spec this transport's collectives take: a mesh's
        ``flat`` group."""
        return group.flat if isinstance(group, Mesh) else group

    def _run_one(self, flat, layout, comp, local, group, stacked, monitor):
        if local:
            return self._roundtrip_flat(flat, layout, comp, stacked)
        return self._exchange_flat(flat, layout, comp, group, stacked, monitor)

    # (payload, comp, group, stacked=False, monitor=None) -> the workers' mean
    # spectrum or buffer
    _reduce = None

    def _exchange_flat(self, flat, layout, comp, group, stacked: bool = True,
                       monitor=None) -> torch.Tensor:
        """ONE reduction of the stacked payload, or one per bucket (the loop,
        also for a compressor without ``compress_stacked``)."""
        if stacked and _can_stack(comp):
            # the payload is handed on unnamed, so the reduction frees it
            # once it is decompressed
            return _stacked_buffer(
                self._reduce(_compress_stacked(flat, layout, comp, monitor), comp, group, True,
                             monitor), layout)
        buckets = bucketing.split_buckets(flat, layout)
        return bucketing.concat_buckets(
            [_bucket_buffer(self._reduce(p, comp, group, False, monitor), p)
             for p in _compress_all(buckets, comp, monitor)], layout)

    def _roundtrip_flat(self, flat, layout, comp, stacked: bool = True) -> torch.Tensor:
        if stacked and _can_stack(comp):
            return _stacked_roundtrip(flat, layout, comp)
        buckets = bucketing.split_buckets(flat, layout)
        return bucketing.concat_buckets(
            [comp.decompress(p) for p in _compress_all(buckets, comp)], layout)


class AllGatherTransport(Transport):
    """ONE monolithic payload all_gather, one global quantizer fit; the
    bucket layout and ``stacked`` play no part."""

    name = "allgather"
    _reduce = staticmethod(_gather_mean_payload)

    def _exchange_flat(self, flat, layout, comp, group, stacked=True, monitor=None):
        payload = _monitored(comp.compress(flat), monitor)
        return _bucket_buffer(self._reduce(payload, comp, group, False, monitor), payload)

    def _roundtrip_flat(self, flat, layout, comp, stacked=True):
        return comp.decompress(comp.compress(flat))


class SequencedTransport(Transport):
    """Bucketed all_gather with per-bucket quantizer ranges: ONE gather of
    the whole exchange's ``StackedPayload`` (stacked), or one per bucket
    (the loop)."""

    name = "sequenced"
    _reduce = staticmethod(_gather_mean_payload)


class SpectrumPsumTransport(Transport):
    """Psum of dequantized spectra: ONE SUM all_reduce of the
    ``(2, n_buckets, max_chunks, f)`` plane stack (stacked), then one batched
    irfft; or one all_reduce per bucket (the loop)."""

    name = "psum"
    _reduce = staticmethod(_psum_mean_payload)


def _node_mean(flat: torch.Tensor, layout, comp, local_group) -> torch.Tensor:
    """The island's mean of ``flat``, replicated on its workers: for a
    spectral compressor the dense rfft of the stacked rows, one SUM
    all_reduce of its plane stack over ``local_group`` times 1/local, and
    one irfft (each buffer is freed as soon as the next one holds it); else
    the stacked rows' mean."""
    rows = bucketing.stack_buckets(flat, layout)
    if not hasattr(comp, "decompress_spectrum"):
        return bucketing.unstack_buckets(_mean_over(rows, local_group), layout)
    spec = torch.fft.rfft(rows.reshape(layout.n_buckets, -1, layout.chunk), dim=-1)
    del rows
    planes = torch.stack([spec.real, spec.imag])
    del spec
    summed = _sum_over_workers(planes, local_group)
    del planes
    mean = torch.complex(summed[0], summed[1])
    del summed
    return _stacked_buffer(mean.mul_(1.0 / world_size(local_group)), layout)


class HierarchicalTransport(Transport):
    """Two-level exchange over ``(node, local)``: the island's dense mean on
    the fast link, one compressed payload per island over the fabric, the
    nodes' payloads folded in node order.  Its roundtrip (the base class's)
    is this worker's own compress of ``flat``: the exchange's only loss is
    the island's compress of the node mean, which no worker's state can
    hold."""

    name = "hierarchical"
    _reduce = staticmethod(_gather_mean_payload)

    def _group(self, group):
        return two_level_axes(group)

    def _exchange_flat(self, flat, layout, comp, group, stacked=True, monitor=None):
        node, local = group
        if stacked and _can_stack(comp):
            payload = _compress_stacked(_node_mean(flat, layout, comp, local), layout, comp,
                                        monitor)
            return _stacked_buffer(_gather_mean_payload(payload, comp, node, True, monitor),
                                   layout)
        # the loop sums the raw time-domain buckets (the spectra's sum by
        # linearity, the same dense wire), then compresses each node mean
        node_means = [_mean_over(b, local) for b in bucketing.split_buckets(flat, layout)]
        return bucketing.concat_buckets(
            [_bucket_buffer(_gather_mean_payload(p, comp, node, False, monitor), p)
             for p in _compress_all(node_means, comp, monitor)], layout)


def _reduce_scatter_rows(planes: torch.Tensor, world: int, group) -> torch.Tensor:
    """This rank's shard of the summed ``planes`` (rows split evenly over
    the group, rank order)."""
    if world == 1:
        return planes
    out = planes.new_empty((planes.shape[0] // world,) + tuple(planes.shape[1:]))
    dist.reduce_scatter_tensor(out, planes, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather_rows(rows: torch.Tensor, world: int, group) -> torch.Tensor:
    """Every rank's rows, stacked in rank order along dim 0."""
    if world == 1:
        return rows
    out = rows.new_empty((world * rows.shape[0],) + tuple(rows.shape[1:]))
    dist.all_gather_into_tensor(out, rows.contiguous(), group=group)
    return out


class ReduceScatterTransport(Transport):
    """Bucket-partitioned reduction: ONE reduce_scatter of the dequantized
    planes over the bucket axis, each rank's irfft of its own buckets, ONE
    all_gather of the time-domain rows (stacked); the ``psum`` loop
    otherwise."""

    name = "reduce_scatter"
    _reduce = staticmethod(_psum_mean_payload)

    def _exchange_flat(self, flat, layout, comp, group, stacked=True, monitor=None):
        if not (stacked and _can_stack(comp)):
            return super()._exchange_flat(flat, layout, comp, group, stacked, monitor)
        world = world_size(group)
        local = _decompress(comp, _compress_stacked(flat, layout, comp, monitor), True, monitor)
        spectral = local.is_complex()
        # buckets lead, so a rank's shard is a contiguous bucket range
        planes = (torch.stack([local.real, local.imag], dim=1) if spectral
                  else local[:, None, :])
        del local
        n_buckets = planes.shape[0]
        pad = (-n_buckets) % world
        if pad:
            planes = torch.cat([planes, planes.new_zeros((pad,) + tuple(planes.shape[1:]))])
        shard = _reduce_scatter_rows(planes.contiguous(), world, group)
        del planes
        # the shard is freed before the irfft allocates its rows
        mean = (torch.complex(shard[:, 0], shard[:, 1]) if spectral else shard[:, 0]) \
            * (1.0 / world)
        del shard
        rows = cfft.irfft_rows(mean, layout.chunk) if spectral else mean
        del mean
        return bucketing.unstack_buckets(_all_gather_rows(rows, world, group)[:n_buckets],
                                         layout)


_TRANSPORTS = {t.name: t for t in (AllGatherTransport(), SequencedTransport(),
                                   SpectrumPsumTransport(), HierarchicalTransport(),
                                   ReduceScatterTransport())}


def get_transport(name: str) -> Transport:
    """The transport of a concrete name; ``auto`` is resolved before a
    transport is looked up (``scheduler.resolve_transport``)."""
    if name in _TRANSPORTS:
        return _TRANSPORTS[name]
    if name == "auto":
        raise ValueError("transport 'auto' must be resolved first "
                         "(scheduler.resolve_transport; build_train_step does)")
    raise ValueError(f"unknown transport {name!r}; expected one of {TRANSPORT_NAMES}")
