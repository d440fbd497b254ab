"""When does compression pay, and how long does an exchange take (port of
``repro.comms.cost_model``'s flat-transport pricing; paper §III-D, Fig. 9).

    cost_comp        = M * (4/T_m + 1/T_f + 1/T_p + 1/T_s)
    saved_cost_comm  = M/T_comm * (1 - 1/k)
    beneficial  <=>  2*cost_comp < saved_cost_comm
    k_min        =   1 / (1 - 2*T_comm*(4/T_m + 1/T_f + 1/T_p + 1/T_s))

(T_* are throughputs; the compress + decompress pair costs 2x, hence the 2.)
``k_min`` is ``inf`` when no compression ratio pays for itself on the link.

Uncalibrated defaults.  ``H100``, ``BACKPROP_FLOPS_PER_S`` and the default
link are what ``profile=None`` prices with; ``comms/calibrate.py`` measures
all of them on the live process group and returns a ``CostProfile`` that
every pricing function takes as ``profile=``.  ``H100`` and
``BACKPROP_FLOPS_PER_S`` are one card's measurements (their comments name
the card, its power limit and the run); the link rates of ``NETWORKS`` are
practical figures of common fabrics, not measurements, and the default link
is ``100Gb-EDR`` (11 GB/s), a 100 Gb/s InfiniBand port between hosts.
``COLLECTIVE_ALPHA_S`` is a napkin launch latency of a collective over such
a link (a one-rank NCCL group on the H100 above launches an all_gather in
~60 us, and measures no link).

The pricing is pure Python, a function of its arguments: explicit
arguments win over ``profile``, which wins over the defaults
(``_resolve_pricing``).  ``wire_mode="runtime"`` prices the bytes today's
transports move (``psum`` all_reduces the dense spectrum), ``"modeled"``
the sparse all-reduce endpoint.

The two-level exchange (``hierarchical``) rides two links: the island's
dense-spectrum all_reduce on the fast intra-node link and one compressed
payload per island on the fabric.  :func:`two_level_exchange_time_s`
prices each hop at its own link's alpha-beta (per-axis fits of a
calibration over a two-level mesh, else ``NVLINK_NETWORK`` and
``FABRIC_NETWORK``: an H100 SXM's NVLink 4 and a 400 Gb/s InfiniBand port,
figures from data sheets, not measurements).  The per-run and publish wire
accounts are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["Throughputs", "PAPER_V100", "H100", "compression_cost_s", "saved_comm_s",
           "k_min", "is_beneficial", "NETWORKS", "DEFAULT_NETWORK", "bucket_count",
           "transport_wire_bits", "overlap_fraction", "bucketed_payload_bits",
           "exchange_time_s", "ExchangePlan", "COLLECTIVE_ALPHA_S", "BACKPROP_FLOPS_PER_S",
           "WIRE_MODES", "dense_spectrum_bits", "dense_time_bits", "StreamedExchangePlan",
           "streamed_exchange_time_s", "dense_allreduce_bits", "TwoLevelWire",
           "two_level_wire_bits", "TwoLevelExchangePlan", "two_level_exchange_time_s",
           "NVLINK_NETWORK", "FABRIC_NETWORK"]


@dataclasses.dataclass(frozen=True)
class Throughputs:
    """All in bytes/second."""

    t_m: float  # precision change / thresholding (O(N), elementwise)
    t_f: float  # FFT
    t_p: float  # pack
    t_s: float  # top-k select

    def inv_sum(self) -> float:
        return 4.0 / self.t_m + 1.0 / self.t_f + 1.0 / self.t_p + 1.0 / self.t_s


# The paper's V100-era numbers (pack measured at 34 GB/s on V100; the others
# scaled from cuFFT/Thrust throughput), kept for reproducing Fig. 9.
PAPER_V100 = Throughputs(t_m=300e9, t_f=150e9, t_p=34e9, t_s=100e9)

# What ``calibrate.measure_throughputs`` measured on an NVIDIA H100 80GB
# HBM3 at 700 W (power limit; chip_smoke.py's train-auto phase, PERF.md
# section 6): the exchange's own compress -> decompress roundtrip through
# the fused kernels (sequenced, 64 MiB buckets, theta 0.7) over 2**26
# values, CUDA events, median of 3.  The kernels fuse the stages, so all
# four carry the one rate that prices the roundtrip (11.4 ms for 256 MiB).
H100 = Throughputs(t_m=330092151221.04193, t_f=330092151221.04193, t_p=330092151221.04193,
                   t_s=330092151221.04193)

# practical byte rates of common links, one direction (not line rate)
NETWORKS = {
    "10GbE": 1.1e9,
    "56Gb-FDR": 6.0e9,  # the paper's practical 6 GB/s
    "100Gb-EDR": 11.0e9,
    # a 400 Gb/s NDR InfiniBand port between hosts: 50 GB/s line rate, at
    # the share of it the EDR entry above takes (88%); not measured
    "400Gb-NDR": 44.0e9,
    # NVLink 4 between the cards of one H100 SXM host: NVIDIA's data sheet
    # gives 900 GB/s for both directions together, 450 GB/s each way; not
    # measured (one card has no NVLink peer)
    "nvlink4-h100-sxm": 450.0e9,
}
DEFAULT_NETWORK = "100Gb-EDR"
# the two-level exchange's default links: the island's fast link and the
# fabric between islands
NVLINK_NETWORK = "nvlink4-h100-sxm"
FABRIC_NETWORK = "400Gb-NDR"


def compression_cost_s(message_bytes: float, thr: Throughputs) -> float:
    return message_bytes * thr.inv_sum()


def saved_comm_s(message_bytes: float, t_comm: float, k: float) -> float:
    return message_bytes / t_comm * (1.0 - 1.0 / k)


def k_min(t_comm: Optional[float] = None, thr: Optional[Throughputs] = None,
          *, profile=None) -> float:
    """Minimal beneficial compression ratio; inf if never beneficial."""
    t_comm, thr, _ = _resolve_pricing("allgather", t_comm, thr, 0.0, profile)
    denom = 1.0 - 2.0 * t_comm * thr.inv_sum()
    if denom <= 0.0:
        return float("inf")
    return 1.0 / denom


def is_beneficial(message_bytes: float, t_comm: Optional[float], k: float,
                  thr: Optional[Throughputs] = None, *, profile=None) -> bool:
    t_comm, thr, _ = _resolve_pricing("allgather", t_comm, thr, 0.0, profile)
    return 2.0 * compression_cost_s(message_bytes, thr) < saved_comm_s(message_bytes, t_comm, k)


def bucket_count(message_bytes: float, bucket_bytes, chunk: int = 4096,
                 dtype_bytes: int = 4) -> int:
    """Buckets the reducer splits a message into (>= 1), from the same
    layout the reducer builds."""
    from repro_torch.comms.bucketing import build_layout

    total = max(1, int(-(-message_bytes // dtype_bytes)))
    return build_layout(total, bucket_bytes, chunk, dtype_bytes).n_buckets


WIRE_MODES = ("modeled", "runtime")


def dense_spectrum_bits(n_elems: int, chunk: int = 4096) -> float:
    """Wire bits of the dense dequantized spectrum of an n-element buffer:
    two f32 planes of ``ceil(n/chunk) * (chunk//2 + 1)`` bins."""
    if n_elems < 1:
        raise ValueError(f"n_elems must be >= 1, got {n_elems}")
    n_chunks = -(-int(n_elems) // int(chunk))
    return 2.0 * 32.0 * n_chunks * (int(chunk) // 2 + 1)


def dense_time_bits(n_elems: int, chunk: int = 4096) -> float:
    """Wire bits of the chunk-padded dense time-domain buffer (f32 rows)."""
    if n_elems < 1:
        raise ValueError(f"n_elems must be >= 1, got {n_elems}")
    n_chunks = -(-int(n_elems) // int(chunk))
    return 32.0 * n_chunks * int(chunk)


@dataclasses.dataclass(frozen=True)
class TwoLevelWire:
    """Per-axis wire split of one hierarchical exchange."""

    nodes: int
    local: int
    intra_bits_per_worker: float  # the island's spectra all_reduce
    inter_bits_per_node: float  # the fabric hop: ``nodes`` payloads an island
    inter_bits_per_worker: float  # the island's share over its workers


def two_level_wire_bits(payload_bits: float, nodes: int, local: int, *,
                        mode: str = "runtime", n_elems: Optional[int] = None,
                        chunk: int = 4096) -> TwoLevelWire:
    """Wire of one hierarchical exchange by axis.  Intra-node:
    ``runtime`` bills the dense-spectrum ring all-reduce over ``local``,
    ``2*(local-1)/local * dense_spectrum_bits`` (``n_elems`` required);
    ``modeled`` one compressed payload.  Inter-node: ``nodes`` compressed
    payloads land on each island, ``nodes * payload_bits / local`` a
    worker."""
    if nodes < 1 or local < 1:
        raise ValueError(f"topology must be >= (1, 1), got ({nodes}, {local})")
    if mode not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {mode!r}; expected {WIRE_MODES}")
    if mode == "runtime":
        if n_elems is None:
            raise ValueError("runtime two-level pricing needs n_elems: the intra-node "
                             "all_reduce moves the dense spectrum")
        intra = 2.0 * dense_spectrum_bits(n_elems, chunk) * (local - 1) / local
    else:
        intra = float(payload_bits) if local > 1 else 0.0
    inter_node = float(nodes) * float(payload_bits) if nodes > 1 else 0.0
    return TwoLevelWire(nodes=int(nodes), local=int(local), intra_bits_per_worker=intra,
                        inter_bits_per_node=inter_node,
                        inter_bits_per_worker=inter_node / float(local))


def transport_wire_bits(transport: str, payload_bits: float, workers: int, *,
                        mode: str = "modeled", n_elems: Optional[int] = None,
                        chunk: int = 4096, topology: Optional[Tuple[int, int]] = None) -> float:
    """Per-worker wire bits to exchange one compressed payload among P
    workers.

    * ``allgather``/``sequenced``: every worker receives all P payloads, P*B.
    * ``psum``: ``modeled`` prices the sparse all-reduce endpoint, B whatever
      P; ``runtime`` the dense-spectrum ring all-reduce the transport runs,
      ``2*(P-1)/P * dense_spectrum_bits(n_elems)`` (``n_elems`` required).
    * ``reduce_scatter``: ``modeled`` as ``psum``; ``runtime`` the scatter
      of the dense spectrum planes and the gather of the time-domain rows,
      each (P-1)/P a worker.
    * ``hierarchical``: needs ``topology=(nodes, local)``; the per-worker
      total of :func:`two_level_wire_bits` (intra + the inter share), for
      the one-link pricing functions; :func:`two_level_exchange_time_s`
      prices the hops at their own links.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if mode not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {mode!r}; expected {WIRE_MODES}")
    if transport in ("allgather", "sequenced"):
        return workers * payload_bits
    if transport == "psum":
        if mode == "runtime":
            if n_elems is None:
                raise ValueError(
                    "runtime psum pricing needs n_elems (the dense element count): "
                    "the transport moves the dense spectrum")
            return 2.0 * dense_spectrum_bits(n_elems, chunk) * (workers - 1) / workers
        return float(payload_bits)
    if transport == "reduce_scatter":
        if mode == "runtime":
            if n_elems is None:
                raise ValueError("runtime reduce_scatter pricing needs n_elems: the scatter "
                                 "moves the dense spectrum planes")
            dense = dense_spectrum_bits(n_elems, chunk) + dense_time_bits(n_elems, chunk)
            return dense * (workers - 1) / workers
        return float(payload_bits)
    if transport == "hierarchical":
        if topology is None:
            raise ValueError("hierarchical pricing needs topology=(nodes, local)")
        nodes, local = int(topology[0]), int(topology[1])
        if nodes * local != workers:
            raise ValueError(f"topology ({nodes}, {local}) does not multiply out to "
                             f"workers={workers}")
        wire = two_level_wire_bits(payload_bits, nodes, local, mode=mode, n_elems=n_elems,
                                   chunk=chunk)
        return wire.intra_bits_per_worker + wire.inter_bits_per_worker
    raise ValueError(f"unknown transport {transport!r}")


def bucketed_payload_bits(wire_bits_fn, sizes, transport: str = "sequenced", *,
                          stacked: bool = False, chunk: int = 4096) -> float:
    """Compressed payload bits of ONE exchange over a bucket layout.

    ``allgather`` compresses the whole buffer once (one quantizer's params);
    the bucketed transports bill one payload per bucket.  ``stacked=True``
    bills every bucket at the widest bucket's chunk-rounded width, which is
    what a ``StackedPayload`` moves."""
    sizes = list(sizes)
    if not sizes:
        raise ValueError("empty bucket layout")
    if transport not in ("allgather", "sequenced", "psum", "hierarchical", "reduce_scatter"):
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "allgather" or len(sizes) == 1:
        return float(wire_bits_fn(sum(sizes)))
    if stacked:
        padded = max(-(-s // chunk) * chunk for s in sizes)
        return float(len(sizes) * wire_bits_fn(padded))
    return float(sum(wire_bits_fn(s) for s in sizes))


def overlap_fraction(n_buckets: int) -> float:
    """Share of the compression hidden by pipelining n bucket exchanges."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    return (n_buckets - 1) / n_buckets


# Launch latency of one collective over the default link (seconds): the
# LogP latency term every collective pays before bytes move; an
# uncalibrated napkin figure (calibrate.py fits it per collective family).
COLLECTIVE_ALPHA_S = 25e-6

# Backward-pass rate (FLOP/s, 4 FLOPs per parameter per token) that
# ``calibrate.measure_backprop_rate`` measured for gemma2_2b at full width,
# 4 layers, batch 4 x seq 512 (forward and backward, bf16 compute), on an
# NVIDIA H100 80GB HBM3 at 700 W (power limit; chip_smoke.py's train-auto
# phase; PERF.md section 6).
BACKPROP_FLOPS_PER_S = 1.366419e14


def _resolve_pricing(transport: str, t_comm, thr, alpha_s, profile):
    """(t_comm, thr, alpha_s): explicit arguments, else ``profile`` (anything
    with ``t_comm(transport)``, ``alpha_s(transport)`` and ``throughputs``),
    else the uncalibrated defaults."""
    if t_comm is None:
        t_comm = profile.t_comm(transport) if profile is not None else NETWORKS[DEFAULT_NETWORK]
    if thr is None:
        thr = profile.throughputs if profile is not None else H100
    if alpha_s is None:
        alpha_s = profile.alpha_s(transport) if profile is not None else COLLECTIVE_ALPHA_S
    return t_comm, thr, alpha_s


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """A priced exchange configuration."""

    transport: str
    n_buckets: int
    workers: int
    wire_bits_per_worker: float
    exchange_s: float
    overlap: float
    n_collectives: int = 1
    launch_s: float = 0.0  # alpha * n_collectives


def exchange_time_s(message_bytes: float, payload_bits: float,
                    t_comm: Optional[float] = None, thr: Optional[Throughputs] = None, *,
                    workers: int, transport: str = "allgather", n_buckets: int = 1,
                    stacked: bool = False, alpha_s: Optional[float] = None, profile=None,
                    wire_mode: str = "modeled", chunk: int = 4096,
                    topology: Optional[Tuple[int, int]] = None) -> ExchangePlan:
    """Modeled wall time of one compressed gradient exchange.

    Compress + decompress cost comes from the §III-D throughputs.  The
    per-bucket loop pipelines: the overlap share of the smaller of
    (compress, wire) hides behind the other, at one launch per bucket; the
    stacked executor and ``allgather`` serialize the two at one launch."""
    t_comm, thr, alpha_s = _resolve_pricing(transport, t_comm, thr, alpha_s, profile)
    comp_s = 2.0 * compression_cost_s(message_bytes, thr)
    wire = transport_wire_bits(transport, payload_bits, workers, mode=wire_mode,
                               n_elems=int(-(-message_bytes // 4)), chunk=chunk,
                               topology=topology)
    wire_s = wire / 8.0 / t_comm
    if stacked or transport == "allgather" or n_buckets <= 1:
        n_coll, ov = 1, 0.0
        total = comp_s + wire_s
    else:
        n_coll = n_buckets
        ov = overlap_fraction(n_buckets)
        total = max(comp_s, wire_s) + min(comp_s, wire_s) * (1.0 - ov)
    launch_s = alpha_s * n_coll
    return ExchangePlan(transport=transport, n_buckets=n_buckets, workers=workers,
                        wire_bits_per_worker=wire, exchange_s=total + launch_s, overlap=ov,
                        n_collectives=n_coll, launch_s=launch_s)


@dataclasses.dataclass(frozen=True)
class StreamedExchangePlan:
    """A priced streamed exchange: the readiness timeline's verdict."""

    transport: str
    n_groups: int
    workers: int
    wire_bits_per_worker: float
    exchange_s: float  # total exchange work (sum over groups, launches included)
    exposed_s: float  # exchange time past the end of the backward pass
    hidden_s: float  # exchange_s - exposed_s
    overlap_efficiency: float  # hidden_s / exchange_s (0 with no backprop)
    step_s: float  # max(backprop_s, last group's finish)
    n_collectives: int
    launch_s: float  # alpha * n_collectives


def streamed_exchange_time_s(message_bytes: float, payload_bits: float,
                             t_comm: Optional[float] = None,
                             thr: Optional[Throughputs] = None, *, workers: int,
                             transport: str, group_fractions: Tuple[float, ...],
                             backprop_s: float, alpha_s: Optional[float] = None,
                             profile=None, wire_mode: str = "modeled",
                             chunk: int = 4096, overlap: bool = True,
                             topology: Optional[Tuple[int, int]] = None) -> StreamedExchangePlan:
    """Readiness-timeline model of one streamed exchange.

    Group g (``group_fractions`` in readiness order) is ready once the
    backward pass has produced the first g groups' share of the buffer;
    ``start_g = max(ready_g, finish_{g-1})``, ``finish_g = start_g + alpha +
    share_g * (compress + wire)``.  Work before ``backprop_s`` is hidden.
    ``overlap=False`` prices a dispatch that starts every group after the
    backward pass (every ``ready_g = backprop_s``): nothing is hidden."""
    if not group_fractions:
        raise ValueError("need at least one dispatch group")
    if abs(sum(group_fractions) - 1.0) > 1e-6:
        raise ValueError(f"group fractions must sum to 1: {group_fractions}")
    if backprop_s < 0.0:
        raise ValueError(f"backprop_s must be >= 0, got {backprop_s}")
    t_comm, thr, alpha_s = _resolve_pricing(transport, t_comm, thr, alpha_s, profile)
    wire_bits = transport_wire_bits(transport, payload_bits, workers, mode=wire_mode,
                                    n_elems=int(-(-message_bytes // 4)), chunk=chunk,
                                    topology=topology)
    comp_total = 2.0 * compression_cost_s(message_bytes, thr)
    wire_total = wire_bits / 8.0 / t_comm
    finish = total_work = ready = 0.0
    for frac in group_fractions:
        ready = ready + frac * backprop_s if overlap else backprop_s
        e_g = alpha_s + frac * (comp_total + wire_total)
        finish = max(ready, finish) + e_g
        total_work += e_g
    # exposed + hidden == exchange_s exactly; hidden derives from exposed
    exposed = min(max(0.0, finish - backprop_s), total_work) if overlap else total_work
    hidden = total_work - exposed
    n_groups = len(group_fractions)
    return StreamedExchangePlan(
        transport=transport, n_groups=n_groups, workers=workers,
        wire_bits_per_worker=wire_bits, exchange_s=total_work, exposed_s=exposed,
        hidden_s=hidden, overlap_efficiency=hidden / total_work if total_work > 0 else 0.0,
        step_s=max(backprop_s, finish), n_collectives=n_groups, launch_s=alpha_s * n_groups)


def dense_allreduce_bits(n_elems: int, workers: int, dtype_bits: int = 32) -> float:
    """Per-worker wire bits of one dense ring all-reduce: 2*(P-1)/P of the
    buffer."""
    if workers <= 1:
        return 0.0
    return 2.0 * dtype_bits * n_elems * (workers - 1) / workers


@dataclasses.dataclass(frozen=True)
class TwoLevelExchangePlan:
    """A priced hierarchical exchange: the wire and the time of each hop."""

    transport: str
    nodes: int
    local: int
    wire: TwoLevelWire
    intra_s: float  # the island hop at the intra-node link's rate
    inter_s: float  # the fabric hop at the inter-node link's rate
    comp_s: float  # the dense rfft pass, the node compress, the decompress
    launch_s: float  # one collective launch a hop that has more than one worker
    exchange_s: float  # the total


def _axis_link_pricing(transport: str, t_comm, alpha_s, profile, axis: Optional[str],
                       default_network: str):
    """(t_comm, alpha_s) of ONE hop: explicit, else the profile's fit on
    ``axis`` (its base fit when it has none there), else the default
    link's rate and :data:`COLLECTIVE_ALPHA_S`."""
    if t_comm is None:
        t_comm = (profile.t_comm(transport, axis=axis) if profile is not None
                  else NETWORKS[default_network])
    if alpha_s is None:
        alpha_s = (profile.alpha_s(transport, axis=axis) if profile is not None
                   else COLLECTIVE_ALPHA_S)
    return t_comm, alpha_s


def two_level_exchange_time_s(message_bytes: float, payload_bits: float, *, nodes: int,
                              local: int, thr: Optional[Throughputs] = None,
                              t_comm_intra: Optional[float] = None,
                              t_comm_inter: Optional[float] = None,
                              alpha_intra_s: Optional[float] = None,
                              alpha_inter_s: Optional[float] = None, profile=None,
                              wire_mode: str = "runtime", chunk: int = 4096,
                              intra_axis: str = "local",
                              inter_axis: str = "node") -> TwoLevelExchangePlan:
    """Modeled wall time of one hierarchical exchange: the island hop per
    worker at the intra-node rate (the profile's ``psum`` fit on
    ``intra_axis``, else :data:`NVLINK_NETWORK`), the fabric hop per node
    at the inter-node rate (its ``allgather`` fit on ``inter_axis``, else
    :data:`FABRIC_NETWORK`: an island's workers share one fabric endpoint),
    three passes of the compression pipeline (the dense rfft, the node
    compress, the gather's decompress) and one launch a hop with more than
    one worker."""
    if thr is None:
        thr = profile.throughputs if profile is not None else H100
    t_comm_intra, alpha_intra_s = _axis_link_pricing(
        "psum", t_comm_intra, alpha_intra_s, profile, intra_axis, NVLINK_NETWORK)
    t_comm_inter, alpha_inter_s = _axis_link_pricing(
        "allgather", t_comm_inter, alpha_inter_s, profile, inter_axis, FABRIC_NETWORK)
    wire = two_level_wire_bits(payload_bits, nodes, local, mode=wire_mode,
                               n_elems=int(-(-message_bytes // 4)), chunk=chunk)
    comp_s = 3.0 * compression_cost_s(message_bytes, thr)
    intra_s = wire.intra_bits_per_worker / 8.0 / t_comm_intra
    inter_s = wire.inter_bits_per_node / 8.0 / t_comm_inter
    launch_s = (alpha_intra_s if local > 1 else 0.0) + (alpha_inter_s if nodes > 1 else 0.0)
    return TwoLevelExchangePlan(transport="hierarchical", nodes=int(nodes), local=int(local),
                                wire=wire, intra_s=intra_s, inter_s=inter_s, comp_s=comp_s,
                                launch_s=launch_s,
                                exchange_s=comp_s + intra_s + inter_s + launch_s)
