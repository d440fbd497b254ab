"""Gradient reducers (port of ``repro.comms.reducers``: ``flatten_tree``,
``unflatten_tree``, ``ReducerConfig``, ``make_reducer`` and
``degrade_config``).

Kinds: ``dense`` (the mean over the group, the paper's "orig" baseline: one
SUM all_reduce divided by the world size, as ``pmean``), ``fft`` (the
paper's compressed exchange), ``timedomain`` (top-k of the raw values,
Fig. 12), ``terngrad`` and ``qsgd`` (Table I), and ``hierarchical`` (over a
two-level mesh: the dense mean over the island's ``local`` group, then the
fft exchange with ``config.transport`` over the ``node`` group; over a mesh
with a ``pod`` axis, the ``--mode hierarchical`` step's: the dense mean over
the pod's ``data`` group, then the exchange over the ``pod`` group -- the
reference's ``axis=None, pod_axis="pod"``).  The
compressed kinds run with and without error feedback over the transports of
``comms/transport.py``.

The group of :func:`make_reducer` is a ``torch.distributed`` group or a
``launch.mesh.Mesh``: on a two-level mesh the flat transports and
``reduce_scatter`` run over its ``flat`` group, ``hierarchical`` over its
``(node, local)`` pair.

A gradient tree here is a mapping from dotted parameter paths to tensors
(``"layers.l0_attn_local_mlp.attn.wq"``).  :func:`flatten_tree` walks it in
the reference's leaf order -- JAX flattens nested dicts by sorted key at
every level, which is the order of the paths as tuples of their parts -- so
bucket boundaries, per-bucket quantizer fits and the error-feedback residual
cover the same coefficients in both packages.

``ReducerConfig.schedule`` picks the exchange's dispatch shape
(``comms/scheduler.py``): ``stacked`` (one dispatch over the whole layout),
``streamed`` (one per readiness group, bitwise the same result) or ``auto``
(the cost model decides).  ``auto`` is resolved in one place, when the
train step is built (``scheduler.resolve_schedule`` with the model's
parameter count, the batch's tokens, the group's size and topology and,
given one, a measured ``calibrate.CostProfile``); :func:`make_reducer`
takes a resolved schedule and refuses ``auto``.  So with
``transport='auto'`` (``scheduler.resolve_transport``: flat ``psum`` or
``hierarchical`` on the mesh's topology).

The resilience layer (``comms/faults.py``): with ``validate != "off"`` or a
``FaultPlan`` holding payload corruption (``config.resilient``) the reduce
functions take ``step=`` and return one more value, ``ok``: this worker's
AND of every payload verdict, which the step's guard folds across workers.
The FaultPlan's worker coordinate is the reference's: the row-major index
over the reducer's axes, ``(axis, pod_axis)``.  Over a two-level mesh that
is the rank (``("node", "local")``, node-major), except for the
``hierarchical`` kind, whose ``axis`` is the island's ``local`` and
``pod_axis`` the ``node``: ``local_index * nodes + node_index`` (over a
mesh with a ``pod`` axis, the pod's index).
:func:`degrade_config` is one rung down the degradation ladder the train
loop walks; on the card it has no ``backend`` rung, since the kernels are
the only path there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.comms import bucketing, collectives, scheduler
from repro_torch.comms import faults as faults_mod
from repro_torch.comms.transport import TRANSPORT_NAMES, get_transport
from repro_torch.core import baselines
from repro_torch.core.compressor import (FFTCompressor, FFTCompressorConfig,
                                         TimeDomainCompressor)
from repro_torch.core.selection import SELECTOR_NAMES
from repro_torch.dist_util import world_size
from repro_torch.kernels.engine import BACKEND_NAMES
from repro_torch.launch.mesh import Mesh

__all__ = ["ReducerConfig", "make_reducer", "degrade_config", "dense_mean", "fault_worker",
           "flatten_tree",
           "unflatten_tree", "leaf_order", "residual_size", "REDUCER_KINDS"]

REDUCER_KINDS = ("dense", "fft", "timedomain", "terngrad", "qsgd", "hierarchical")

LeafSpec = Tuple[str, torch.Size, torch.dtype]


def leaf_order(names) -> List[str]:
    """Dotted paths in the reference's flatten order (sorted as tuples)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def flatten_tree(tree: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, List[LeafSpec]]:
    """Concatenate all leaves into one f32 vector -> (flat, specs)."""
    specs, parts = [], []
    for name in leaf_order(tree.keys()):
        leaf = tree[name]
        specs.append((name, leaf.shape, leaf.dtype))
        parts.append(leaf.reshape(-1).float())
    return torch.cat(parts), specs


def unflatten_tree(flat: torch.Tensor, specs: List[LeafSpec]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_tree` (leaves are views of ``flat`` when the
    dtype is already f32)."""
    out, offset = {}, 0
    for name, shape, dtype in specs:
        size = shape.numel()
        out[name] = flat[offset: offset + size].reshape(shape).to(dtype)
        offset += size
    return out


def residual_size(params: Mapping[str, torch.Tensor]) -> int:
    """Flat residual length for error-feedback state."""
    return sum(p.numel() for p in params.values())


@dataclasses.dataclass(frozen=True)
class ReducerConfig:
    """The reference's reducer knobs, but the mesh axes: the port's exchange
    runs over a ``torch.distributed`` group."""

    kind: str = "dense"
    theta: float = 0.7
    n_bits: int = 8
    m_bits: int = 3
    chunk: int = 4096
    quantize: bool = True
    range_mode: str = "auto"  # "fixed": every fit uses fixed_range
    fixed_range: Tuple[float, float] = (-1.0, 1.0)
    error_feedback: bool = False
    bucket_bytes: Optional[int] = None  # None: one monolithic bucket
    # allgather | sequenced | psum | hierarchical | reduce_scatter, or auto
    # (resolved by scheduler.resolve_transport before make_reducer)
    transport: str = "allgather"
    backend: str = "reference"
    # batched bucket executor: every bucket in one batched pass and one
    # StackedPayload per exchange; False runs the per-bucket loop
    stacked: bool = True
    # dispatch schedule: stacked | streamed | auto (comms/scheduler.py)
    schedule: str = "stacked"
    # streamed readiness groups (None: one group per bucket)
    stream_groups: Optional[int] = None
    selector: str = "sort"
    sample_rate: float = 1.0 / 64.0
    tau_refine_iters: int = 16
    # resilience: payload validation level (off | cheap | full) and a
    # deterministic FaultPlan (comms/faults.py)
    validate: str = "off"
    faults: Optional[faults_mod.FaultPlan] = None

    @property
    def resilient(self) -> bool:
        """True when the reduce functions take ``step=`` and return ``ok``.
        A dense config (also one the ladder reached, which keeps the plan
        for its gradient-level events) has no payloads: never resilient."""
        if self.kind == "dense":
            return False
        return (self.validate != "off"
                or (self.faults is not None and bool(self.faults.corrupt_events)))

    def __post_init__(self):
        if self.kind not in REDUCER_KINDS:
            raise ValueError(f"unknown reducer kind {self.kind!r}; expected one of "
                             f"{REDUCER_KINDS}")
        if self.selector not in SELECTOR_NAMES:
            raise ValueError(
                f"unknown selector {self.selector!r}; expected one of {SELECTOR_NAMES}")
        if self.transport not in TRANSPORT_NAMES + ("auto",):
            raise ValueError(f"unknown transport {self.transport!r}; expected one of "
                             f"{TRANSPORT_NAMES + ('auto',)}")
        if self.bucket_bytes is not None and self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got {self.bucket_bytes}")
        if self.backend not in BACKEND_NAMES:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKEND_NAMES}")
        if self.schedule not in scheduler.SCHEDULE_NAMES:
            raise ValueError(f"unknown schedule {self.schedule!r}; expected one of "
                             f"{scheduler.SCHEDULE_NAMES}")
        # allgather fits ONE quantizer over the whole buffer; per-group fits
        # would change the numerics
        if self.schedule == "streamed" and self.transport == "allgather":
            raise ValueError("schedule='streamed' needs a bucketed transport "
                             "(sequenced|psum); allgather is monolithic by definition")
        if self.stream_groups is not None and self.stream_groups < 1:
            raise ValueError(f"stream_groups must be >= 1, got {self.stream_groups}")
        if self.validate not in faults_mod.VALIDATE_LEVELS:
            raise ValueError(f"unknown validate level {self.validate!r}; expected one of "
                             f"{faults_mod.VALIDATE_LEVELS}")
        if self.faults is not None and not isinstance(self.faults, faults_mod.FaultPlan):
            raise TypeError(f"faults must be a comms.faults.FaultPlan, got "
                            f"{type(self.faults).__name__}")

    def compressor_config(self) -> FFTCompressorConfig:
        return FFTCompressorConfig(
            theta=self.theta, n_bits=self.n_bits, m_bits=self.m_bits, chunk=self.chunk,
            quantize=self.quantize, range_mode=self.range_mode, fixed_range=self.fixed_range,
            backend=self.backend, selector=self.selector,
            sample_rate=self.sample_rate, tau_refine_iters=self.tau_refine_iters)

    def layout_for(self, total: int) -> bucketing.BucketLayout:
        return bucketing.build_layout(total, self.bucket_bytes, self.chunk)


def dense_mean(grads: Mapping[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The mean of every worker's gradient tree: ONE SUM all_reduce of the
    flattened tree, divided by the world size (``pmean`` divides, it does not
    multiply by 1/P).  With one worker the tree comes back as it is, and no
    collective runs."""
    world = world_size(group)
    if world == 1:
        return dict(grads)
    flat, specs = flatten_tree(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return unflatten_tree(flat / world, specs)


def _make_compressor(config: ReducerConfig):
    if config.kind in ("fft", "hierarchical"):
        return FFTCompressor(config.compressor_config())
    if config.kind == "timedomain":
        return TimeDomainCompressor(config.compressor_config())
    if config.kind == "terngrad":
        return baselines.TernGrad()
    if config.kind == "qsgd":
        return baselines.QSGD()
    raise ValueError(f"unknown compressed reducer kind {config.kind!r}")


def _pmean_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """``pmean`` of a flat buffer: one SUM all_reduce divided by the world
    size (``flat`` itself with one worker)."""
    world = world_size(group)
    if world == 1:
        return flat
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat / world


def fault_worker(config: ReducerConfig, group) -> int:
    """The FaultPlan's worker coordinate: the reference's row-major index
    over ``(axis, pod_axis)``; over a mesh the ``hierarchical`` kind's axes
    are ``(local, node)``, every other kind's the mesh's own."""
    if isinstance(group, Mesh) and config.kind == "hierarchical":
        if "pod" in group.shape:
            return group.index("pod")
        return collectives.axis_linear_index(group.axis_names[::-1], mesh=group)
    return collectives.axis_linear_index(group)


def make_reducer(config: ReducerConfig, group=None):
    """Returns the reduce function of ``config.kind``.

    ``dense``: ``reduce(grads) -> mean_grads``; it raises with error
    feedback, which has nothing to accumulate.  The compressed kinds:
    without error feedback ``reduce(grads) -> mean_grads``; with it
    ``reduce(grads, residual) -> (mean_grads, residual')`` where
    ``residual' = corrected - local_roundtrip(corrected)`` and
    ``corrected = flat(grads) + residual``, the roundtrip at the exchange's
    own dispatch granularity.  When ``config.resilient`` both take
    ``step=`` (this step's counter, which the FaultPlan matches) and return
    one more value, this worker's payload verdict ``ok``.

    ``group`` is the ``torch.distributed`` group the mean runs over (the
    default group when one is initialized, else one worker), or a
    ``launch.mesh.Mesh`` (the ``hierarchical`` kind needs a two-level one or
    one with a ``pod`` axis; over a ``pod`` mesh a flat kind's mean runs over
    the ``("pod", "data")`` group).
    ``config.schedule`` and ``config.transport`` must be resolved: ``auto``
    is priced once, by ``scheduler.resolve_schedule`` and
    ``scheduler.resolve_transport`` (the train step calls them)."""
    if config.schedule == "auto":
        raise ValueError("make_reducer needs a resolved schedule; resolve schedule='auto' "
                         "with scheduler.resolve_schedule first (build_train_step does)")
    if config.transport == "auto":
        raise ValueError("make_reducer needs a resolved transport; resolve transport='auto' "
                         "with scheduler.resolve_transport first (build_train_step does)")
    flat_group = group
    if isinstance(group, Mesh):
        flat_group = group.group(("pod", "data")) if "pod" in group.shape else group.flat
    if config.kind == "dense":
        if config.error_feedback:
            raise ValueError("error feedback is meaningless for dense reduction")
        return lambda grads: dense_mean(grads, flat_group)
    island = None  # the hierarchical kind's dense-mean group
    exchange_group = group
    if config.kind == "hierarchical":
        if isinstance(group, Mesh) and "pod" in group.shape:
            island, exchange_group = group.group("data"), group.group("pod")
        elif isinstance(group, Mesh) and group.topology is not None:
            island, exchange_group = group.local, group.node
        else:
            raise ValueError("the hierarchical reducer kind needs a two-level mesh "
                             "(launch.mesh.make_two_level_mesh) or one with a 'pod' axis "
                             "as its group")
    comp = _make_compressor(config)
    transport = get_transport(config.transport)
    resilient = config.resilient
    worker = fault_worker(config, group)
    dispatch = {}

    def _dispatch_spec(total: int) -> dict:
        """``layout=`` or ``plan=`` for ``Transport.run``: a plan when the
        schedule streams a multi-bucket layout."""
        if total not in dispatch:
            layout = config.layout_for(total)
            if config.schedule == "streamed" and layout.n_buckets > 1:
                dispatch[total] = {"plan": scheduler.build_plan(layout, config.stream_groups)}
            else:
                dispatch[total] = {"layout": layout}
        return dispatch[total]

    def _monitor(step):
        """One ExchangeMonitor per reduce call (None when not resilient)."""
        if not resilient:
            return None
        corrupt = config.faults.corrupt_events if config.faults is not None else ()
        return faults_mod.ExchangeMonitor(config.validate, step=-1 if step is None else step,
                                          worker=worker, corrupt=corrupt)

    def _run(flat, local: bool, monitor=None):
        return transport.run(flat, comp=comp, local=local, group=exchange_group,
                             stacked=config.stacked, monitor=monitor,
                             **_dispatch_spec(flat.shape[0]))

    def _flat(grads):
        """The flat gradient (fresh) and its specs; the hierarchical kind's
        is the island's dense mean."""
        with tracing.span("exchange.flat"):
            flat, specs = flatten_tree(grads)
        return (flat if island is None else _pmean_flat(flat, island)), specs

    def compressed_reduce(grads, step=None):
        monitor = _monitor(step)
        flat, specs = _flat(grads)
        mean_flat = _run(flat, local=False, monitor=monitor)
        with tracing.span("exchange.flat"):
            mean = unflatten_tree(mean_flat, specs)
        return (mean, monitor.ok()) if resilient else mean

    if not config.error_feedback:
        return compressed_reduce

    def ef_reduce(grads, residual_flat, step=None):
        monitor = _monitor(step)
        flat, specs = _flat(grads)
        with tracing.span("exchange.flat"):
            corrected = flat.add_(residual_flat)  # flat is a fresh buffer
        # the roundtrip is not monitored: the residual never crosses the wire
        local_hat = _run(corrected, local=True)
        with tracing.span("exchange.flat"):
            new_residual = corrected - local_hat
        del local_hat
        mean_flat = _run(corrected, local=False, monitor=monitor)
        with tracing.span("exchange.flat"):
            mean = unflatten_tree(mean_flat, specs)
        return (mean, new_residual, monitor.ok()) if resilient else (mean, new_residual)

    return ef_reduce


def degrade_config(config: ReducerConfig,
                   device=None) -> Optional[Tuple[ReducerConfig, str]]:
    """One rung down the degradation ladder: (simpler config, rung label),
    or None when already dense.  The rungs drop the most elaborate machinery
    first: the kernels (``cuda``/``auto`` -> ``reference``), streamed or
    auto dispatch (-> ``stacked``), a two-level transport (-> ``psum``),
    then compression itself (-> ``dense``, error feedback and validation
    off; the loop drops the residual from the state on this rung).  The
    FaultPlan is kept: gradient-level events go on replaying.

    ``device`` is where the exchange's tensors lie (None: the CPU).  On a
    CUDA device the ladder has no ``backend`` rung: the hand-written kernels
    are the only path on the card, so a failure there is never answered by
    running their plain versions; the next rung down is taken instead."""
    if config.kind == "dense":
        return None
    on_card = device is not None and torch.device(device).type == "cuda"
    if config.backend != "reference" and not on_card:
        return (dataclasses.replace(config, backend="reference"),
                f"backend:{config.backend}->reference")
    if config.schedule != "stacked":
        return (dataclasses.replace(config, schedule="stacked"),
                f"schedule:{config.schedule}->stacked")
    if config.transport in ("hierarchical", "reduce_scatter", "auto"):
        return (dataclasses.replace(config, transport="psum"),
                f"transport:{config.transport}->psum")
    return (dataclasses.replace(config, kind="dense", error_feedback=False, validate="off"),
            f"kind:{config.kind}->dense")
