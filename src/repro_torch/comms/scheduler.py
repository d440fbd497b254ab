"""Streamed dispatch and its cost-model policy (port of
``repro.comms.scheduler``: ``StreamPlan``, ``build_plan``,
``choose_schedule``, ``resolve_schedule``).

Three schedules, selected by ``ReducerConfig.schedule``:

* ``stacked``  -- one exchange of the whole gradient after the backward pass
  (one collective launch);
* ``streamed`` -- one exchange per readiness group: contiguous bucket ranges
  listed top of the flat buffer first (the backward pass finishes the last
  parameters' gradients first), dispatched in that order and reassembled
  in index order (``Transport.run(plan=...)``);
* ``auto``     -- the cost model picks between the two per model
  (:func:`choose_schedule`), pricing the streamed step as this package runs
  it (:data:`OVERLAPS_BACKWARD`).

Bitwise contract: a streamed exchange gives exactly the stacked exchange's
payloads and means.  Every bucket keeps its boundaries, its quantizer fit
and its payload slots; every per-row stage (rfft, the threshold, the fused
compress and decompress) and every per-bucket reduction (the masked fit,
the mid-gap tau) is independent of the other rows of the stacked matrix;
the worker mean is elementwise; and the error-feedback residual is computed
at the same group granularity.  The schedule is a dispatch shape, never a
numerics choice.

In the port the groups are dispatched after the backward pass, one after
another on the current stream: eager PyTorch gives the streamed schedule
no overlap with the backward pass (autograd hooks that start a group's
exchange as its gradients are final would; not ported).  What it changes on
one card is the size of the buffers live at once: a group holds its own
share of the spectra.  So ``auto`` prices the streamed step with no
overlap, where it costs a launch per group more than the stacked one and
never wins; the reference's overlapped timeline stays available as
``resolve_schedule(..., overlap=True)``.

``choose_transport`` and ``resolve_transport`` (the two-level transports'
policy) are not ported yet; the reference's deprecated shims
``exchange_streamed`` and ``local_roundtrip_streamed`` are left out on
purpose, as the transport's deprecated shims are (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.comms import bucketing, cost_model
from repro_torch.comms.bucketing import BucketLayout

__all__ = ["SCHEDULE_NAMES", "StreamPlan", "build_plan", "ScheduleDecision",
           "choose_schedule", "modeled_backprop_s", "resolve_schedule",
           "BACKPROP_FLOPS_PER_S", "DEFAULT_BATCH_TOKENS", "DEFAULT_WORKERS",
           "OVERLAPS_BACKWARD"]

SCHEDULE_NAMES = ("stacked", "streamed", "auto")

BACKPROP_FLOPS_PER_S = cost_model.BACKPROP_FLOPS_PER_S

# Worker count when the caller cannot give the group's size (a reducer
# built outside a train step): the smallest group that exchanges at all.
DEFAULT_WORKERS = 2

# Batch tokens when the caller cannot give them, so ``auto`` stays a pure
# function of its inputs everywhere.
DEFAULT_BATCH_TOKENS = 4096

# Whether this package's streamed step overlaps the backward pass: it does
# not (its groups are dispatched after it), and ``auto`` prices it so.
OVERLAPS_BACKWARD = False


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Dispatch schedule of one streamed exchange: ``groups`` are contiguous
    bucket ranges ``[lo, hi)`` in readiness order (``groups[0]`` covers the
    highest flat offsets and is dispatched first).  A frozen, hashable value:
    equal layouts give equal plans on every worker."""

    layout: BucketLayout
    groups: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        n = self.layout.n_buckets
        flat = [b for lo, hi in sorted(self.groups) for b in range(lo, hi)]
        if flat != list(range(n)):
            raise ValueError(f"groups {self.groups} do not partition {n} buckets")
        for (lo_a, _), (lo_b, _) in zip(self.groups, self.groups[1:]):
            if lo_b >= lo_a:
                raise ValueError(
                    f"groups must be readiness-ordered (descending offsets): {self.groups}")

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_slices(self):
        """Per group, in readiness order: (flat_lo, flat_hi, sub_layout)."""
        return [(self.layout.boundaries[lo], self.layout.boundaries[hi],
                 bucketing.sub_layout(self.layout, lo, hi)) for lo, hi in self.groups]

    def group_fractions(self) -> Tuple[float, ...]:
        """Each group's share of the elements, in readiness order."""
        total = float(self.layout.total)
        return tuple((self.layout.boundaries[hi] - self.layout.boundaries[lo]) / total
                     for lo, hi in self.groups)


def build_plan(layout: BucketLayout, n_groups: Optional[int] = None) -> StreamPlan:
    """Readiness-ordered groups over a layout: ``n_groups=None`` is one group
    per bucket; fewer groups merge adjacent buckets as evenly as possible,
    listed from the top of the flat buffer down."""
    n = layout.n_buckets
    g = n if n_groups is None else max(1, min(int(n_groups), n))
    base, extra = divmod(n, g)
    ranges, lo = [], 0
    for i in range(g):
        hi = lo + base + (1 if i < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return StreamPlan(layout, tuple(reversed(ranges)))


def modeled_backprop_s(n_params: int, batch_tokens: int,
                       flops_per_s: float = BACKPROP_FLOPS_PER_S) -> float:
    """Modeled backward pass: ~4 FLOPs per parameter per token."""
    return 4.0 * float(n_params) * float(batch_tokens) / flops_per_s


@dataclasses.dataclass(frozen=True)
class ScheduleDecision:
    """The auto policy's verdict and the numbers behind it."""

    schedule: str  # "stacked" | "streamed"
    stacked_step_s: float  # backprop + the serialized stacked exchange
    streamed_step_s: float  # max(backprop, the streamed finish)
    overlap_efficiency: float  # streamed: share of the exchange hidden
    n_groups: int
    backprop_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def choose_schedule(plan: StreamPlan, message_bytes: float, payload_bits: float, *,
                    workers: int, transport: str, backprop_s: float,
                    t_comm: Optional[float] = None,
                    thr: Optional[cost_model.Throughputs] = None,
                    alpha_s: Optional[float] = None, profile=None,
                    wire_mode: str = "runtime", overlap: bool = True) -> ScheduleDecision:
    """Stacked step = backprop + (alpha + compress + wire); streamed step =
    the readiness timeline's finish.  Streamed wins when the backward pass
    hides the per-group exchanges despite paying alpha per group.  A
    decision prices the bytes the transports move (``wire_mode="runtime"``);
    ``overlap`` says whether groups start during the backward pass
    (``cost_model.streamed_exchange_time_s``)."""
    stacked_plan = cost_model.exchange_time_s(
        message_bytes, payload_bits, t_comm, thr, workers=workers, transport=transport,
        n_buckets=plan.layout.n_buckets, stacked=True, alpha_s=alpha_s, profile=profile,
        wire_mode=wire_mode, chunk=plan.layout.chunk)
    streamed_plan = cost_model.streamed_exchange_time_s(
        message_bytes, payload_bits, t_comm, thr, workers=workers, transport=transport,
        group_fractions=plan.group_fractions(), backprop_s=backprop_s, alpha_s=alpha_s,
        profile=profile, wire_mode=wire_mode, chunk=plan.layout.chunk, overlap=overlap)
    stacked_step = backprop_s + stacked_plan.exchange_s
    streamed_step = streamed_plan.step_s
    return ScheduleDecision(
        schedule="streamed" if streamed_step < stacked_step else "stacked",
        stacked_step_s=stacked_step, streamed_step_s=streamed_step,
        overlap_efficiency=streamed_plan.overlap_efficiency, n_groups=plan.n_groups,
        backprop_s=backprop_s)


def resolve_schedule(config, n_elems: int, batch_tokens: Optional[int] = None, *,
                     workers: Optional[int] = None, profile=None,
                     overlap: bool = OVERLAPS_BACKWARD) -> Tuple[str, Optional[ScheduleDecision]]:
    """``ReducerConfig.schedule`` -> a concrete name (and, for ``auto``, the
    decision); a pure function of its inputs.  ``allgather``, one bucket or
    a compressor with no wire model has nothing to stream: ``stacked``.
    ``workers`` is the group's size (None: :data:`DEFAULT_WORKERS`);
    ``profile`` a measured ``calibrate.CostProfile``, which also gives the
    backward pass's length.  ``overlap`` defaults to what this package's
    streamed step does (:data:`OVERLAPS_BACKWARD`); ``overlap=True`` prices
    the reference's overlapped timeline."""
    if config.schedule != "auto":
        return config.schedule, None
    layout = config.layout_for(n_elems)
    if config.transport == "allgather" or layout.n_buckets == 1:
        return "stacked", None
    comp = _wire_model_compressor(config)
    if comp is None:
        return "stacked", None
    payload_bits = cost_model.bucketed_payload_bits(
        comp.wire_bits, layout.sizes(), config.transport, stacked=True, chunk=layout.chunk)
    plan = build_plan(layout, config.stream_groups)
    tokens = DEFAULT_BATCH_TOKENS if batch_tokens is None else batch_tokens
    p = DEFAULT_WORKERS if workers is None else int(workers)
    if profile is not None:
        backprop_s = profile.backprop_s(n_elems, tokens)
    else:
        backprop_s = modeled_backprop_s(n_elems, tokens)
    decision = choose_schedule(plan, 4.0 * n_elems, payload_bits, workers=p,
                               transport=config.transport, backprop_s=backprop_s,
                               profile=profile, overlap=overlap)
    return decision.schedule, decision


def _wire_model_compressor(config):
    """A compressor for ``wire_bits`` pricing (None when the kind has no
    static wire model, e.g. dense)."""
    from repro_torch.comms.reducers import _make_compressor

    try:
        comp = _make_compressor(config)
    except (ValueError, NotImplementedError):
        return None
    return comp if hasattr(comp, "wire_bits") else None
