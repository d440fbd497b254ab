"""Deterministic fault injection and the resilience primitives (port of
``repro.comms.faults``).

* **FaultPlan** -- a frozen, hashable plan of typed events, each pinned to a
  (step, worker) coordinate: ``NanGrad`` and ``PayloadCorrupt`` ride
  ``ReducerConfig.faults`` into the step; ``StepCrash`` and ``SlowWorker``
  fire host-side in the train loop (``TrainLoopConfig.faults``).
* **ExchangeMonitor** -- rides one compressed exchange: every payload this
  worker creates passes :meth:`ExchangeMonitor.on_payload` before it
  reaches a collective, which injects the planned corruption for this
  (step, worker) and folds the payload's validation verdict into one flag.
  Levels (``ReducerConfig.validate``): ``off`` (no work), ``cheap`` (index
  bounds, finite float planes, sane quantizer params), ``full`` (``cheap``
  plus per-plane checksums taken before the corruption and compared after,
  which catch value bits flipped into plausible codes).
* **ReducerHealth** -- the loop's record of skipped steps, delays and
  degradation-ladder transitions.

The reference traces the event matching inside its jitted step; the port
runs eagerly with the step counter and the worker's rank on the host, so
:func:`match_events` is host arithmetic and a corruption is applied or not.
The verdicts stay device tensors until the step's guard reads them.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional, Tuple

import torch

from repro_torch.core.compressor import drop_outside_indices
from repro_torch.core.quantizer import FittedQuantizer

__all__ = ["NanGrad", "PayloadCorrupt", "StepCrash", "SlowWorker", "FaultPlan",
           "InjectedCrash", "FatalInjectedCrash", "VALIDATE_LEVELS", "CORRUPT_PLANES",
           "ExchangeMonitor", "payload_checksums", "payload_leaves", "tree_finite",
           "validate_payload", "corrupt_payload", "match_events",
           "ReducerHealth"]

VALIDATE_LEVELS = ("off", "cheap", "full")

CORRUPT_PLANES = ("values", "idx", "quant")


class InjectedCrash(RuntimeError):
    """A planned, recoverable step failure (exercises rollback and retry)."""


class FatalInjectedCrash(Exception):
    """A planned process death.  Not a ``RuntimeError``: the loop's recovery
    never catches it; the caller restarts by calling ``train_loop`` again
    (auto-resume picks up the last checkpoint)."""


@dataclasses.dataclass(frozen=True)
class NanGrad:
    """Worker ``worker``'s local gradient becomes all-NaN at ``step``."""

    step: int
    worker: int
    kind: ClassVar[str] = "nan_grad"


@dataclasses.dataclass(frozen=True)
class PayloadCorrupt:
    """Worker ``worker``'s outgoing payload is corrupted at ``step``:
    ``idx`` (an out-of-bounds index, caught at ``cheap``), ``quant`` (a NaN
    eps, caught at ``cheap``) or ``values`` (low bits of the value plane
    flipped, still finite: only ``full``'s checksums catch it)."""

    step: int
    worker: int
    plane: str = "idx"
    kind: ClassVar[str] = "payload_corrupt"

    def __post_init__(self):
        if self.plane not in CORRUPT_PLANES:
            raise ValueError(
                f"unknown corrupt plane {self.plane!r}; expected one of {CORRUPT_PLANES}")


@dataclasses.dataclass(frozen=True)
class StepCrash:
    """The host step raises at ``step`` before the step runs:
    :class:`InjectedCrash` (recoverable) or, with ``fatal``,
    :class:`FatalInjectedCrash`.  Each event fires at most once per
    ``TrainLoopConfig``, so a resumed run completes."""

    step: int
    fatal: bool = False
    kind: ClassVar[str] = "step_crash"


@dataclasses.dataclass(frozen=True)
class SlowWorker:
    """Worker ``worker`` stalls ``delay_s`` seconds at ``step`` (a host
    sleep; the observable is the step's ``dt``)."""

    step: int
    worker: int
    delay_s: float = 0.05
    kind: ClassVar[str] = "slow_worker"


_EVENT_TYPES = (NanGrad, PayloadCorrupt, StepCrash, SlowWorker)
EVENT_KINDS = {cls.kind: cls for cls in _EVENT_TYPES}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, hashable schedule of fault events, JSON round-trippable
    (``to_dicts``/``from_dicts``)."""

    events: Tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for e in self.events:
            if not isinstance(e, _EVENT_TYPES):
                raise TypeError(f"not a fault event: {e!r}")

    @property
    def nan_events(self) -> Tuple[NanGrad, ...]:
        return tuple(e for e in self.events if isinstance(e, NanGrad))

    @property
    def corrupt_events(self) -> Tuple[PayloadCorrupt, ...]:
        return tuple(e for e in self.events if isinstance(e, PayloadCorrupt))

    @property
    def has_exchange_faults(self) -> bool:
        """True when any event must reach the step."""
        return bool(self.nan_events or self.corrupt_events)

    def crashes_at(self, step: int) -> List[Tuple[int, StepCrash]]:
        """(event index, event) of every crash planned at ``step``."""
        return [(i, e) for i, e in enumerate(self.events)
                if isinstance(e, StepCrash) and e.step == step]

    def delay_at(self, step: int) -> float:
        return sum(e.delay_s for e in self.events
                   if isinstance(e, SlowWorker) and e.step == step)

    def to_dicts(self) -> List[Dict]:
        return [dict(kind=e.kind, **dataclasses.asdict(e)) for e in self.events]

    @classmethod
    def from_dicts(cls, dicts: Optional[List[Dict]]) -> Optional["FaultPlan"]:
        if not dicts:
            return None
        events = []
        for d in dicts:
            d = dict(d)
            kind = d.pop("kind")
            if kind not in EVENT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; expected one of {sorted(EVENT_KINDS)}")
            events.append(EVENT_KINDS[kind](**d))
        return cls(tuple(events))


def match_events(events, step, worker=None) -> bool:
    """Does any event hit this (step, worker)?  An event without a worker
    matches every worker."""
    return any(int(step) == e.step
               and (worker is None or not hasattr(e, "worker") or int(worker) == e.worker)
               for e in events)


def payload_leaves(payload) -> List[torch.Tensor]:
    """A payload's tensors in the reference's pytree leaf order: dataclass
    fields in order, a quantizer fit as (eps, p_codes, vmax, vmin); lists,
    tuples and dicts (by sorted key) recursively."""
    if isinstance(payload, torch.Tensor):
        return [payload]
    if isinstance(payload, FittedQuantizer):
        return [payload.eps, payload.p_codes, payload.vmax, payload.vmin]
    if isinstance(payload, dict):
        return [t for k in sorted(payload) for t in payload_leaves(payload[k])]
    if isinstance(payload, (list, tuple)):
        return [t for item in payload for t in payload_leaves(item)]
    if dataclasses.is_dataclass(payload):
        return [t for f in dataclasses.fields(payload)
                for t in payload_leaves(getattr(payload, f.name))]
    return []


def _leaf_checksum(x: torch.Tensor) -> torch.Tensor:
    """uint32 wrap-around sum of a plane's raw bits, as an int64 in
    [0, 2**32): an int64 sum wraps modulo 2**64, a multiple of 2**32, so the
    masked sum is bitwise the reference's uint32 sum."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    if x.is_floating_point():
        bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    else:
        bits = x.to(torch.int64)
    return (bits & 0xFFFFFFFF).sum() & 0xFFFFFFFF


def payload_checksums(payload) -> Tuple[torch.Tensor, ...]:
    """Per-plane checksums over a payload's leaves."""
    return tuple(_leaf_checksum(t) for t in payload_leaves(payload))


def _true(device=None) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=device)


def tree_finite(tree) -> torch.Tensor:
    """AND of ``isfinite`` over every non-empty float leaf (a bool tensor)."""
    leaves = payload_leaves(tree)
    ok = _true(leaves[0].device if leaves else None)
    for leaf in leaves:
        if leaf.is_floating_point() and leaf.numel():
            ok = ok & torch.isfinite(leaf).all()
    return ok


def validate_payload(payload, level: str, *, reference_checksums=None) -> torch.Tensor:
    """Bool tensor: is this payload sound at ``level``?  FFT and stacked
    payloads get their structural checks (``.validate``), anything else
    float finiteness; at ``full`` the checksums taken at compress time are
    compared too."""
    if level not in VALIDATE_LEVELS:
        raise ValueError(f"unknown validate level {level!r}; expected one of {VALIDATE_LEVELS}")
    if level == "off":
        return _true()
    ok = payload.validate(level) if hasattr(payload, "validate") else tree_finite(payload)
    if level == "full" and reference_checksums is not None:
        for got, want in zip(payload_checksums(payload), reference_checksums):
            ok = ok & (got == want)
    return ok


def _flip_bits(plane: torch.Tensor) -> torch.Tensor:
    """Silent corruption: low mantissa bits of a float plane (still finite),
    the 0x55 bits of a code plane."""
    if plane.numel() == 0:
        return plane
    if plane.is_floating_point():
        bits = plane.float().contiguous().view(torch.int32) ^ 0x000FFF00
        return bits.view(torch.float32).to(plane.dtype)
    return (plane.to(torch.int64) ^ 0x55).to(plane.dtype)


def corrupt_payload(payload, plane_hits: Dict[str, bool]):
    """Apply the planned corruption to an FFT or stacked payload: each plane
    named in ``plane_hits`` with a true hit is corrupted whole.  Other
    payloads (the baselines') pass through."""
    if not (hasattr(payload, "idx") and hasattr(payload, "re")):
        return payload
    out = payload
    if plane_hits.get("values"):
        out = dataclasses.replace(out, re=_flip_bits(out.re))
    if plane_hits.get("idx"):
        # one past the last valid bin: out of [0, chunk)
        out = dataclasses.replace(out, idx=torch.full_like(out.idx, out.chunk))
    if plane_hits.get("quant") and out.quant is not None:
        q = out.quant
        out = dataclasses.replace(out, quant=dataclasses.replace(
            q, eps=torch.full_like(q.eps, float("nan"))))
    return out


class ExchangeMonitor:
    """Per-exchange corruption injector and validation accumulator: one per
    reduce call; ``ok()`` is this worker's AND of every payload verdict,
    which the step's guard folds across workers."""

    def __init__(self, level: str = "off", *, step=None, worker=None,
                 corrupt: Tuple[PayloadCorrupt, ...] = ()):
        if level not in VALIDATE_LEVELS:
            raise ValueError(
                f"unknown validate level {level!r}; expected one of {VALIDATE_LEVELS}")
        self.level = level
        self.step = step
        self.worker = worker
        self.corrupt = tuple(corrupt)
        self._ok = None

    def on_payload(self, payload):
        reference = payload_checksums(payload) if self.level == "full" else None
        if self.corrupt and self.step is not None and self.worker is not None:
            hits = {plane: match_events(tuple(e for e in self.corrupt if e.plane == plane),
                                        self.step, self.worker)
                    for plane in CORRUPT_PLANES if any(e.plane == plane for e in self.corrupt)}
            payload = corrupt_payload(payload, hits)
        if self.level != "off":
            ok = validate_payload(payload, self.level, reference_checksums=reference)
            self._ok = ok if self._ok is None else self._ok & ok
        return payload

    def admit(self, payload):
        """A payload received from any worker, made safe to decode
        (``compressor.drop_outside_indices``): a corrupted index decodes to
        nothing instead of reaching past the spectrum."""
        if not (hasattr(payload, "idx") and hasattr(payload, "re")):
            return payload
        return drop_outside_indices(payload)

    def ok(self) -> torch.Tensor:
        return _true() if self._ok is None else self._ok


@dataclasses.dataclass
class ReducerHealth:
    """Host-side record of guard skips and degradation-ladder transitions."""

    skipped_steps: int = 0
    skip_steps: List[int] = dataclasses.field(default_factory=list)
    delays: int = 0
    transitions: List[Dict] = dataclasses.field(default_factory=list)

    def record_skip(self, step: int):
        self.skipped_steps += 1
        self.skip_steps.append(int(step))

    def record_delay(self, step: int):
        self.delays += 1

    def record_transition(self, step: int, rung: str, reason: str):
        self.transitions.append({"step": int(step), "rung": rung, "reason": str(reason)})

    def to_dict(self) -> Dict:
        return {"skipped_steps": int(self.skipped_steps), "skip_steps": list(self.skip_steps),
                "delays": int(self.delays), "transitions": list(self.transitions)}
