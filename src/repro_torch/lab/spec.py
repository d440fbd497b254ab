"""Declarative experiment specs for the convergence lab (port of
``repro.lab.spec``).

An :class:`ExperimentSpec` is the full recipe for one end-to-end training
run: model x compressor x transport x theta-schedule x worker count.  Specs
are plain data (JSON round-trippable) so the whole matrix lands verbatim in
the lab's JSON artifact and any row can be re-run.

The *smoke* matrix is the tier-2 gate (two model families, every
transport); the *full* matrix adds the remaining compressor baselines,
schedules, and worker counts for the manual ``python -m repro_torch.lab.run``
sweep.  The matrices are the reference's row for row, but for the backend
axis: the reference's ``{model}_fft_theta0.7_pallas`` row is
``{model}_fft_theta0.7_cuda`` here, on the ``cuda`` backend.  The
validation lists are the port's own (``kernels/engine.py``,
``comms/scheduler.py``, ``core/selection.py``, ``comms/faults.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["ExperimentSpec", "smoke_matrix", "full_matrix", "chaos_matrix",
           "group_by_model"]

from repro_torch.comms.faults import EVENT_KINDS, VALIDATE_LEVELS
from repro_torch.comms.scheduler import SCHEDULE_NAMES
from repro_torch.core.selection import SELECTOR_NAMES
from repro_torch.kernels.engine import BACKEND_NAMES


@dataclasses.dataclass
class ExperimentSpec:
    """One end-to-end training run, declaratively.

    ``reducer=None`` is the dense (pjit all-reduce) baseline; everything else
    runs ``compressed_dp`` over a (workers,)-shaped ``data`` mesh.
    ``schedule`` is a ``core.schedules.make_schedule`` description, e.g.
    ``{"kind": "constant", "theta": 0.7}``; ``None`` means no theta schedule
    (the reducer's static theta runs unscheduled — only sensible for dense).
    """

    name: str
    model: str = "lm"  # lm | convnet
    reducer: Optional[str] = "fft"  # None | fft | timedomain | terngrad | qsgd
    # allgather | sequenced | psum | hierarchical | reduce_scatter
    transport: str = "allgather"
    backend: str = "reference"  # reference | cuda | auto (kernels/engine.py)
    bucket_bytes: Optional[int] = None
    theta: float = 0.7
    schedule: Optional[Dict] = None  # make_schedule(**...) description
    workers: int = 8
    steps: int = 50
    global_batch: int = 16
    opt: str = "adamw"  # adamw | sgd (sgd runs momentum 0.9, paper-style)
    lr: float = 3e-3
    seed: int = 0
    quantize: bool = True
    error_feedback: bool = False
    # batched bucket executor (DESIGN.md §14): one collective per exchange;
    # False runs the per-bucket loop (bitwise-identical trajectories)
    stacked: bool = True
    # overlap engine (DESIGN.md §15): exchange dispatch schedule —
    # stacked | streamed | auto.  Named exchange_schedule because `schedule`
    # is this spec's THETA schedule; maps to ReducerConfig.schedule.
    exchange_schedule: str = "stacked"
    # selection engine (DESIGN.md §16): sort | sampled | bisect | auto top-k
    # selector; maps to ReducerConfig.selector
    selector: str = "sort"
    # Assumption 3.1 probe cadence: 1 = every step (smoke default); 0 = off
    probe_every: int = 1
    # two-level topology (DESIGN.md §18): split the workers into this many
    # NVLink-island nodes ((nodes, workers/nodes) x ("node", "local")); the
    # exchange then rides both axes and the hierarchical transports apply.
    # None keeps the flat (workers,) x ("data",) mesh.
    nodes: Optional[int] = None
    # chaos lane (DESIGN.md §19): a deterministic fault plan in its
    # JSON-dict form (``comms.faults.FaultPlan.to_dicts()``) — nan_grad /
    # payload_corrupt events ride the reducer into the jitted step,
    # step_crash / slow_worker fire host-side in the train loop
    faults: Optional[List[Dict]] = None
    # payload validation level on the exchange (ReducerConfig.validate):
    # off | cheap (index bounds + quantizer sanity) | full (+ checksums)
    validate: str = "off"
    # checkpoint cadence for crash/resume rows; 0 = no checkpointing
    ckpt_every: int = 0

    def __post_init__(self):
        if self.model not in ("lm", "convnet"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.backend not in BACKEND_NAMES:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.exchange_schedule not in SCHEDULE_NAMES:
            raise ValueError(
                f"unknown exchange_schedule {self.exchange_schedule!r}")
        if self.selector not in SELECTOR_NAMES:
            raise ValueError(f"unknown selector {self.selector!r}")
        if self.exchange_schedule == "streamed" and self.transport == "allgather":
            raise ValueError(
                "exchange_schedule='streamed' needs a bucketed transport "
                "(sequenced|psum)")
        if self.nodes is not None and (
                self.nodes < 1 or self.workers % self.nodes):
            raise ValueError(
                f"workers {self.workers} must split evenly into nodes "
                f"{self.nodes}")
        if self.transport == "hierarchical" and self.nodes is None:
            raise ValueError(
                "transport='hierarchical' needs a two-level mesh: set nodes")
        if self.reducer is None and self.schedule is not None:
            raise ValueError("dense baseline cannot take a theta schedule")
        if self.validate not in VALIDATE_LEVELS:
            raise ValueError(f"unknown validate level {self.validate!r}")
        if self.faults is not None:
            for ev in self.faults:
                if not isinstance(ev, dict) or ev.get("kind") not in EVENT_KINDS:
                    raise ValueError(f"unknown fault event {ev!r}")
        if self.ckpt_every < 0:
            raise ValueError(f"ckpt_every must be >= 0, got {self.ckpt_every}")
        if self.workers < 1 or self.global_batch % self.workers:
            raise ValueError(
                f"global_batch {self.global_batch} must divide by workers {self.workers}"
            )
        # theta and schedule encode the same knob: where the schedule's
        # initial value is derivable, the static theta must agree, so the
        # artifact's recipe can never contradict what actually ran
        if self.schedule is not None:
            kind = self.schedule.get("kind")
            initial = None
            if kind == "constant":
                initial = self.schedule["theta"]
            elif kind == "step_decay":
                initial = sorted(self.schedule["points"])[0][1]
            elif kind in ("polynomial_decay", "sigmoid_decay"):
                initial = self.schedule["theta0"]
            if initial is not None and abs(self.theta - initial) > 1e-9:
                raise ValueError(
                    f"theta={self.theta} disagrees with the schedule's "
                    f"initial value {initial}; set them equal")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExperimentSpec":
        return cls(**d)


def _matrix(model: str, *, workers: int, steps: int, seed: int = 0) -> List[ExperimentSpec]:
    """The per-model claim matrix: dense baseline, the paper's theta points,
    mixed comp, and the transport trio (same config, only transport varies).

    The transport trio runs monolithic payloads (``bucket_bytes=None``): with
    one bucket the per-bucket quantizer fit equals the global fit, so all
    three transports realize the SAME mean and the curves must be identical
    (the equivalence claim).  Bucketed quantized runs differ by design
    (per-bucket ranges) and are exercised by tests/test_transports.py instead.
    """
    base = dict(model=model, workers=workers, steps=steps, seed=seed)
    if model == "convnet":
        # paper-faithful CNN training: momentum SGD (adam's per-coordinate
        # normalization amplifies compression noise on the tiny convnet)
        base.update(opt="sgd", lr=0.1)
    # paper §IV-A1 "mixed comp": high theta early, fully dense late.  The
    # switch sits at one sixth of the run so the dense phase has room to
    # close the early-compression gap within a smoke-sized budget (momentum
    # SGD on the convnet needs most of the run to recover).
    mixed_points = [[0, 0.99], [max(steps // 6, 1), 0.0]]
    specs = [
        ExperimentSpec(name=f"{model}_dense", reducer=None, **base),
        ExperimentSpec(
            name=f"{model}_fft_theta0.7", theta=0.7,
            schedule={"kind": "constant", "theta": 0.7}, **base),
        ExperimentSpec(
            name=f"{model}_fft_theta0.9", theta=0.9,
            schedule={"kind": "constant", "theta": 0.9}, **base),
        ExperimentSpec(
            name=f"{model}_fft_mixed", theta=0.99,
            schedule={"kind": "step_decay", "points": mixed_points}, **base),
    ]
    for transport in ("sequenced", "psum"):
        specs.append(ExperimentSpec(
            name=f"{model}_fft_theta0.7_{transport}", theta=0.7, transport=transport,
            schedule={"kind": "constant", "theta": 0.7}, **base))
    # topology sweep axis (DESIGN.md §18): the theta0.7 config on a
    # (nodes, local) two-level mesh.  hierarchical re-compresses once per
    # island (a SECOND lossy step — island-shared, so still deterministic);
    # reduce_scatter shards the psum over the bucket axis.  The evaluator's
    # hierarchical_matches_flat claim requires both final losses within the
    # flat-psum row's 5% envelope.
    two_level_nodes = max(workers // 2, 1)
    for transport in ("hierarchical", "reduce_scatter"):
        suffix = "hier" if transport == "hierarchical" else "rs"
        specs.append(ExperimentSpec(
            name=f"{model}_fft_theta0.7_{suffix}", theta=0.7,
            transport=transport, nodes=two_level_nodes,
            schedule={"kind": "constant", "theta": 0.7}, **base))
    # backend sweep axis (engine backends, DESIGN.md §13): same config as the
    # theta0.7 row but stages executed by the hand-written kernels (B1 and
    # B2 in the compress; B3 in the probe's decompress).  The evaluator's
    # backends_identical claim compares this curve against the
    # reference-backend row — compression must be a pure execution-engine
    # choice, never a numerics choice.
    specs.append(ExperimentSpec(
        name=f"{model}_fft_theta0.7_cuda", theta=0.7, backend="cuda",
        schedule={"kind": "constant", "theta": 0.7}, **base))
    # selection-engine sweep axis (DESIGN.md §16): the theta0.7 config with
    # the O(n) sampled-threshold selector replacing the exact sort.  The
    # evaluator's sampled_selector_matches_sort claim requires this curve to
    # track the sort row within the theta<=0.7 loss tolerance — the selector
    # trades exactness of the kept SET (never payload shape) for speed, so
    # convergence, not bitwise equality, is the contract.
    specs.append(ExperimentSpec(
        name=f"{model}_fft_theta0.7_sampled", theta=0.7, selector="sampled",
        schedule={"kind": "constant", "theta": 0.7}, **base))
    # exchange-schedule sweep axis (overlap engine, DESIGN.md §15): the same
    # bucketed config dispatched stacked (one collective after backprop) vs
    # streamed (readiness-ordered groups interleaved with backprop).  The
    # evaluator's streamed_identical claim requires the two curves BITWISE
    # equal — the schedule is a dispatch-shape choice, never a numerics one.
    for exchange_schedule in ("stacked", "streamed"):
        specs.append(ExperimentSpec(
            name=f"{model}_fft_theta0.7_bucketed_{exchange_schedule}",
            theta=0.7, transport="sequenced", bucket_bytes=4096 * 4,
            exchange_schedule=exchange_schedule,
            schedule={"kind": "constant", "theta": 0.7}, **base))
    return specs


def _chaos_rows(model: str, *, workers: int, steps: int, seed: int = 0) -> List[ExperimentSpec]:
    """The chaos lane (DESIGN.md §19): three fault rows per model, each
    proving one resilience claim against the model's clean theta0.7 row.

    * ``{model}_chaos_nan`` — two workers emit all-NaN gradients at two
      steps; the non-finite guard must skip EXACTLY those steps (bitwise
      clean before the first fault, 5% loss envelope at the end).
    * ``{model}_chaos_crash`` — a fatal crash mid-run with checkpointing;
      the harness restarts ``train_loop`` (auto-resume) and the deduped
      trajectory must be BITWISE identical to the uninterrupted clean row.
    * ``{model}_chaos_corrupt`` — persistent payload corruption on a
      bucketed exchange with ``validate=cheap``; the guard skips every
      corrupted step until the loop walks the degradation ladder, and the
      run still completes.
    """
    base = dict(model=model, workers=workers, steps=steps, seed=seed)
    if model == "convnet":
        base.update(opt="sgd", lr=0.1)
    sched = {"kind": "constant", "theta": 0.7}
    # probes record reconstruction stats, not trajectory — chaos rows skip
    # them (the bitwise claims compare losses, and the probe would fire on
    # skipped steps' params too)
    chaos = dict(theta=0.7, schedule=sched, probe_every=0)
    nan_steps = (steps // 4, steps // 2)
    # a run of corrupted steps long enough to exhaust the loop's skip
    # patience (max_retries=2 -> degrade after 3 consecutive skips)
    corrupt_lo = steps // 3
    corrupt_steps = range(corrupt_lo, corrupt_lo + 6)
    return [
        ExperimentSpec(
            name=f"{model}_chaos_nan",
            faults=[{"kind": "nan_grad", "step": nan_steps[0], "worker": 1},
                    {"kind": "nan_grad", "step": nan_steps[1],
                     "worker": workers - 1}],
            **chaos, **base),
        ExperimentSpec(
            name=f"{model}_chaos_crash", ckpt_every=10,
            faults=[{"kind": "step_crash", "step": (steps * 2) // 3,
                     "fatal": True}],
            **chaos, **base),
        ExperimentSpec(
            name=f"{model}_chaos_corrupt", transport="sequenced",
            bucket_bytes=4096 * 4, validate="cheap",
            faults=[{"kind": "payload_corrupt", "step": s, "worker": 1,
                     "plane": "idx"} for s in corrupt_steps],
            **chaos, **base),
    ]


def chaos_matrix(workers: int = 8) -> List[ExperimentSpec]:
    """The chaos lane plus the clean rows its claims compare against."""
    specs: List[ExperimentSpec] = []
    for model in ("lm", "convnet"):
        base = dict(model=model, workers=workers, steps=50)
        if model == "convnet":
            base.update(opt="sgd", lr=0.1)
        specs.append(ExperimentSpec(
            name=f"{model}_fft_theta0.7", theta=0.7,
            schedule={"kind": "constant", "theta": 0.7}, **base))
        specs += _chaos_rows(model, workers=workers, steps=50)
    return specs


def smoke_matrix(workers: int = 8) -> List[ExperimentSpec]:
    """The smoke matrix: tiny transformer + convnet, ``workers`` workers."""
    return (_matrix("lm", workers=workers, steps=50)
            + _matrix("convnet", workers=workers, steps=50))


def full_matrix(workers: int = 8) -> List[ExperimentSpec]:
    """The manual sweep: smoke + compressor baselines + extra schedules."""
    specs = smoke_matrix(workers)
    for model, steps in (("lm", 50), ("convnet", 50)):
        base = dict(model=model, workers=workers, steps=steps)
        if model == "convnet":
            base.update(opt="sgd", lr=0.1)
        specs += [
            ExperimentSpec(name=f"{model}_timedomain_theta0.7", reducer="timedomain",
                           theta=0.7, schedule={"kind": "constant", "theta": 0.7}, **base),
            ExperimentSpec(name=f"{model}_terngrad", reducer="terngrad", **base),
            ExperimentSpec(name=f"{model}_qsgd", reducer="qsgd", **base),
            ExperimentSpec(name=f"{model}_fft_thm35", theta=0.5,
                           schedule={"kind": "thm35", "lipschitz": 1.0, "eta": 0.3}, **base),
            ExperimentSpec(name=f"{model}_fft_theta0.7_bucketed_ef", theta=0.7,
                           bucket_bytes=4096 * 4, transport="sequenced",
                           error_feedback=True,
                           schedule={"kind": "constant", "theta": 0.7}, **base),
            # per-bucket loop vs batched executor: trajectories must be
            # bitwise-identical (the stacked executor is a pure launch-count
            # optimization, DESIGN.md §14)
            ExperimentSpec(name=f"{model}_fft_theta0.7_bucketed_looped",
                           theta=0.7, bucket_bytes=4096 * 4,
                           transport="sequenced", stacked=False,
                           schedule={"kind": "constant", "theta": 0.7}, **base),
            # auto policy row (DESIGN.md §15): the cost model picks the
            # dispatch schedule; whatever it picks, the trajectory equals the
            # smoke matrix's stacked/streamed bucketed rows
            ExperimentSpec(name=f"{model}_fft_theta0.7_bucketed_auto",
                           theta=0.7, bucket_bytes=4096 * 4,
                           transport="sequenced", exchange_schedule="auto",
                           schedule={"kind": "constant", "theta": 0.7}, **base),
        ]
    # chaos lane (DESIGN.md §19): the fault rows ride the full sweep too,
    # so the lab's artifact carries the resilience evidence alongside
    # the accuracy claims (their clean comparators are the smoke rows above)
    for model in ("lm", "convnet"):
        specs += _chaos_rows(model, workers=workers, steps=50)
    # worker-count scaling point (claims are worker-count independent);
    # derived from the requested count so e.g. --workers 2 never demands
    # more devices than the CLI pinned
    alt = max(workers // 2, 1)
    if alt != workers:
        specs.append(ExperimentSpec(
            name=f"lm_fft_theta0.7_w{alt}", model="lm", workers=alt, steps=50,
            theta=0.7, schedule={"kind": "constant", "theta": 0.7}))
    return specs


def group_by_model(specs: List[ExperimentSpec]) -> Dict[str, List[ExperimentSpec]]:
    out: Dict[str, List[ExperimentSpec]] = {}
    for s in specs:
        out.setdefault(s.model, []).append(s)
    return out
