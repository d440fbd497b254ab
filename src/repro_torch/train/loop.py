"""The training loop (port of ``repro.train.loop``): theta schedules,
checkpoint and auto-resume, fault injection, recovery and the degradation
ladder.

* Auto-resume: with ``ckpt_dir`` the loop first restores the newest
  checkpoint there, if any.
* Typed fault injection: ``TrainLoopConfig.faults`` takes a
  ``comms.faults.FaultPlan``; ``step_crash`` and ``slow_worker`` fire here,
  before the step runs, and each crash fires once per config
  (``fired_faults`` persists across calls, so a resumed run completes);
  ``nan_grad`` and ``payload_corrupt`` ride ``ReducerConfig.faults`` into
  the step.
* Recovery: a step that fails with a recoverable error rolls back to the
  last checkpoint, or retries in place when there is none (a failing step
  commits nothing, ``train/step.py``); after ``max_retries`` failures in a
  row the ladder takes the next rung, and when it has none the original
  error surfaces.
* The degradation ladder: after ``max_retries`` failures, or when the guard
  skips more than ``max_retries`` steps in a row, the loop takes one rung of
  ``reducers.degrade_config`` (``cuda``/``auto`` -> ``reference`` on the
  CPU only, streamed -> stacked, two-level -> ``psum``, compressed ->
  dense, which drops the residual), prints it and records it in the
  returned ``health``.  On the card there is no ``backend`` rung: the loop
  never trades the kernels for their plain versions.
* A kernel that does not build or launch (``kernels.build.KernelError``)
  and a fault of the card itself (``torch.AcceleratorError``) are not
  recoverable: they end the run at once, so no retry or rung hides a broken
  kernel behind the plain versions.

Each step takes the stream's batch (this worker's rows of it when a process
group is initialized).  ``group=`` is a group or a ``launch.mesh.Mesh``: the
step and its rebuilds after a rung get the mesh (a rung down to ``psum``
exchanges over its ``flat`` group); the batch shards, checkpoints and
restores use the ``flat`` group.  With ``theta_schedule`` each step's theta is
snapped through ``core.schedules.quantize_theta``, with one step function
per quantized theta.  ``lr_schedule`` is accepted and ignored: the
reference loop computes it but its step takes no LR multiplier, so the
reference trains at the base LR (ROADMAP, faults of the reference), and the
port keeps its trajectory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set

import torch

from repro_torch.comms import faults as faults_mod
from repro_torch.comms import reducers
from repro_torch.core.schedules import quantize_theta
from repro_torch.dist_util import rank_and_world
from repro_torch.kernels.build import KernelError
from repro_torch.launch.mesh import Mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import StepConfig, build_train_step

__all__ = ["TrainLoopConfig", "train_loop", "RECOVERABLE", "FATAL"]

# errors the rollback and the ladder may absorb, as the reference's
RECOVERABLE = (RuntimeError, FloatingPointError)
# errors that end the run whatever their type's ancestry
FATAL = (KernelError,) + ((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
                          else ())


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    max_retries: int = 2
    theta_schedule: Optional[Callable[[int], float]] = None
    lr_schedule: Optional[Callable[[int], float]] = None  # accepted, ignored
    # step_crash / slow_worker fire here; nan_grad / payload_corrupt belong
    # on ReducerConfig.faults too (they run inside the step)
    faults: Optional[faults_mod.FaultPlan] = None
    # called every committed or skipped step with (step, metrics, state)
    metrics_hook: Optional[Callable[[int, Dict, Dict], None]] = None
    # called every step with (step, state) after metrics_hook (the serving
    # publish path hangs here in the reference)
    publish_hook: Optional[Callable[[int, Dict], None]] = None
    # crash events already fired, persisting across train_loop calls
    fired_faults: Set[int] = dataclasses.field(default_factory=set, repr=False, compare=False)


def _recoverable(e: BaseException) -> bool:
    return isinstance(e, RECOVERABLE) and not isinstance(e, FATAL)


def train_loop(model, opt_cfg, step_cfg: StepConfig, state, stream,
               loop_cfg: TrainLoopConfig, *, group=None) -> Dict:
    """Runs the loop; returns ``{"state", "history", "health",
    "schedule_decision", "transport_decision", "reducer_config"}`` (the
    last three of the first step built: the decisions of ``schedule='auto'``
    and ``transport='auto'``, else None, and the resolved ``ReducerConfig``
    it ran, None in ``pjit`` mode).  Every history row carries the step's
    theta and its wall time ``dt`` (synchronized on the card)."""
    mesh = group
    if isinstance(group, Mesh):
        group = group.flat
    manager = (ckpt.CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.ckpt_every,
                                      loop_cfg.ckpt_keep, group=group)
               if loop_cfg.ckpt_dir else None)
    health = faults_mod.ReducerHealth()
    if manager is not None and ckpt.latest_step(loop_cfg.ckpt_dir) is not None:
        state, start = ckpt.restore(loop_cfg.ckpt_dir, state, group=group)
        print(f"[loop] resumed from step {start}")

    rank, world = rank_and_world(group)
    device = next(model.parameters()).device
    batch_tokens = stream.batch_at(0)["tokens"].numel()
    live_cfg = step_cfg
    step_fns: Dict[float, Callable] = {}
    first: List[Callable] = []  # the first step function built

    def get_step_fn(theta: Optional[float]) -> Callable:
        key = -1.0 if theta is None else theta
        if key not in step_fns:
            cfg = live_cfg
            if theta is not None and live_cfg.reducer is not None:
                cfg = dataclasses.replace(
                    live_cfg, reducer=dataclasses.replace(live_cfg.reducer, theta=theta))
            step_fns[key] = build_train_step(model, opt_cfg, cfg, group=mesh,
                                             batch_tokens=batch_tokens)
            if not first:
                first.append(step_fns[key])
        return step_fns[key]

    def degrade(at_step: int, reason: str) -> bool:
        """One rung down the ladder; False when there is none."""
        nonlocal live_cfg
        if live_cfg.reducer is None:
            return False
        rung = reducers.degrade_config(live_cfg.reducer, device)
        if rung is None:
            return False
        new_reducer, label = rung
        if live_cfg.reducer.error_feedback and not new_reducer.error_feedback:
            # the dense rung drops nothing: no residual to carry or checkpoint
            state.pop("residual", None)
        live_cfg = dataclasses.replace(live_cfg, reducer=new_reducer)
        step_fns.clear()
        health.record_transition(at_step, label, reason)
        print(f"[loop] step {at_step}: degrading exchange -- {label} ({reason})")
        return True

    history: List[Dict] = []
    step = state["step"]
    retries = consecutive_skips = 0
    while step < loop_cfg.total_steps:
        theta = None
        if loop_cfg.theta_schedule is not None:
            theta = quantize_theta(loop_cfg.theta_schedule(step))
        try:
            if loop_cfg.faults is not None:
                for idx, ev in loop_cfg.faults.crashes_at(step):
                    if idx in loop_cfg.fired_faults:
                        continue
                    loop_cfg.fired_faults.add(idx)
                    if ev.fatal:
                        raise faults_mod.FatalInjectedCrash(f"planned fatal crash at step {step}")
                    raise faults_mod.InjectedCrash(f"planned crash at step {step}")
                delay = loop_cfg.faults.delay_at(step)
                if delay > 0:
                    health.record_delay(step)
                    time.sleep(delay)
            step_fn = get_step_fn(theta)
            batch = stream.batch_at(step, host_index=rank, num_hosts=world)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            # one profiler range per step, so a trace splits device time by step
            with torch.profiler.record_function("train_step"):
                metrics = step_fn(state, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if metrics.get("skipped", 0.0):
                health.record_skip(step)
                consecutive_skips += 1
            else:
                consecutive_skips = 0
            if loop_cfg.metrics_hook is not None:
                loop_cfg.metrics_hook(step, dict(metrics, step=step, theta=theta, dt=dt,
                                                 degradations=len(health.transitions)), state)
            if loop_cfg.publish_hook is not None:
                loop_cfg.publish_hook(step, state)
            if step % loop_cfg.log_every == 0:
                history.append(dict(metrics, step=step, theta=theta, dt=dt))
            step += 1
            retries = 0
            if manager is not None:
                manager.maybe_save(step, state)
            # the guard skipping step after step: the exchange itself is
            # producing garbage; skipped steps committed nothing
            if consecutive_skips > loop_cfg.max_retries:
                if degrade(step, f"{consecutive_skips} consecutive skipped steps"):
                    consecutive_skips = 0
        except Exception as e:
            if not _recoverable(e):
                raise
            retries += 1
            if retries > loop_cfg.max_retries:
                if not degrade(step, f"step failure: {e}"):
                    raise
                retries = 0
            if manager is not None and ckpt.latest_step(loop_cfg.ckpt_dir) is not None:
                print(f"[loop] step {step} failed ({e}); rolling back to last checkpoint")
                state, step = ckpt.restore(loop_cfg.ckpt_dir, state, group=group)
            else:
                print(f"[loop] step {step} failed ({e}); no checkpoint yet -- retrying in place")
    if manager is not None:
        ckpt.wait()
    return {"state": state, "history": history, "health": health.to_dict(),
            **{key: getattr(first[0], key, None) if first else None
               for key in ("schedule_decision", "transport_decision", "reducer_config")}}
