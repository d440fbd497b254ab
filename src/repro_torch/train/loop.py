"""The plain training loop (port of ``repro.train.loop.train_loop`` without
checkpointing, fault injection, publishing or the degradation ladder, which
are not ported yet).

Each step takes the stream's batch (this worker's rows of it when a process
group is initialized).  With ``TrainLoopConfig.theta_schedule`` each step's
theta is snapped through ``core.schedules.quantize_theta`` and the step
runs the reducer at that theta, with one step function built per distinct
quantized theta (the kept-k is a property of the step, as the reference
recompiles per theta); the model, the optimizer state and the EF residual
live in ``state`` and carry across a theta change.  Every history row
records its ``theta`` (``None`` without a schedule).

``TrainLoopConfig.lr_schedule`` is accepted and ignored: the reference loop
computes the schedule but its step takes no LR multiplier, so the reference
CLI trains at the base LR (ROADMAP, known faults of the reference), and the
port keeps its trajectory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.schedules import quantize_theta
from repro_torch.dist_util import rank_and_world
from repro_torch.train.step import StepConfig, build_train_step

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    theta_schedule: Optional[Callable[[int], float]] = None
    lr_schedule: Optional[Callable[[int], float]] = None  # accepted, ignored


def train_loop(model, opt_cfg, step_cfg: StepConfig, state, stream,
               loop_cfg: TrainLoopConfig, *, group=None) -> Dict:
    """Runs the loop; returns ``{"state": ..., "history": [...]}``; every
    history row carries the step's theta and its wall time ``dt``
    (synchronized)."""
    step_fns: Dict[float, Callable] = {}

    def get_step_fn(theta: Optional[float]) -> Callable:
        key = -1.0 if theta is None else theta
        if key not in step_fns:
            cfg = step_cfg
            if theta is not None and step_cfg.reducer is not None:
                cfg = dataclasses.replace(
                    step_cfg, reducer=dataclasses.replace(step_cfg.reducer, theta=theta))
            step_fns[key] = build_train_step(model, opt_cfg, cfg, group=group)
        return step_fns[key]

    rank, world = rank_and_world(group)
    device = next(model.parameters()).device
    history: List[Dict] = []
    for step in range(state["step"], loop_cfg.total_steps):
        theta = None
        if loop_cfg.theta_schedule is not None:
            theta = quantize_theta(loop_cfg.theta_schedule(step))
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
        metrics.update(step=step, theta=theta, dt=time.perf_counter() - t0)
        if step % loop_cfg.log_every == 0:
            history.append(metrics)
    return {"state": state, "history": history}
