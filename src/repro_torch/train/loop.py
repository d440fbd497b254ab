"""The plain training loop (port of ``repro.train.loop.train_loop`` without
checkpointing, fault injection, publishing or the degradation ladder, which
are not ported yet).

Each step takes the stream's batch (this worker's rows of it when a process
group is initialized) and trains at the optimizer's base LR.
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
import torch.distributed as dist

from repro_torch.train.step import StepConfig, build_train_step

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    lr_schedule: Optional[Callable[[int], float]] = None  # accepted, ignored


def train_loop(model, opt_cfg, step_cfg: StepConfig, state, stream,
               loop_cfg: TrainLoopConfig, *, group=None) -> Dict:
    """Runs the loop; returns ``{"state": ..., "history": [...]}``; every
    history row carries the step's wall time ``dt`` (synchronized)."""
    step_fn = build_train_step(model, opt_cfg, step_cfg, group=group)
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    device = next(model.parameters()).device
    history: List[Dict] = []
    for step in range(state["step"], loop_cfg.total_steps):
        batch = stream.batch_at(step, host_index=rank, num_hosts=world)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        # one profiler range per step, so a trace splits device time by step
        with torch.profiler.record_function("train_step"):
            metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        metrics.update(step=step, dt=time.perf_counter() - t0)
        if step % loop_cfg.log_every == 0:
            history.append(metrics)
    return {"state": state, "history": history}
