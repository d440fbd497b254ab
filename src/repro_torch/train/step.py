"""The train step (port of ``repro.train.step``'s ``pjit`` and
``compressed_dp`` modes).

Workers are the ranks of a ``torch.distributed`` process group when one is
initialized (each computes its own batch shard's gradient), else the single
process.

* ``pjit`` -- the dense baseline: loss and gradient (autograd), the mean
  gradient over the workers (one SUM all_reduce divided by the world size,
  what XLA inserts for ``pjit`` over ``data``; nothing with one worker),
  global-norm clipping and the optimizer.  No reducer, no guard and no
  ``skipped`` metric, as in the reference.  FSDP is not ported: there is
  one card.
* ``compressed_dp`` -- the paper's setting: the exchange of the gradient
  through the reducer (with error feedback, the residual update), the
  non-finite guard, clipping and the optimizer.

The guard: every worker checks that its local gradient, the reduced mean
and the new residual are finite, and one MIN all_reduce makes the verdict
the same everywhere; a failed step commits nothing but the step counter --
parameters, moments and the residual stay as they were.  The reference
selects between the new and the old state after computing both; the port
decides first and then updates in place, which is the same result without a
second copy of the state.  In both modes the loss and the model's metrics
are averaged over the workers.

Because the update is in place, everything that can raise -- the backward
pass, the exchange and its kernels, the guard's collective -- runs before
``apply_updates`` touches a parameter: a step that raises leaves the state
as it found it, so the loop's retry in place starts from a clean state.

``compressed_dp`` also carries the reference's schedule policy and fault
hooks.  ``schedule='auto'`` is resolved once, when the step is built
(``scheduler.resolve_schedule`` with the model's parameter count, the
batch's tokens, the group's size and, when ``StepConfig.calibration_path``
names one, the measured ``calibrate.CostProfile``), and the step exposes
the decision as ``.schedule_decision`` (None unless ``auto`` ran) and the
config it runs as ``.reducer_config``.  A ``NanGrad`` event of the
reducer's ``FaultPlan`` poisons this worker's whole gradient at its
(step, rank); a resilient reducer's payload verdict joins the guard's flag
before the MIN all_reduce, so a corrupted payload anywhere skips the step
everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.comms import faults as faults_mod
from repro_torch.comms import scheduler
from repro_torch.comms.reducers import ReducerConfig, dense_mean, make_reducer
from repro_torch.dist_util import rank_and_world, world_size
from repro_torch.optim import OptConfig, apply_updates, clip_by_global_norm

__all__ = ["StepConfig", "build_train_step"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    mode: str = "compressed_dp"
    clip_norm: float = 1.0
    reducer: Optional[ReducerConfig] = None
    # a persisted calibrate.CostProfile measured on this platform, card,
    # group size, model and torch; schedule='auto' then prices with it (a
    # key mismatch raises calibrate.ProfileKeyMismatch when the step is built)
    calibration_path: Optional[str] = None
    guard: bool = True


def _all_finite(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    ok = torch.ones((), dtype=torch.bool, device=next(iter(tree.values())).device)
    for t in tree.values():
        ok = ok & torch.isfinite(t).all()
    return ok


def _loss_and_grads(model, params, batch):
    """(loss, metrics, grads) of this worker's batch; the parameters' .grad
    is left empty."""
    for p in params.values():
        p.grad = None
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {name: p.grad for name, p in params.items()}
    for p in params.values():
        p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return metrics, grads


def _worker_mean_metrics(metrics, group, world: int):
    """Each metric averaged over the workers (a SUM all_reduce / P)."""
    if world == 1:
        return metrics
    out = {}
    for k, v in metrics.items():
        v = v.detach().clone()
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
        out[k] = v / world
    return out


def build_train_step(model, opt_cfg: OptConfig, step_cfg: StepConfig, *, group=None,
                     batch_tokens: Optional[int] = None) -> Callable:
    """Returns ``step(state, batch, lr_scale=1.0) -> metrics`` (host floats),
    which updates ``state`` in place.  ``batch_tokens`` (the global batch's
    tokens a step) prices ``schedule='auto'``."""
    if step_cfg.mode == "pjit":
        return _pjit_step(model, opt_cfg, step_cfg, group)
    if step_cfg.mode != "compressed_dp":
        raise NotImplementedError(
            f"mode {step_cfg.mode!r} is not ported yet (ported: 'pjit', 'compressed_dp'); "
            "see ROADMAP.md")
    if step_cfg.reducer is None:
        raise ValueError("compressed_dp needs a ReducerConfig")
    rank, world = rank_and_world(group)
    reducer_cfg = step_cfg.reducer
    profile = None
    if step_cfg.calibration_path is not None:
        from repro_torch.comms import calibrate

        profile = calibrate.load_profile_for(step_cfg.calibration_path, model=model,
                                             group=group)
    decision = None
    if reducer_cfg.schedule == "auto":
        n_params = sum(p.numel() for p in model.leaves().values())
        resolved, decision = scheduler.resolve_schedule(
            reducer_cfg, n_params, batch_tokens, workers=world, profile=profile)
        reducer_cfg = dataclasses.replace(reducer_cfg, schedule=resolved)
    reducer = make_reducer(reducer_cfg, group=group)
    ef = reducer_cfg.error_feedback
    resilient = reducer_cfg.resilient
    nan_events = reducer_cfg.faults.nan_events if reducer_cfg.faults is not None else ()

    def step(state, batch, lr_scale: float = 1.0) -> Dict[str, float]:
        params = model.leaves()
        step_no = state["step"]
        metrics, grads = _loss_and_grads(model, params, batch)
        with torch.no_grad():
            if nan_events and faults_mod.match_events(nan_events, step_no, rank):
                grads = {k: torch.full_like(g, float("nan")) for k, g in grads.items()}
            extra = {"step": step_no} if resilient else {}
            if ef:
                res = reducer(grads, state["residual"], **extra)
            else:
                res = reducer(grads, **extra)
                res = (res[0], None, res[1]) if resilient else (res, None)
            reduced, new_residual = res[0], res[1]
            pay_ok = res[2] if resilient else True
            del res
            ok = torch.ones((), dtype=torch.bool, device=metrics["loss"].device)
            if step_cfg.guard:
                ok = _all_finite(grads) & _all_finite(reduced) & pay_ok
                if ef:
                    ok = ok & torch.isfinite(new_residual).all()
            del grads
            if world > 1:
                flags = ok.to(torch.int32)
                dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=group)
                ok = flags > 0
            metrics = _worker_mean_metrics(metrics, group, world)
            clipped, gnorm = clip_by_global_norm(reduced, step_cfg.clip_norm)
            del reduced
            keep = bool(ok)
            # nothing above touched the state: a raise leaves it as it was
            if keep:
                apply_updates(opt_cfg, params, clipped, state["opt"], lr_scale)
                if ef:
                    state["residual"] = new_residual
            state["step"] += 1
        out = {k: float(v) for k, v in metrics.items()}
        out.update(grad_norm=float(gnorm), skipped=0.0 if keep else 1.0)
        return out

    step.reducer_config = reducer_cfg
    step.schedule_decision = decision
    return step


def _pjit_step(model, opt_cfg: OptConfig, step_cfg: StepConfig, group) -> Callable:
    """The dense baseline: mean gradient, clip, optimizer."""
    world = world_size(group)

    def step(state, batch, lr_scale: float = 1.0) -> Dict[str, float]:
        params = model.leaves()
        metrics, grads = _loss_and_grads(model, params, batch)
        with torch.no_grad():
            grads = dense_mean(grads, group)
            metrics = _worker_mean_metrics(metrics, group, world)
            clipped, gnorm = clip_by_global_norm(grads, step_cfg.clip_norm)
            del grads
            apply_updates(opt_cfg, params, clipped, state["opt"], lr_scale)
            state["step"] += 1
        out = {k: float(v) for k, v in metrics.items()}
        out.update(grad_norm=float(gnorm))
        return out

    return step
