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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.comms.reducers import ReducerConfig, dense_mean, make_reducer
from repro_torch.dist_util import world_size
from repro_torch.optim import OptConfig, apply_updates, clip_by_global_norm

__all__ = ["StepConfig", "build_train_step"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    mode: str = "compressed_dp"
    clip_norm: float = 1.0
    reducer: Optional[ReducerConfig] = None
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


def build_train_step(model, opt_cfg: OptConfig, step_cfg: StepConfig, *,
                     group=None) -> Callable:
    """Returns ``step(state, batch, lr_scale=1.0) -> metrics`` (host floats),
    which updates ``state`` in place."""
    if step_cfg.mode == "pjit":
        return _pjit_step(model, opt_cfg, step_cfg, group)
    if step_cfg.mode != "compressed_dp":
        raise NotImplementedError(
            f"mode {step_cfg.mode!r} is not ported yet (ported: 'pjit', 'compressed_dp'); "
            "see ROADMAP.md")
    if step_cfg.reducer is None:
        raise ValueError("compressed_dp needs a ReducerConfig")
    reducer = make_reducer(step_cfg.reducer, group=group)
    ef = step_cfg.reducer.error_feedback
    world = world_size(group)

    def step(state, batch, lr_scale: float = 1.0) -> Dict[str, float]:
        params = model.leaves()
        metrics, grads = _loss_and_grads(model, params, batch)
        with torch.no_grad():
            if ef:
                reduced, new_residual = reducer(grads, state["residual"])
            else:
                reduced, new_residual = reducer(grads), None
            ok = torch.ones((), dtype=torch.bool, device=metrics["loss"].device)
            if step_cfg.guard:
                ok = _all_finite(grads) & _all_finite(reduced)
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
            if keep:
                apply_updates(opt_cfg, params, clipped, state["opt"], lr_scale)
                if ef:
                    state["residual"] = new_residual
            state["step"] += 1
        out = {k: float(v) for k, v in metrics.items()}
        out.update(grad_norm=float(gnorm), skipped=0.0 if keep else 1.0)
        return out

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
