"""The train step (port of ``repro.train.step``: the ``pjit``,
``compressed_dp`` and ``hierarchical`` modes, ``state_pspecs`` and
``batch_pspecs``).

Workers are the ranks of a ``torch.distributed`` process group when one is
initialized (each computes the gradient of its own rows), else the single
process.  ``group=`` is a group or a ``launch.mesh.Mesh``.  Over a mesh the
batch axes (:func:`mesh_batch_axes`: ``StepConfig.data_axes``, the
two-level pair on a two-level mesh, else ``("data",)`` or, with
``multi_pod``, ``("pod", "data")``) say whose rows differ: ranks that
differ only in ``model`` hold the same rows and count as one worker, so the
gradient mean and the metrics' mean run over the batch axes' group; the
guard's MIN runs over the ``flat`` group.

* ``pjit`` -- the dense baseline: loss and gradient (autograd), the mean
  gradient over the workers (SUM all_reduce divided by their count, what
  XLA inserts for ``pjit`` over ``data``; nothing with one worker),
  global-norm clipping and the optimizer.  No reducer, no guard and no
  ``skipped`` metric, as in the reference.  On a mesh with a ``model``
  axis, or with ``StepConfig.fsdp``, the state is SHARDED as
  :func:`state_pspecs` places it (``train.init_state(..., mesh=,
  step_cfg=)``): every parameter and both AdamW moments are ``DTensor``
  leaves on the mesh's ``DeviceMesh`` (tensor parallelism over ``model``,
  FSDP over ``data``).  A step gathers each leaf over ``data`` at use (to
  its model-local block), runs the model with the model axis's explicit
  collectives (``models/tensor_parallel.py``: every layer kind, each block
  split along its role's axis or computed whole; between groups the stream
  is sequence-parallel over ``model`` where that axis divides the sequence,
  the reference's activation sharding, so under ``remat`` each rank stores
  its ``1/model`` shard of every group's input), redistributes each gradient
  from partial sums over the batch axes to its leaf's placement (a
  reduce-scatter over ``data`` for an FSDP leaf, an all_reduce otherwise),
  clips by the global norm summed over shards -- each leaf counted once,
  however many ranks replicate it -- and runs AdamW on the local shards.
* ``compressed_dp`` -- the paper's setting: the exchange of the gradient
  through the reducer (with error feedback, the residual update), the
  non-finite guard, clipping and the optimizer.  Parameters replicated.
* ``hierarchical`` -- over a mesh with a ``pod`` axis: each rank computes
  the gradient of its ``(pod, data)`` rows, the reducer's ``hierarchical``
  kind averages it densely over the pod's ``data`` group (what the
  reference's auto-partitioned ``data`` axis computes) and exchanges the
  pod mean through the compressed transport over the ``pod`` group: the
  reference's spelling ``ReducerConfig(axis=None, pod_axis="pod")``.
  Parameters stay replicated, as the reference's do in the compressed
  modes, and the ranks that differ only in ``model`` each compute their
  rows whole, with no plan (the reference's ``inner_ctx`` lets XLA spread
  that work over ``model``: a difference in speed, not in value); with
  error feedback the residual is one row per pod, which every rank of the
  pod holds.

The guard: every worker checks that its local gradient, the reduced mean
and the new residual are finite, and one MIN all_reduce makes the verdict
the same everywhere; a failed step commits nothing but the step counter --
parameters, moments and the residual stay as they were.  The reference
selects between the new and the old state after computing both; the port
decides first and then updates in place, which is the same result without a
second copy of the state.

Because the update is in place, everything that can raise -- the backward
pass, the exchange and its kernels, the guard's collective -- runs before
``apply_updates`` touches a parameter: a step that raises leaves the state
as it found it, so the loop's retry in place starts from a clean state.

The compressed modes also carry the reference's transport and schedule
policies and fault hooks.  ``transport='auto'`` and ``schedule='auto'`` are
resolved once, when the step is built (``scheduler.resolve_transport`` on
the mesh's ``(nodes, local)`` topology, then ``scheduler.resolve_schedule``
with the model's parameter count, the batch's tokens, the exchange's worker
count and topology and, when ``StepConfig.calibration_path`` names one, the
measured ``calibrate.CostProfile``); the step exposes the decisions as
``.transport_decision`` and ``.schedule_decision`` (None unless that
``auto`` was priced) and the config it runs as ``.reducer_config``.  The
``hierarchical`` kind exchanges over the mesh's ``node`` group (or its
``pod`` group), so it is priced on ``nodes`` (``pods``) workers and no
topology.  A ``NanGrad`` event of the reducer's ``FaultPlan`` poisons this
worker's whole gradient at its (step, worker), the worker in the plan's
coordinate (``reducers.fault_worker``: the rank, but for the
``hierarchical`` kind); a resilient reducer's payload verdict joins the
guard's flag before the MIN all_reduce, so a corrupted payload anywhere
skips the step everywhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.comms import faults as faults_mod
from repro_torch.comms import scheduler
from repro_torch.comms.reducers import ReducerConfig, dense_mean, fault_worker, make_reducer
from repro_torch.dist_util import world_size
from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding import (TWO_LEVEL_DATA_AXES, placements,
                                         spec_tree_to_pspecs)
from repro_torch.models.tensor_parallel import plan
from repro_torch.optim import OptConfig, apply_updates, clip_by_global_norm
from repro_torch.optim.clipping import clip_to_norm

__all__ = ["StepConfig", "build_train_step", "state_pspecs", "batch_pspecs",
           "mesh_batch_axes", "residual_axes", "sharded_state", "MODES"]

MODES = ("pjit", "compressed_dp", "hierarchical")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    mode: str = "pjit"  # pjit | compressed_dp | hierarchical
    # pjit: parameters also sharded over 'data' (ZeRO-3); never in
    # compressed_dp
    fsdp: bool = False
    # the batch over ("pod", "data"); a mesh with a pod axis needs it
    multi_pod: bool = False
    clip_norm: float = 1.0
    reducer: Optional[ReducerConfig] = None
    # the batch axes, overriding ("data",) / ("pod", "data") (a two-level
    # mesh's ("node", "local") is found without it)
    data_axes: Optional[Tuple[str, ...]] = None
    # a persisted calibrate.CostProfile measured on this platform, card,
    # group size, model and torch; schedule='auto' then prices with it (a
    # key mismatch raises calibrate.ProfileKeyMismatch when the step is built)
    calibration_path: Optional[str] = None
    guard: bool = True

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one of {MODES}")

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        if self.data_axes is not None:
            return tuple(self.data_axes)
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def manual_axes(self) -> Tuple[str, ...]:
        if self.mode == "compressed_dp":
            return self.batch_axes
        if self.mode == "hierarchical":
            return ("pod",)
        return ()


def _batch_axes(step_cfg: StepConfig, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    if step_cfg.data_axes is None and all(a in sizes for a in TWO_LEVEL_DATA_AXES):
        axes = TWO_LEVEL_DATA_AXES
    else:
        axes = step_cfg.batch_axes
    missing = [a for a in axes if a not in sizes]
    if missing:
        raise ValueError(f"the batch axes {axes} name {missing}, which the mesh's axes "
                         f"{tuple(sizes)} do not have")
    if "pod" in sizes and "pod" not in axes:
        raise ValueError(f"the mesh {tuple(sizes)} has a 'pod' axis: the batch shards over "
                         "it, so give StepConfig(multi_pod=True)")
    return axes


def mesh_batch_axes(step_cfg: StepConfig, mesh: Mesh) -> Tuple[str, ...]:
    """The axes the batch shards over on ``mesh``: ``StepConfig.data_axes``,
    else the two-level pair on a two-level mesh, else ``("data",)`` (with
    ``multi_pod``, ``("pod", "data")``); each must be a mesh axis."""
    return _batch_axes(step_cfg, mesh.shape)


def residual_axes(step_cfg: StepConfig, mesh: Mesh) -> Tuple[str, ...]:
    """The axes of the EF residual's rows (the reference's manual axes):
    the batch axes in ``compressed_dp``, ``("pod",)`` in ``hierarchical``."""
    if step_cfg.mode == "hierarchical":
        return ("pod",)
    return mesh_batch_axes(step_cfg, mesh) if step_cfg.mode == "compressed_dp" else ()


def sharded_state(step_cfg: StepConfig, mesh) -> bool:
    """Whether the state lives sharded on the mesh: ``pjit`` over a mesh
    with a ``model`` axis, or with ``fsdp``."""
    return (step_cfg.mode == "pjit" and isinstance(mesh, Mesh)
            and ("model" in mesh.shape or step_cfg.fsdp))


def state_pspecs(model, opt_cfg: OptConfig, step_cfg: StepConfig, mesh) -> Dict:
    """The state's specs on this mesh (a ``Mesh`` or its axis sizes): one
    mesh-axis name or None per dimension.  In ``pjit`` the parameters and
    moments follow the rules (``model``; with ``fsdp`` also ``data``;
    never ``pod``); the compressed modes replicate them, as the reference's
    steps do; the EF residual has one row per :func:`residual_axes`
    worker."""
    sizes = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    specs = model.spec()
    if step_cfg.mode == "pjit":
        params = spec_tree_to_pspecs(specs, sizes, fsdp=step_cfg.fsdp)
    else:
        params = {k: (None,) * len(s.shape) for k, s in specs.items()}
    out = {"params": params, "opt": {"mu": params, "count": ()}, "step": ()}
    if opt_cfg.kind == "adamw":
        out["opt"]["nu"] = params
    if (step_cfg.mode != "pjit" and step_cfg.reducer is not None
            and step_cfg.reducer.error_feedback):
        rows = ("pod",) if step_cfg.mode == "hierarchical" else _batch_axes(step_cfg, sizes)
        out["residual"] = (rows, None)
    return out


def batch_pspecs(step_cfg: StepConfig, batch_tree) -> Dict:
    """Every input's rows over the batch axes."""
    return {k: (step_cfg.batch_axes,) for k in batch_tree}


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
    with tracing.span("step.forward"):
        loss, metrics = model.loss(batch)
    with tracing.span("step.backward"):
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


def _exchange_shape(reducer_cfg: ReducerConfig, group, world: int):
    """(workers, topology) the exchange is priced on: the ``hierarchical``
    kind's exchange runs over the mesh's ``pod`` or ``node`` group; every
    other over all the workers, on a two-level mesh's ``(nodes, local)``."""
    if not isinstance(group, Mesh):
        return world, None
    if "pod" in group.shape:
        return group.shape["pod"], None
    if reducer_cfg.kind == "hierarchical":
        return group.sizes[0], None
    return world, group.topology


def build_train_step(model, opt_cfg: OptConfig, step_cfg: StepConfig, *, group=None,
                     batch_tokens: Optional[int] = None) -> Callable:
    """Returns ``step(state, batch, lr_scale=1.0) -> metrics`` (host floats),
    which updates ``state`` in place; ``step.body`` is its device work, the
    metrics left as tensors (:func:`_with_epilogue`).  ``batch_tokens`` (the
    global batch's tokens a step) prices ``schedule='auto'``; ``group`` is a
    group or a ``launch.mesh.Mesh``."""
    if step_cfg.mode == "pjit":
        if sharded_state(step_cfg, group):
            return _sharded_pjit_step(model, opt_cfg, step_cfg, group)
        return _pjit_step(model, opt_cfg, step_cfg, group)
    if step_cfg.reducer is None:
        raise ValueError(f"{step_cfg.mode} needs a ReducerConfig")
    if step_cfg.mode == "hierarchical":
        if not (isinstance(group, Mesh) and "pod" in group.shape):
            axes = group.axis_names if isinstance(group, Mesh) else ("data",)
            raise ValueError(f"mode 'hierarchical' exchanges over a 'pod' axis, which the mesh "
                             f"{axes} does not have: give a mesh with one "
                             "(launch.mesh.make_production_mesh(multi_pod=True), or "
                             "make_local_mesh(shape, ('pod', 'data', 'model')))")
        if step_cfg.reducer.kind not in ("hierarchical", "dense"):
            raise ValueError(f"mode 'hierarchical' exchanges through the 'hierarchical' reducer "
                             f"kind, not {step_cfg.reducer.kind!r}")
    flat_group, world, batch_group, n_batch = _groups(step_cfg, group)
    if isinstance(group, Mesh) and step_cfg.mode == "compressed_dp" and n_batch != world:
        # ranks that differ only in a non-batch axis hold the same rows: the
        # exchange runs over the batch axes' group
        group = batch_group
    reducer_cfg = step_cfg.reducer
    profile = None
    if step_cfg.calibration_path is not None:
        from repro_torch.comms import calibrate

        profile = calibrate.load_profile_for(step_cfg.calibration_path, model=model,
                                             group=group)
    workers, topology = _exchange_shape(reducer_cfg, group, n_batch)
    n_params = sum(p.numel() for p in model.leaves().values())
    transport_decision = decision = None
    if reducer_cfg.transport == "auto":
        resolved, transport_decision = scheduler.resolve_transport(
            reducer_cfg, n_params, topology=topology, profile=profile)
        reducer_cfg = dataclasses.replace(reducer_cfg, transport=resolved)
    if reducer_cfg.schedule == "auto":
        resolved, decision = scheduler.resolve_schedule(
            reducer_cfg, n_params, batch_tokens, workers=workers, profile=profile,
            topology=topology)
        reducer_cfg = dataclasses.replace(reducer_cfg, schedule=resolved)
    reducer = make_reducer(reducer_cfg, group=group)
    worker = fault_worker(reducer_cfg, group)
    ef = reducer_cfg.error_feedback
    resilient = reducer_cfg.resilient
    nan_events = reducer_cfg.faults.nan_events if reducer_cfg.faults is not None else ()

    def body(state, batch, lr_scale: float = 1.0, commit: Optional[bool] = None):
        params = model.leaves()
        step_no = state["step"]
        metrics, grads = _loss_and_grads(model, params, batch)
        with torch.no_grad():
            if nan_events and faults_mod.match_events(nan_events, step_no, worker):
                grads = {k: torch.full_like(g, float("nan")) for k, g in grads.items()}
            extra = {"step": step_no} if resilient else {}
            with tracing.span("step.exchange"):
                if ef:
                    res = reducer(grads, state["residual"], **extra)
                else:
                    res = reducer(grads, **extra)
                    res = (res[0], None, res[1]) if resilient else (res, None)
            reduced, new_residual = res[0], res[1]
            pay_ok = res[2] if resilient else True
            del res
            with tracing.span("step.guard"):
                ok = torch.ones((), dtype=torch.bool, device=metrics["loss"].device)
                if step_cfg.guard:
                    ok = _all_finite(grads) & _all_finite(reduced) & pay_ok
                    if ef:
                        ok = ok & torch.isfinite(new_residual).all()
                del grads
                if world > 1:
                    flags = ok.to(torch.int32)
                    dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=flat_group)
                    ok = flags > 0
            metrics = _worker_mean_metrics(metrics, batch_group, n_batch)
            clipped, gnorm = clip_by_global_norm(reduced, step_cfg.clip_norm)
            del reduced
            if commit is None:
                with tracing.span("step.guard"):
                    tracing.count("host_syncs")
                    keep = bool(ok)
            else:
                keep = commit
            # nothing above touched the state: a raise leaves it as it was
            if keep:
                apply_updates(opt_cfg, params, clipped, state["opt"], lr_scale)
                if ef:
                    state["residual"] = new_residual
            state["step"] += 1
        return dict(metrics, grad_norm=gnorm, skipped=0.0 if keep else 1.0)

    step = _with_epilogue(body)
    step.reducer_config = reducer_cfg
    step.schedule_decision = decision
    step.transport_decision = transport_decision
    return step


def _with_epilogue(body) -> Callable:
    """The step: ``body`` (the device work, metrics left as tensors) then
    its host epilogue, which reads them as floats.  ``step.body`` is the
    device work alone; a compressed step's ``body(..., commit=True)``
    commits without reading its guard's verdict on the host, the branch a
    trace on fake tensors follows (``launch/dryrun.py``)."""
    def step(state, batch, lr_scale: float = 1.0) -> Dict[str, float]:
        out = body(state, batch, lr_scale)
        with tracing.span("step.epilogue"):
            if tracing.enabled():  # each tensor's float() waits for the device
                tracing.count("host_syncs", sum(isinstance(v, torch.Tensor)
                                                for v in out.values()))
            return {k: float(v) for k, v in out.items()}

    step.body = body
    return step


def _groups(step_cfg: StepConfig, group):
    """(flat group, its size, the batch axes' group, its size)."""
    if not isinstance(group, Mesh):
        world = world_size(group)
        return group, world, group, world
    axes = mesh_batch_axes(step_cfg, group)
    return group.flat, group.size, group.group(axes), group.size_of(axes)


def _pjit_step(model, opt_cfg: OptConfig, step_cfg: StepConfig, group) -> Callable:
    """The dense baseline on replicated parameters: mean gradient, clip,
    optimizer."""
    _, _, group, world = _groups(step_cfg, group)

    def body(state, batch, lr_scale: float = 1.0):
        params = model.leaves()
        metrics, grads = _loss_and_grads(model, params, batch)
        with torch.no_grad():
            with tracing.span("step.exchange"):
                grads = dense_mean(grads, group)
            metrics = _worker_mean_metrics(metrics, group, world)
            clipped, gnorm = clip_by_global_norm(grads, step_cfg.clip_norm)
            del grads
            apply_updates(opt_cfg, params, clipped, state["opt"], lr_scale)
            state["step"] += 1
        return dict(metrics, grad_norm=gnorm)

    return _with_epilogue(body)


@contextlib.contextmanager
def _swapped(model, tensors: Mapping[str, torch.Tensor], tp):
    """The model computing with ``tensors`` in place of its parameters (by
    leaf path), under tensor parallelism ``tp``."""
    slots = []
    for path, t in tensors.items():
        parent, _, leaf = path.rpartition(".")
        module = model.get_submodule(parent) if parent else model
        slots.append((module, leaf, module._parameters[leaf]))
        module._parameters[leaf] = t
    model._tp = tp
    try:
        yield
    finally:
        model._tp = None
        for module, leaf, old in slots:
            module._parameters[leaf] = old


def _sharded_pjit_step(model, opt_cfg: OptConfig, step_cfg: StepConfig, mesh: Mesh) -> Callable:
    """The dense baseline on the sharded state (module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if mesh.device_mesh is None:
        raise ValueError("the sharded pjit step keeps its state on the mesh's DeviceMesh: "
                         "initialize a process group before building the mesh")
    dm = mesh.device_mesh
    axes = mesh.axis_names
    batch_axes = mesh_batch_axes(step_cfg, mesh)
    _, world, batch_group, n_batch = _groups(step_cfg, mesh)
    pspecs = state_pspecs(model, opt_cfg, step_cfg, mesh)["params"]
    names = list(model.leaves())
    leaf_pl = {k: placements(pspecs[k], axes) for k in names}
    for k, p in model.leaves().items():
        if not isinstance(p, DTensor) or tuple(p.placements) != leaf_pl[k]:
            raise ValueError(f"leaf {k} is not placed as state_pspecs places it "
                             f"({pspecs[k]}): build the state with train.init_state(model, "
                             "opt_cfg, mesh=mesh, step_cfg=step_cfg)")
    # at use: gathered over every axis but model; the gradient: partial sums
    # over the batch axes, the leaf's model placement
    use_pl = {k: [pl if a == "model" else Replicate() for a, pl in zip(axes, leaf_pl[k])]
              for k in names}
    grad_pl = {k: [Partial() if a in batch_axes else pl for a, pl in zip(axes, use_pl[k])]
               for k in names}
    # a leaf's squares are counted on the ranks at coordinate 0 of every axis
    # that replicates it: once, whatever its placement
    counted = {k: all(mesh.index(a) == 0 for a, pl in zip(axes, leaf_pl[k])
                      if isinstance(pl, Replicate)) for k in names}
    tp = plan(pspecs, model.spec(), mesh.group("model") if "model" in axes else None,
              mesh.shape.get("model", 1), mesh.index("model") if "model" in axes else 0)

    def body(state, batch, lr_scale: float = 1.0):
        params = model.leaves()
        with torch.no_grad():
            use = {k: params[k].redistribute(dm, use_pl[k]).to_local().detach().requires_grad_()
                   for k in names}
        with _swapped(model, use, tp):
            metrics, grads = _loss_and_grads(model, use, batch)
        del use
        with torch.no_grad():
            red = {}
            with tracing.span("step.exchange"):
                for k in names:
                    g = DTensor.from_local(grads.pop(k), dm, grad_pl[k], run_check=False)
                    g = g.redistribute(dm, leaf_pl[k]).to_local()
                    red[k] = g / n_batch if n_batch > 1 else g
            metrics = _worker_mean_metrics(metrics, batch_group, n_batch)
            with tracing.span("optim.clip"):
                zero = torch.zeros((), dtype=torch.float32, device=metrics["loss"].device)
                sq = torch.stack([torch.sum(torch.square(red[k].float())) if counted[k]
                                  else zero for k in names])
                if world > 1:
                    dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=mesh.flat)
                gnorm = torch.sqrt(sum(sq.unbind()))
            clipped = clip_to_norm(red, gnorm, step_cfg.clip_norm)
            del red
            opt = state["opt"]
            view = {m: {k: t.to_local() for k, t in opt[m].items()}
                    for m in ("mu", "nu") if m in opt}
            view["count"] = opt["count"]
            apply_updates(opt_cfg, {k: params[k].to_local() for k in names}, clipped, view,
                          lr_scale)
            opt["count"] = view["count"]
            state["step"] += 1
        return dict(metrics, grad_norm=gnorm)

    return _with_epilogue(body)
