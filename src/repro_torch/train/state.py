"""Train state (port of ``repro.train.state``): the model (which holds the
parameters), the optimizer state, the step counter and, with error feedback,
ONE flat f32 residual over the whole gradient (bucket slices are taken
inside the reducer, so the state does not depend on the layout).

On a mesh whose step keeps a sharded state (``train.step.sharded_state``:
``pjit`` with a ``model`` axis or ``fsdp``), :func:`init_state` places it
as ``step.state_pspecs`` says: each parameter becomes a ``DTensor``
parameter on the mesh's ``DeviceMesh`` holding this rank's block, and the
moments are ``DTensor`` zeros of the same placements.  In the compressed
modes the parameters stay replicated and the residual is this rank's row
(its worker's, or in ``hierarchical`` its pod's)."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.comms.reducers import residual_size
from repro_torch.models.sharding import local_slice, placements
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train.step import sharded_state, state_pspecs

__all__ = ["TrainState", "init_state"]

TrainState = Dict[str, Any]  # {"model", "opt", "step"[, "residual"]}


def _place_params(model, mesh, pspecs) -> None:
    """Replace every parameter of ``model`` by a ``DTensor`` parameter on
    ``mesh``'s DeviceMesh holding this rank's block of it under
    ``pspecs[path]`` (a parameter that already is a DTensor is gathered
    first: a collective every rank makes)."""
    from torch.distributed.tensor import DTensor

    if mesh.device_mesh is None:
        raise ValueError("a sharded state lives on the mesh's DeviceMesh: initialize a process "
                         "group before building the mesh")
    coords = dict(zip(mesh.axis_names, mesh.coords))
    with torch.no_grad():
        for path, p in model.leaves().items():
            full = p.full_tensor() if isinstance(p, DTensor) else p.detach()
            spec = pspecs[path]
            block = full[local_slice(spec, full.shape, mesh.shape, coords)].clone()
            t = DTensor.from_local(block, mesh.device_mesh, placements(spec, mesh.axis_names),
                                   run_check=False)
            parent, _, leaf = path.rpartition(".")
            module = model.get_submodule(parent) if parent else model
            module._parameters[leaf] = nn.Parameter(t)


def _zeros_like(p) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        return DTensor.from_local(torch.zeros_like(p.to_local()), p.device_mesh, p.placements,
                                  run_check=False)
    return torch.zeros_like(p, memory_format=torch.contiguous_format)


def init_state(model, opt_cfg: OptConfig, *, error_feedback: bool = False, mesh=None,
               step_cfg=None) -> TrainState:
    """The state of ``model`` under ``opt_cfg``; given the ``mesh`` and the
    ``step_cfg`` the step will run, placed as ``state_pspecs`` says."""
    if step_cfg is not None and sharded_state(step_cfg, mesh):
        _place_params(model, mesh, state_pspecs(model, opt_cfg, step_cfg, mesh)["params"])
    params = model.leaves()
    device = next(iter(params.values())).device
    opt = init_opt_state(opt_cfg, {})
    for moment in ("mu", "nu"):
        if moment in opt:
            opt[moment] = {k: _zeros_like(v) for k, v in params.items()}
    state: TrainState = {"model": model, "opt": opt, "step": 0}
    if error_feedback:
        state["residual"] = torch.zeros((residual_size(params),), dtype=torch.float32,
                                        device=device)
    return state
