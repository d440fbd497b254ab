"""Logical-axis parameter sharding (port of ``repro.models.sharding``).

Every parameter is declared as a :class:`ParamSpec` with *logical* axis
names (``("vocab", "embed")``, ``("heads", "head_dim")``, ...).  When a
mesh is bound, the rules map logical axes to mesh axes, with two safety
valves:

* divisibility -- a logical axis only binds to a mesh axis whose size
  divides the dimension; otherwise that dim is replicated (``kv_heads=5``
  on a ``model=16`` mesh);
* fsdp -- with ``fsdp=True`` the largest yet-unsharded eligible axis of
  each parameter also binds to the ``data`` axis (ZeRO-3-style parameter
  sharding: the 110B, 141B and 235B configs need it to fit).

Parameters are never sharded over ``pod`` (nor over the two-level
``node``/``local`` axes): those are pure data-parallel axes.

:func:`resolve_pspec` returns what the reference's ``PartitionSpec``
holds: one mesh-axis name, or None, per dimension.  :func:`placements`
turns such a spec into ``DTensor`` placements on a ``DeviceMesh`` whose
dims are the mesh's axes, and :func:`local_slice` names the block of the
full array that one mesh coordinate holds; no other module derives either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

__all__ = ["ParamSpec", "DEFAULT_RULES", "TWO_LEVEL_DATA_AXES", "data_axes_for",
           "resolve_pspec", "spec_tree_to_pspecs", "count_params", "placements",
           "local_slice", "block_of"]

PSpec = Tuple[Optional[str], ...]

# the two-level data topology's axis pair: parameters are never sharded
# over these (as over ``pod``)
TWO_LEVEL_DATA_AXES = ("node", "local")


def data_axes_for(mesh_axis_sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The mesh's data-parallel (batch) axes, in mesh order: both two-level
    axes on a two-level mesh, else ``("data",)`` (with a leading ``"pod"``
    on a multi-pod mesh)."""
    if all(a in mesh_axis_sizes for a in TWO_LEVEL_DATA_AXES):
        return tuple(a for a in mesh_axis_sizes if a in TWO_LEVEL_DATA_AXES)
    axes = tuple(a for a in mesh_axis_sizes if a in ("pod", "data"))
    return axes if axes else ("data",)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A parameter's shape, logical axes and initializer (``normal`` with
    ``scale``, default 0.02; ``zeros``; ``ones``, whatever the scale)."""

    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), (self.shape, self.logical_axes)


# logical axis -> preferred mesh axis ("model" is the tensor-parallel axis).
# A head-count axis that the model axis does not divide (gemma2's 8 q / 4 kv
# heads on 16-way TP) replicates rather than falling back to head_dim.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "ssm_inner": "model",
    "xlstm_inner": "model",
    "embed": None,  # fsdp may claim it
    "head_dim": None,
    "layers": None,
    "conv": None,
    "state": None,
}

# the logical axes FSDP may claim
_FSDP_ELIGIBLE = ("embed", "ff", "vocab", "heads", "experts", "ssm_inner", "xlstm_inner")


def resolve_pspec(spec: ParamSpec, mesh_axis_sizes: Mapping[str, int],
                  rules: Mapping[str, Optional[str]] = DEFAULT_RULES, fsdp: bool = False,
                  fsdp_axis: str = "data") -> PSpec:
    """ParamSpec -> one mesh-axis name (or None) per dimension."""
    assignment: list = []
    used = set()
    for dim, logical in zip(spec.shape, spec.logical_axes):
        mesh_axis = rules.get(logical) if logical else None
        if (mesh_axis and mesh_axis in mesh_axis_sizes and mesh_axis not in used
                and dim % mesh_axis_sizes[mesh_axis] == 0):
            assignment.append(mesh_axis)
            used.add(mesh_axis)
        else:
            assignment.append(None)
    if fsdp and fsdp_axis in mesh_axis_sizes and fsdp_axis not in used:
        # the largest eligible unsharded dim the fsdp axis divides
        best, best_dim = None, 0
        for i, (dim, logical) in enumerate(zip(spec.shape, spec.logical_axes)):
            if (assignment[i] is None and logical in _FSDP_ELIGIBLE
                    and dim % mesh_axis_sizes[fsdp_axis] == 0 and dim > best_dim):
                best, best_dim = i, dim
        if best is not None:
            assignment[best] = fsdp_axis
    return tuple(assignment)


def spec_tree_to_pspecs(specs: Mapping[str, ParamSpec], mesh_axis_sizes: Mapping[str, int],
                        rules: Mapping[str, Optional[str]] = DEFAULT_RULES,
                        fsdp: bool = False) -> Dict[str, PSpec]:
    """Leaf path -> resolved spec, for a flat mapping of ParamSpecs."""
    return {k: resolve_pspec(s, mesh_axis_sizes, rules, fsdp) for k, s in specs.items()}


def count_params(specs: Mapping[str, ParamSpec]) -> int:
    """Exact parameter count from the specs."""
    return sum(math.prod(s.shape) for s in specs.values())


def placements(pspec: PSpec, mesh_axes: Sequence[str]):
    """``DTensor`` placements, one per mesh axis, of a resolved spec on a
    ``DeviceMesh`` whose dims are ``mesh_axes``: ``Shard(d)`` on the axis
    that dimension ``d`` names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    unknown = [a for a in pspec if a is not None and a not in mesh_axes]
    if unknown:
        raise ValueError(f"spec {pspec} names axes {unknown} that the mesh {tuple(mesh_axes)} "
                         "does not have")
    return tuple(Shard(pspec.index(a)) if a in pspec else Replicate() for a in mesh_axes)


def local_slice(pspec: PSpec, shape: Sequence[int], mesh_shape: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The block of a full array of ``shape`` that the mesh coordinate
    ``coords`` holds under ``pspec``: an even split of each sharded dim."""
    out = []
    for dim, axis in zip(shape, pspec):
        if axis is None:
            out.append(slice(None))
        else:
            n = dim // mesh_shape[axis]
            out.append(slice(coords[axis] * n, (coords[axis] + 1) * n))
    return tuple(out)


def block_of(full, dtensor):
    """The block of ``full`` that this rank's shard of ``dtensor`` holds,
    read off the DTensor's own placements and mesh coordinate."""
    mesh = dtensor.device_mesh
    coord = mesh.get_coordinate()
    index = [slice(None)] * full.ndim
    for i, pl in enumerate(dtensor.placements):
        if pl.is_shard():
            n = full.shape[pl.dim] // mesh.size(i)
            index[pl.dim] = slice(coord[i] * n, (coord[i] + 1) * n)
    return full[tuple(index)]
