"""Worker meshes over the ``torch.distributed`` world (port of
``repro.launch.mesh``: ``make_production_mesh``, ``make_local_mesh`` and
``make_two_level_mesh``).

A :class:`Mesh` names the axes of the workers: ``("data",)`` for a flat
group, ``("node", "local")`` for the two-level topology of islands of
fast-linked cards over a slower fabric (:data:`TWO_LEVEL_AXES`), and the
production meshes ``(16, 16)`` over ``("data", "model")`` and ``(2, 16,
16)`` over ``("pod", "data", "model")``, whose ``model`` axis carries
tensor parallelism and whose ``data`` axis FSDP (``train/step.py``).
Ranks are laid out row-major over the axes, so on a two-level mesh
``rank = node * local + local_index`` (node-major), and the reference's
row-major linear index over its mesh axes is the global rank.

Every axis has its group: the ranks that share this rank's coordinates on
every other axis (on a two-level mesh, ``node`` is the ranks with this
rank's local index, one per island, and ``local`` is this island's ranks);
every set of two or more axes short of all of them has one too (the batch
axes ``("pod", "data")`` of a 3-D mesh), and ``flat`` is the group of all
of the mesh's ranks.  A mesh also carries a ``DeviceMesh`` with the same
row-major rank layout and axis names, on which the sharded state's
``DTensor`` leaves live.  Building a mesh creates all of these groups, a
collective call every rank makes in the same order.  With no process group
initialized the world is one worker, every group is ``None`` (one worker,
as ``dist_util`` reads it) and there is no ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist_util import rank_and_world
from repro_torch.models.sharding import TWO_LEVEL_DATA_AXES

__all__ = ["Mesh", "TWO_LEVEL_AXES", "make_local_mesh", "make_two_level_mesh",
           "make_production_mesh"]

# the two-level data topology: ``node`` is the slow inter-node fabric,
# ``local`` the fast intra-node link
TWO_LEVEL_AXES = TWO_LEVEL_DATA_AXES


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a worker mesh: the axes' names and sizes, its
    coordinates, each axis's group and the ``flat`` group of every rank."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[object, ...]  # one per axis (None: no process group)
    flat: object = None
    # (axis, axis, ...) in mesh order -> group, for every set of two or more
    # axes short of all of them
    subgroups: Dict[Tuple[str, ...], object] = dataclasses.field(default_factory=dict)
    device_mesh: object = None  # torch's DeviceMesh (None: no process group)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def _axis(self, name: str) -> int:
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise ValueError(f"mesh axes {self.axis_names} have no axis {name!r}") from None

    def group(self, axis):
        """The group of one axis, or of a tuple of axes (any order); all of
        the mesh's axes are ``flat`` (None without a process group)."""
        if self.flat is None:
            return None
        if isinstance(axis, str):
            return self.groups[self._axis(axis)]
        axes = tuple(sorted(axis, key=self._axis))
        if len(axes) == 1:
            return self.group(axes[0])
        if axes == self.axis_names:
            return self.flat
        if axes not in self.subgroups:
            raise ValueError(f"no group spans {axes} of the mesh's axes {self.axis_names}")
        return self.subgroups[axes]

    def index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def linear_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in the order given)."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[self._axis(a)] + self.index(a)
        return idx

    def size_of(self, axes) -> int:
        """The number of coordinates ``axes`` span together."""
        return math.prod(self.sizes[self._axis(a)] for a in axes)

    @property
    def topology(self) -> Optional[Tuple[int, int]]:
        """(nodes, local) of a two-axis data-parallel mesh, else None (a mesh
        with a ``model`` or ``pod`` axis is not a two-level topology)."""
        if len(self.sizes) != 2 or {"model", "pod"} & set(self.axis_names):
            return None
        return tuple(self.sizes)

    # a two-axis mesh's hops: its first axis is the fabric between islands
    # (``node``), its second the link inside one (``local``)
    @property
    def node(self):
        return self._two_level_group(0)

    @property
    def local(self):
        return self._two_level_group(1)

    def _two_level_group(self, i: int):
        if len(self.sizes) != 2:
            raise ValueError(f"mesh axes {self.axis_names} are not a two-level topology")
        return self.groups[i]


def _axis_groups(sizes: Tuple[int, ...], axes):
    """Every group spanning the axes ``axes`` (an index or a tuple of them,
    ascending), as lists of global ranks, row-major over those axes."""
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [i for i in range(len(sizes)) if i not in axes]
    out = []
    for rest in itertools.product(*(range(sizes[i]) for i in others)):
        base = sum(c * strides[i] for c, i in zip(rest, others))
        out.append([base + sum(c * strides[i] for c, i in zip(inner, axes))
                    for inner in itertools.product(*(range(sizes[i]) for i in axes))])
    return out


def _device_type(device) -> str:
    """The DeviceMesh's device type: the caller's, else the backend's own
    (``cuda`` under NCCL, ``cpu`` otherwise)."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_local_mesh(shape=None, axes=None, device=None) -> Mesh:
    """A mesh over the world's workers: ``shape=None`` is every worker on
    one ``("data",)`` axis; ``make_local_mesh((nodes, local))`` is the
    two-level ``("node", "local")`` topology; any other shape names its
    axes.  The mesh must cover the world: too few workers, a non-positive
    size or an axis count that does not match the names is a named error.
    ``device`` is the ``DeviceMesh``'s (``"cuda"`` on the card, ``"cpu"``
    over gloo; None: the backend's)."""
    rank, world = rank_and_world()
    if shape is None:
        shape, axes = (world,), ("data",)
    shape = tuple(int(s) for s in shape)
    if axes is None:
        if len(shape) == 1:
            axes = ("data",)
        elif len(shape) == 2:
            axes = TWO_LEVEL_AXES
        else:
            raise ValueError(f"shape {shape} needs explicit axes= (only 1-D and 2-D "
                             f"shapes have default axis names)")
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} has {len(shape)} dims but axes {axes} "
                         f"names {len(axes)}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has a non-positive axis size")
    need = math.prod(shape)
    if need > world:
        raise ValueError(f"mesh shape {shape} over axes {axes} needs {need} workers, but "
                         f"only {world} worker{'s' if world != 1 else ''} exist "
                         f"(launch more processes, e.g. torchrun --nproc-per-node)")
    if need < world:
        raise ValueError(f"mesh shape {shape} over axes {axes} covers {need} of the "
                         f"{world} workers; every worker must be in the mesh")
    coords = tuple((rank // math.prod(shape[i + 1:])) % shape[i] for i in range(len(shape)))
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axes, shape, coords, (None,) * len(shape))
    from torch.distributed.device_mesh import DeviceMesh

    # collective: every rank creates every subgroup, in the same order
    groups = tuple(dist.new_subgroups_by_enumeration(_axis_groups(shape, i))[0]
                   for i in range(len(shape)))
    subgroups = {}
    for n in range(2, len(shape)):
        for idx in itertools.combinations(range(len(shape)), n):
            subgroups[tuple(axes[i] for i in idx)] = dist.new_subgroups_by_enumeration(
                _axis_groups(shape, idx))[0]
    # the DeviceMesh over the axes' own groups: it creates none of its own
    device_mesh = DeviceMesh.from_group(list(groups), _device_type(device),
                                        mesh=torch.arange(need).reshape(shape),
                                        mesh_dim_names=axes)
    return Mesh(axes, shape, coords, groups, dist.group.WORLD, subgroups, device_mesh)


def make_production_mesh(multi_pod: bool = False, device=None) -> Mesh:
    """One pod: ``(16, 16)`` over ``("data", "model")``; multi-pod:
    ``(2, 16, 16)`` over ``("pod", "data", "model")``.  Any other world
    size is a named error."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _, world = rank_and_world()
    if world != math.prod(shape):
        raise ValueError(f"the {'multi-pod' if multi_pod else 'production'} mesh {shape} over "
                         f"{axes} needs a world of {math.prod(shape)} workers, got {world}")
    return make_local_mesh(shape, axes, device)


def make_two_level_mesh(nodes: int, local=None, axes=TWO_LEVEL_AXES) -> Mesh:
    """A ``(nodes, local)`` mesh over ``("node", "local")``; ``local=None``
    splits the world evenly across the nodes (an uneven split is a named
    error)."""
    _, world = rank_and_world()
    nodes = int(nodes)
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    if local is None:
        if world % nodes:
            raise ValueError(f"{world} workers do not split evenly across {nodes} nodes; "
                             f"pass local= explicitly or pick a divisor of {world}")
        local = world // nodes
    return make_local_mesh((nodes, int(local)), axes)
