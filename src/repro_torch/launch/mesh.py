"""Worker meshes over the ``torch.distributed`` world (port of
``repro.launch.mesh``'s ``make_local_mesh`` and ``make_two_level_mesh``).

A :class:`Mesh` names the axes of the data-parallel workers: ``("data",)``
for a flat group, ``("node", "local")`` for the two-level topology of
islands of fast-linked cards over a slower fabric (:data:`TWO_LEVEL_AXES`).
Ranks are laid out row-major over the axes, so on a two-level mesh
``rank = node * local + local_index`` (node-major), and the reference's
row-major linear index over its mesh axes is the global rank.

Every axis has its group: the ranks that share this rank's coordinates on
every other axis (on a two-level mesh, ``node`` is the ranks with this
rank's local index, one per island, and ``local`` is this island's ranks);
``flat`` is the group of all of the mesh's ranks.  Building a mesh creates
every axis's subgroups, a collective call every rank makes in the same
order.  With no process group initialized the world is one worker and every
group is ``None`` (one worker, as ``dist_util`` reads it).

``make_production_mesh`` (``--mesh production|multi_pod``) is not ported:
its point is FSDP and tensor parallelism inside a pod, which the port's
replicated step does not run (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.dist_util import rank_and_world

__all__ = ["Mesh", "TWO_LEVEL_AXES", "make_local_mesh", "make_two_level_mesh"]

# the two-level data topology: ``node`` is the slow inter-node fabric,
# ``local`` the fast intra-node link
TWO_LEVEL_AXES = ("node", "local")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a worker mesh: the axes' names and sizes, its
    coordinates, each axis's group and the ``flat`` group of every rank."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[object, ...]  # one per axis (None: no process group)
    flat: object = None

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
        """The group of one axis; the axes' full tuple (in mesh order) is
        ``flat``."""
        if isinstance(axis, str):
            return self.groups[self._axis(axis)]
        axes = tuple(axis)
        if len(axes) == 1:
            return self.group(axes[0])
        if axes == self.axis_names:
            return self.flat
        raise ValueError(f"no group spans {axes} of the mesh's axes {self.axis_names}")

    def index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    @property
    def topology(self) -> Optional[Tuple[int, int]]:
        """(nodes, local) of a two-axis mesh, else None."""
        return tuple(self.sizes) if len(self.sizes) == 2 else None

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


def _axis_groups(sizes: Tuple[int, ...], axis: int):
    """Every group of one axis, as lists of global ranks in axis order."""
    others = [range(s) for i, s in enumerate(sizes) if i != axis]
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    out = []
    for rest in itertools.product(*others):
        coord = list(rest)
        coord.insert(axis, 0)
        base = sum(c * st for c, st in zip(coord, strides))
        out.append([base + j * strides[axis] for j in range(sizes[axis])])
    return out


def make_local_mesh(shape=None, axes=None) -> Mesh:
    """A mesh over the world's workers: ``shape=None`` is every worker on
    one ``("data",)`` axis; ``make_local_mesh((nodes, local))`` is the
    two-level ``("node", "local")`` topology.  The mesh must cover the
    world: too few workers, a non-positive size or an axis count that does
    not match the names is a named error."""
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
    if dist.is_available() and dist.is_initialized():
        # collective: every rank creates every subgroup, in the same order
        groups = tuple(dist.new_subgroups_by_enumeration(_axis_groups(shape, i))[0]
                       for i in range(len(shape)))
        flat = dist.group.WORLD
    else:
        groups, flat = (None,) * len(shape), None
    return Mesh(axes, shape, coords, groups, flat)


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
