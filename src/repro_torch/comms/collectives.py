"""Worker-axis arithmetic and explicit ring collectives over one
``torch.distributed`` group (port of ``repro.comms.collectives``).

An axis spec here is a group (``None``: the default group, or one worker
when none is initialized), a ``launch.mesh.Mesh`` (all of its workers), or
a mesh's axis names with ``mesh=`` (one name, or a tuple of names).

The rings run ``n - 1`` steps of one ``dist.batch_isend_irecv`` each, every
worker sending to the next rank of the group and receiving from the one
before, in the reference's step order and with its accumulator schedule, so
a reduced shard is summed in the same order and is bitwise the
reference's.  NCCL's and gloo's own ``all_reduce`` choose their sum order
themselves; these rings fix it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.dist_util import rank_and_world
from repro_torch.launch.mesh import Mesh

__all__ = ["AxisSpec", "normalize_axes", "axis_size", "axis_sizes", "axis_linear_index",
           "ring_all_gather", "ring_reduce_scatter", "ring_all_reduce"]

AxisSpec = Union[str, Sequence[str]]


def normalize_axes(axis: AxisSpec) -> Union[str, Tuple[str, ...]]:
    """A name stays a name; any other sequence becomes a tuple of names (a
    one-name tuple stays a tuple)."""
    if isinstance(axis, str):
        return axis
    axes = tuple(axis)
    if not axes or not all(isinstance(a, str) for a in axes):
        raise ValueError(f"axis spec must be a name or a non-empty sequence of names, "
                         f"got {axis!r}")
    return axes


def _is_names(spec) -> bool:
    return isinstance(spec, str) or (isinstance(spec, (tuple, list)) and bool(spec)
                                     and all(isinstance(a, str) for a in spec))


def _names(spec, mesh) -> Tuple[str, ...]:
    if mesh is None:
        raise ValueError(f"axis names {spec!r} need mesh=")
    norm = normalize_axes(spec)
    return (norm,) if isinstance(norm, str) else norm


def axis_sizes(spec=None, mesh=None) -> Tuple[int, ...]:
    """Workers along each axis of the spec, in spec order: a group is one
    axis, a mesh its own axes."""
    if isinstance(spec, Mesh):
        return tuple(spec.sizes)
    if _is_names(spec):
        return tuple(mesh.shape[a] for a in _names(spec, mesh))
    return (rank_and_world(spec)[1],)


def axis_size(spec=None, mesh=None) -> int:
    """Workers over one axis, a tuple of axes (their product), a mesh or a
    group."""
    return math.prod(axis_sizes(spec, mesh))


def axis_linear_index(spec=None, mesh=None) -> int:
    """This worker's row-major linear index over the spec's axes: its rank
    in a group; over a mesh's axis names, in the order they are named."""
    if isinstance(spec, Mesh):
        mesh, spec = spec, spec.axis_names
    if not _is_names(spec):
        return rank_and_world(spec)[0]
    idx = 0
    for a in _names(spec, mesh):
        idx = idx * mesh.shape[a] + mesh.index(a)
    return idx


def _ring_step(send: torch.Tensor, group, rank: int, n: int, step: int) -> torch.Tensor:
    """Send ``send`` to ``rank + step`` and receive from ``rank - step``
    (mod n, ranks of ``group``): one ``batch_isend_irecv``."""
    recv = torch.empty_like(send)
    pg = dist.group.WORLD if group is None else group
    to = dist.get_global_rank(pg, (rank + step) % n)
    frm = dist.get_global_rank(pg, (rank - step) % n)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                       dist.P2POp(dist.irecv, recv, frm, group)]):
        req.wait()
    return recv


def ring_all_gather(x: torch.Tensor, group=None, *, reverse: bool = False) -> torch.Tensor:
    """All-gather by ``n - 1`` ring steps -> ``(n, *x.shape)``, row ``i``
    from rank ``i`` of ``group``."""
    idx, n = rank_and_world(group)
    out = x.new_empty((n,) + tuple(x.shape))
    out[idx] = x
    buf = x.contiguous()
    step = -1 if reverse else 1
    for i in range(1, n):
        buf = _ring_step(buf, group, idx, n, step)
        out[(idx - step * i) % n] = buf
    return out


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Reduce-scatter by ``n - 1`` ring steps: ``x`` ``(n*s, ...)`` is n
    shards of s rows; returns this rank's reduced shard ``(s, ...)``.  At
    step i rank d adds its own copy of shard ``(d + n - 1 - i) mod n`` to the
    accumulator it received."""
    idx, n = rank_and_world(group)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} must divide the group's {n} workers")
    shards = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    acc = shards[(idx + n - 1) % n].contiguous()
    for i in range(1, n):
        acc = _ring_step(acc, group, idx, n, 1)
        acc = acc + shards[(idx + n - 1 - i) % n]
    return acc


def ring_all_reduce(x: torch.Tensor, group=None, *,
                    shard_hook: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Ring all-reduce = reduce-scatter + all-gather (2(n-1)/n of the buffer
    a worker); ``shard_hook`` runs on the reduced shard between the two
    halves (where a per-shard compression goes)."""
    _, n = rank_and_world(group)
    pad = (-x.shape[0]) % n
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x
    shard = ring_reduce_scatter(xp, group)
    if shard_hook is not None:
        shard = shard_hook(shard)
    full = ring_all_gather(shard, group).reshape((-1,) + tuple(x.shape[1:]))
    return full[: x.shape[0]]
