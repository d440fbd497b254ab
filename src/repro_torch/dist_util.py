"""The process group as the port's layers see it: one worker when no
``torch.distributed`` group is initialized, so every layer runs unchanged
in a single process.  :func:`init_fake_world` starts the ``fake`` backend
the dry-run traces over (``launch/dryrun.py``)."""

from __future__ import annotations

from typing import Tuple

import torch.distributed as dist

__all__ = ["world_size", "rank_and_world", "init_fake_world"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """Workers in ``group``: 1 when no process group is initialized."""
    return dist.get_world_size(group) if _initialized() else 1


def rank_and_world(group=None) -> Tuple[int, int]:
    """(this worker's rank in ``group``, its world size); (0, 1) when no
    process group is initialized."""
    if not _initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def init_fake_world(world: int, rank: int = 0) -> None:
    """A process group of ``world`` ranks, this process ``rank``, on
    PyTorch's ``fake`` backend: every collective returns at once and moves
    nothing, so one process can build and trace a production mesh."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry-run's fake world needs torch.testing._internal.distributed."
                           f"fake_pg (PyTorch's 'fake' process-group backend): {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
