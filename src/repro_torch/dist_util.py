"""The process group as the port's layers see it: one worker when no
``torch.distributed`` group is initialized, so every layer runs unchanged
in a single process."""

from __future__ import annotations

from typing import Tuple

import torch.distributed as dist

__all__ = ["world_size", "rank_and_world"]


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
