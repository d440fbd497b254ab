"""Index-payload packing (port of ``repro.core.packing``: ``pack_by_indices``
and ``unpack_by_indices``)."""

from __future__ import annotations

import torch

__all__ = ["pack_by_indices", "unpack_by_indices"]


def pack_by_indices(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-row kept values: (..., n), (..., k) -> (..., k)."""
    return torch.gather(x2d, -1, idx.long())


def unpack_by_indices(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter per-row values back to dense (..., n) with zeros elsewhere."""
    zeros = values.new_zeros(values.shape[:-1] + (n,))
    return zeros.scatter_(-1, idx.long(), values)
