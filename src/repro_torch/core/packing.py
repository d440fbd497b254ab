"""Index-payload packing (port of ``repro.core.packing``: ``pack_by_indices``
and ``unpack_by_indices``).

An index past the row -- the sentinel a threshold selector's compaction
leaves in a row with fewer than k values >= tau, such as an all-NaN row --
follows the reference's jnp semantics: a gather fills NaN there
(``take_along_axis``'s default), a scatter drops it (``.at[].set``'s).
torch would raise, and on the card read or write out of bounds."""

from __future__ import annotations

import torch

__all__ = ["pack_by_indices", "unpack_by_indices"]


def pack_by_indices(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-row kept values: (..., n), (..., k) -> (..., k); NaN where
    the index is past the row."""
    n = x2d.shape[-1]
    idx = idx.long()
    vals = torch.gather(x2d, -1, idx.clamp(0, n - 1))
    return torch.where(idx < n, vals, float("nan"))


def unpack_by_indices(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter per-row values back to dense (..., n) with zeros elsewhere; a
    value whose index is past the row is dropped (it lands in one spare
    column, cut off)."""
    zeros = values.new_zeros(values.shape[:-1] + (n + 1,))
    return zeros.scatter_(-1, idx.long().clamp(0, n), values)[..., :n]
