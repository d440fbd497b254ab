"""Keep counts and top-k selection (port of ``repro.core.sparsify``, the part
the compressed exchange uses).

``theta`` is the paper's drop-out ratio: keep the top ``(1 - theta)``
fraction of coefficients by magnitude.
"""

from __future__ import annotations

import torch

__all__ = ["keep_count", "topk_select"]


def keep_count(n: int, theta: float) -> int:
    """Static number of kept coefficients for drop ratio theta in [0, 1)."""
    if not 0.0 <= theta < 1.0:
        raise ValueError(f"theta must be in [0,1), got {theta}")
    return max(1, int(round((1.0 - theta) * n)))


def topk_select(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) of the k largest magnitudes, magnitude-descending;
    ties keep the lower index first, as ``lax.top_k`` does (a stable sort:
    ``torch.topk`` leaves the order of ties open, and the all-zero padding
    rows of a stacked bucket matrix are nothing but ties)."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]
