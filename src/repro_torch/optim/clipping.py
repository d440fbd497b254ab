"""Global-norm gradient clipping (port of ``repro.optim.clipping``)."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch import tracing

__all__ = ["global_norm", "clip_by_global_norm", "clip_to_norm"]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree.values()))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor],
                        max_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """-> (tree scaled by min(1, max_norm / norm), norm)."""
    with tracing.span("optim.clip"):
        norm = global_norm(tree)
    return clip_to_norm(tree, norm, max_norm), norm


def clip_to_norm(tree: Mapping[str, torch.Tensor], norm: torch.Tensor,
                 max_norm: float) -> Dict[str, torch.Tensor]:
    """``tree`` scaled by min(1, max_norm / norm), for a norm computed
    elsewhere (over shards)."""
    with tracing.span("optim.clip"):
        scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
        return {k: (l * scale).to(l.dtype) for k, l in tree.items()}
