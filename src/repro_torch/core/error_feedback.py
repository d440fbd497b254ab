"""Error-feedback residual accumulation (port of
``repro.core.error_feedback``; beyond the paper, default off).

DGC-style memory: the compression error of step t is added back to the
gradient of step t+1, turning a biased compressor into an asymptotically
unbiased one.  The paper's own scheme does not use error feedback (its
convergence proof covers the memoryless compressor)::

    e_0 = 0
    c_t = compress(g_t + e_{t-1})
    e_t = (g_t + e_{t-1}) - decompress(c_t)

The reducers keep one flat residual (``comms/reducers.py``); these are the
same two operations on a gradient tree (a mapping of parameter paths to
tensors) and on one flat leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Union

import torch

__all__ = ["init_residual", "compress_with_feedback"]


def init_residual(grads: Union[torch.Tensor, Mapping[str, torch.Tensor]]
                  ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """Zero residual shaped like ``grads`` (a tensor, or a mapping of them)."""
    if isinstance(grads, torch.Tensor):
        return torch.zeros_like(grads)
    return {name: torch.zeros_like(g) for name, g in grads.items()}


def compress_with_feedback(
    compress_fn: Callable[[torch.Tensor], Any],
    decompress_fn: Callable[[Any], torch.Tensor],
    grad_flat: torch.Tensor,
    residual_flat: torch.Tensor,
) -> Tuple[Any, torch.Tensor]:
    """One EF step on a flat leaf; returns (payload, new_residual)."""
    corrected = grad_flat + residual_flat
    payload = compress_fn(corrected)
    new_residual = corrected - decompress_fn(payload)
    return payload, new_residual
