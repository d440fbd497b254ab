"""Shared layers (port of ``repro.models.layers``): RMSNorm, gated MLPs,
embedding, RoPE, softcap.

Params are stored f32 and cast to ``COMPUTE_DTYPE`` (bf16) at use;
activations flow in bf16 and reductions (norms, softmax, loss) run in f32,
as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["COMPUTE_DTYPE", "padded_vocab", "softcap", "rmsnorm", "mlp", "embed",
           "unembed", "rope"]

COMPUTE_DTYPE = torch.bfloat16


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2-style logit soft capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def mlp(p, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    up = x @ p["up"].to(dt)
    if activation == "swiglu":
        h = F.silu(x @ p["gate"].to(dt)) * up
    elif activation == "geglu":
        h = F.gelu(x @ p["gate"].to(dt), approximate="tanh") * up
    elif activation == "relu":
        h = F.relu(up)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return h @ p["down"].to(dt)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    return F.embedding(tokens, table).to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor, vocab: int = 0,
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 logits over the padded vocab, through the untied ``head``
    ``(d, padded_vocab)`` when given, else the table's transpose; pad
    columns -> -1e30."""
    w = table.T if head is None else head
    logits = (x @ w.to(x.dtype)).float()
    vp = logits.shape[-1]
    if vocab and vocab < vp:
        mask = torch.arange(vp, device=logits.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    return logits


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    angles = positions.float()[..., None] * freqs  # (seq, half)
    cos = torch.cos(angles)[..., None, :]  # (seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
