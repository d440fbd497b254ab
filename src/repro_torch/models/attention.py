"""Attention (port of ``repro.models.attention``, the full-sequence training
path): GQA projections with RoPE, causal and sliding-window masks, the
attention-logit softcap, and the output projection.

Plain PyTorch math: the scores of one layer are materialized as
``(B, Kh, G, S, S)`` f32, which at the port's training shapes (S <= 512) is
tens of MB.  At one KV chunk this is exactly the reference's online softmax
(running max, exp, sum, one P·V product).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import rope, softcap

__all__ = ["project_qkv", "attention", "attend"]

_NEG_INF = -1e30


def project_qkv(p, x: torch.Tensor, positions: torch.Tensor, rope_theta: float = 1e4):
    """x (B,S,D) -> q (B,S,Kh,G,Dh), k/v (B,S,Kh,Dh), rope applied."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    b, s, h, dh = q.shape
    kh = k.shape[2]
    return q.reshape(b, s, kh, h // kh, dh), k, v


def attention(q, k, v, positions: torch.Tensor, *, window: int = 0,
              attn_softcap: float = 0.0) -> torch.Tensor:
    """Causal (optionally windowed) softmax attention -> (B,S,Kh,G,Dh)."""
    dh = q.shape[-1]
    scale = 1.0 / (dh ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    s = softcap(s, attn_softcap)
    valid = positions[:, None] >= positions[None, :]
    if window:
        valid = valid & (positions[:, None] - positions[None, :] < window)
    s = torch.where(valid, s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v).float()
    out = pv / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def attend(p, out: torch.Tensor) -> torch.Tensor:
    """(B,S,Kh,G,Dh) -> output projection -> (B,S,D)."""
    b, s, kh, g, dh = out.shape
    merged = out.reshape(b, s, kh * g, dh)
    return torch.einsum("bshk,hkd->bsd", merged, p["wo"].to(out.dtype))
