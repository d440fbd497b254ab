"""Attention (port of ``repro.models.attention``): GQA projections with the
optional QKV bias and RoPE, causal and sliding-window masks, cross
attention (queries from one sequence, keys and values from another, no
causal mask and no rope), the attention-logit softcap, the output
projection, and the KV caches of serving (flat, or a ring buffer of
``window`` slots for a sliding-window layer).

Plain PyTorch math: the scores of one layer are materialized as
``(B, Kh, G, Sq, Skv)`` f32, which at the port's training shapes (S <= 512)
is tens of MB and at a 4608-token prefill about 1.4 GB a tensor.  At one KV
chunk this is exactly the reference's online softmax (running max, exp,
sum, one P·V product).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.layers import COMPUTE_DTYPE, rope, softcap

__all__ = ["project_qkv", "attention", "attend", "KVCache", "init_kv_cache",
           "update_kv_cache"]

_NEG_INF = -1e30


def project_qkv(p, x_q: torch.Tensor, x_kv: torch.Tensor,
                q_positions: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None, rope_theta: float = 1e4,
                tp=None):
    """x_q (B,Sq,D), x_kv (B,Skv,D) -> q (B,Sq,Kh,G,Dh), k/v (B,Skv,Kh,Dh);
    with ``qkv_bias`` the biases ``bq``/``bk``/``bv`` are added, then rope
    where positions are given (a cross block passes none).

    Under tensor parallelism over heads (``tp.heads``) the leaves are this
    rank's heads: q holds them, and k/v this rank's kv heads, or, when the
    model axis does not divide the kv heads, the kv head of each local query
    head, (B,Skv,H_local,Dh) with G = 1.  Both inputs enter through ``copy``
    (a cross block's memory too, so its gradient sums over the ranks)."""
    dt = x_q.dtype
    split = tp is not None and tp.heads
    if split:
        same = x_kv is x_q
        x_q = tp.copy(x_q)
        x_kv = x_q if same else tp.copy(x_kv)
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    if split and not tp.kv_heads:
        kv = {n: tp.copy(w) for n, w in kv.items()}
    q = torch.einsum("bsd,dhk->bshk", x_q, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x_kv, kv["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x_kv, kv["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + kv["bk"].to(dt)
        v = v + kv["bv"].to(dt)
    if q_positions is not None:
        q = rope(q, q_positions, rope_theta)
    if kv_positions is not None:
        k = rope(k, kv_positions, rope_theta)
    b, s, h, dh = q.shape
    if split and not tp.kv_heads:
        group = h * tp.size // k.shape[2]
        idx = (tp.rank * h + torch.arange(h, device=k.device)) // group
        k, v = k[:, :, idx], v[:, :, idx]
    kh = k.shape[2]
    return q.reshape(b, s, kh, h // kh, dh), k, v


def attention(q, k, v, q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
              causal: bool = True, window: int = 0, attn_softcap: float = 0.0) -> torch.Tensor:
    """Softmax attention, causal (optionally windowed) unless ``causal`` is
    False -> (B,Sq,Kh,G,Dh).

    ``q_positions`` (Sq,) and ``kv_positions`` (Skv,) are absolute
    positions; a key at position -1 is an empty cache slot and is masked,
    as the reference masks it (the one mask a cross block keeps)."""
    dh = q.shape[-1]
    scale = 1.0 / (dh ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    s = softcap(s, attn_softcap)
    valid = (kv_positions[None, :] >= 0).expand(q_positions.shape[0], -1)
    if causal:
        valid = valid & (q_positions[:, None] >= kv_positions[None, :])
    if window:
        valid = valid & (q_positions[:, None] - kv_positions[None, :] < window)
    s = torch.where(valid, s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v).float()
    out = pv / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def attend(p, out: torch.Tensor, tp=None) -> torch.Tensor:
    """(B,S,Kh,G,Dh) -> output projection -> (B,S,D); under tensor
    parallelism over heads the local heads' partial sums are reduced."""
    b, s, kh, g, dh = out.shape
    merged = out.reshape(b, s, kh * g, dh)
    y = torch.einsum("bshk,hkd->bsd", merged, p["wo"].to(out.dtype))
    return tp.reduce(y) if tp is not None and tp.heads else y


@dataclasses.dataclass
class KVCache:
    """One layer's cache; the LM stacks every leaf on a leading
    ``(n_groups,)`` axis and hands each group a view."""

    k: torch.Tensor  # (B, S_cache, Kh, Dh)
    v: torch.Tensor
    pos: torch.Tensor  # (S_cache,) int32 absolute position per slot, -1 = empty
    ring: bool  # slot = position % S_cache


def init_kv_cache(batch: int, seq: int, kv_heads: int, head_dim: int, *, window: int = 0,
                  dtype=COMPUTE_DTYPE, device=None) -> KVCache:
    """Empty cache for ``seq`` positions; a window shorter than ``seq``
    makes a ring of ``window`` slots."""
    size = min(window, seq) if window else seq
    return KVCache(
        k=torch.zeros((batch, size, kv_heads, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, size, kv_heads, head_dim), dtype=dtype, device=device),
        pos=torch.full((size,), -1, dtype=torch.int32, device=device),
        ring=bool(window and window < seq))


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    start: int) -> KVCache:
    """Write S_new entries at absolute positions start..start+S_new-1, in
    place; returns ``cache``.

    A ring keeps only the last ``size`` entries of a longer write.  A flat
    cache clamps the slot offset into range, as the reference's
    ``dynamic_update_slice`` does (the positions written stay unclamped)."""
    s_new = k_new.shape[1]
    size = cache.k.shape[1]
    if cache.ring and s_new > size:
        k_new, v_new = k_new[:, -size:], v_new[:, -size:]
        start += s_new - size
        s_new = size
    positions = torch.arange(start, start + s_new, dtype=torch.int32, device=cache.pos.device)
    if cache.ring:
        slots = (positions % size).long()
        cache.k[:, slots] = k_new
        cache.v[:, slots] = v_new
        cache.pos[slots] = positions
    else:
        if s_new > size:
            raise ValueError(f"a write of {s_new} entries does not fit a cache of {size}")
        lo = min(max(start, 0), size - s_new)
        cache.k[:, lo:lo + s_new] = k_new
        cache.v[:, lo:lo + s_new] = v_new
        cache.pos[lo:lo + s_new] = positions
    return cache
