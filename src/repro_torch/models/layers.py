"""Shared layers (port of ``repro.models.layers``): RMSNorm, gated MLPs,
embedding, RoPE, softcap; and ``associative_scan``, JAX's parallel-prefix
recursion, which the SSM's scan rounds through.

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
           "unembed", "rope", "associative_scan"]

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


def mlp(p, x: torch.Tensor, activation: str = "swiglu", tp=None) -> torch.Tensor:
    """The gated (or plain) MLP; under tensor parallelism over ff
    (``tp.ff``) up/gate are this rank's columns and down its rows, and the
    partial sums are reduced."""
    dt = x.dtype
    split = tp is not None and tp.ff
    if split:
        x = tp.copy(x)
    up = x @ p["up"].to(dt)
    if activation == "swiglu":
        h = F.silu(x @ p["gate"].to(dt)) * up
    elif activation == "geglu":
        h = F.gelu(x @ p["gate"].to(dt), approximate="tanh") * up
    elif activation == "relu":
        h = F.relu(up)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    y = h @ p["down"].to(dt)
    return tp.reduce(y) if split else y


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype=COMPUTE_DTYPE,
          tp=None) -> torch.Tensor:
    """The rows of ``tokens``; under tensor parallelism over the vocab the
    table is this rank's rows, looked up where the token falls in them and
    summed over the ranks (one rank holds each row: exact)."""
    if tp is None or not tp.vocab:
        return F.embedding(tokens, table).to(dtype)
    lo = tp.rank * table.shape[0]
    mine = (tokens >= lo) & (tokens < lo + table.shape[0])
    rows = F.embedding(torch.where(mine, tokens - lo, 0), table) * mine[..., None]
    return tp.reduce(rows).to(dtype)


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


def associative_scan(fn, elems, dim: int = 0):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(earlier, later) -> tuple``.

    The odd/even recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan the half-length sequence, then combine each odd result with
    the next even element, so every output is built from the same combines
    in the same order as the reference's (log-depth, ~2n combines)."""
    moved = tuple(e.movedim(dim, 0) for e in elems)
    return tuple(e.movedim(0, dim) for e in _scan0(fn, moved))


def _scan0(fn, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _scan0(fn, fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems)))
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along dim 0 (``a`` one longer, or as long)."""
    m = b.shape[0]
    pairs = torch.stack([a[:m], b], dim=1).reshape((2 * m,) + b.shape[1:])
    return pairs if a.shape[0] == m else torch.cat([pairs, a[m:]])
