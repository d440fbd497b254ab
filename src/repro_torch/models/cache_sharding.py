"""Serving caches sharded over a mesh: each rank holds its block of every
cache leaf, as ``serve.engine.cache_pspecs`` (the reference's
``_cache_pspecs``) places it, and the cached layers read and write those
blocks in place.

A leaf's spec names one mesh axis (or None) per dimension of the per-group
leaf, batch first.  Where the engine hands each ``data`` rank its own rows
(``ServeLayout.rows``), a leaf whose batch is over ``data`` holds those
rows, and a leaf the placement replicates (the mLSTM's ``m``, the sLSTM's
states) holds every row, of which the step takes the rank's own and
gathers the new ones back.  The other dims are split evenly over their axes, and
:func:`relayout` moves a leaf between two specs: it gathers each dim that
the source splits and the target does not, and takes this rank's block of
each dim that the target splits.

The KV caches are never gathered (:func:`write_kv`, :func:`attend_kv`):

* a sequence split (``(G, B, S, KV, Dh)`` with ``S`` over ``model``, or
  over ``data`` at batch 1) is read split-KV: each rank attends its slots
  for every head and returns its partial max, sum and weighted values,
  which the ranks combine in f32 (a MAX all_reduce, then one SUM of the
  rescaled sums and values).  The new
  position's K/V is written only by the rank that holds its slot; a local
  layer's ring of ``window`` slots is split the same way;
* a KV-head split attends this rank's heads (with the query heads of each),
  and the outputs are gathered over heads -- unless the block's tensor-
  parallel plan splits the heads the same way, when the rank's own heads'
  output goes straight to its row-parallel ``wo``;
* a head_dim split sums the partial scores over the ranks (in f32) and
  gathers the outputs over head_dim.

The recurrent states (the SSM's, the mLSTM's and the sLSTM's) are read in
the layout the block's step computes in (:func:`step_spec`): where that is
the cache's own -- the SSM's and the mLSTM's conv tail and the SSM's state
over ``d_inner``, which the plan already splits -- in place, with no
collective; any other layout (the mLSTM's ``C`` and ``n`` over head_dim,
a batch-1 cache's ``data`` split) is gathered for the step and the rank's
block taken back after it.  ROADMAP.md lists these.

Every gather is an ``all_gather``; the combines are ``all_reduce``s.
Positions are plain Python integers, so no step reads a tensor on the host
(the dry-run traces it on fake tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshAxes", "ServeLayout", "relayout", "gather", "take", "write_kv", "attend_kv",
           "step_spec", "gather_many", "full_heads"]

Spec = Tuple[Optional[str], ...]
_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxes:
    """Each mesh axis's group, size and this rank's index on it."""

    groups: Mapping[str, object]
    sizes: Mapping[str, int]
    index: Mapping[str, int]

    def part(self, axis: str, n: int) -> slice:
        k = n // self.sizes[axis]
        return slice(self.index[axis] * k, (self.index[axis] + 1) * k)


@dataclasses.dataclass(frozen=True, eq=False)
class ServeLayout:
    """The mesh's axes and, per cache key (``l{i}_{kind}``), the cache's
    structure with each leaf's per-group spec in place of the tensor."""

    axes: MeshAxes
    specs: Mapping[str, object]
    rows: bool = False  # each data rank computes its own rows of the batch


def gather(t: torch.Tensor, dim: int, axis: str, axes: MeshAxes) -> torch.Tensor:
    """The whole of ``t`` along ``dim`` from the blocks the ranks of
    ``axis`` hold."""
    n = axes.sizes[axis]
    if n == 1:
        return t
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=axes.groups[axis])
    return torch.cat(parts, dim=dim)


def take(t: torch.Tensor, dim: int, axis: str, axes: MeshAxes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axis``."""
    part = axes.part(axis, t.shape[dim])
    return t.narrow(dim, part.start, part.stop - part.start)


def relayout(t: torch.Tensor, src: Spec, dst: Spec, axes: MeshAxes) -> torch.Tensor:
    """``t`` laid out as ``src`` -> laid out as ``dst`` (per dim: a mesh
    axis or None)."""
    for d, (a, b) in enumerate(zip(src, dst)):
        if a is not None and a != b:
            t = gather(t, d, a, axes)
    for d, (a, b) in enumerate(zip(src, dst)):
        if b is not None and a != b:
            t = take(t, d, b, axes)
    return t


def step_spec(spec: Spec, split_dim: Optional[int], rows: bool) -> Spec:
    """The layout a recurrent block's step computes a state leaf in: the
    rank's rows (``rows``: over ``data``), whole otherwise but over
    ``model`` on ``split_dim`` (the dim the block's plan splits, or
    None)."""
    out = ["data" if rows else None] + [None] * (len(spec) - 1)
    if split_dim is not None:
        out[split_dim % len(spec)] = "model"
    return tuple(out)


def _runs(start: int, s_new: int, size: int, ring: bool):
    """(first source row, first slot, length) runs of the slots a write of
    ``s_new`` entries at absolute positions ``start``.. lands on (the
    arithmetic of ``attention.update_kv_cache``), and the rows kept."""
    if ring and s_new > size:
        start, lo_row, s_new = start + s_new - size, s_new - size, size
    else:
        lo_row = 0
    if not ring:
        if s_new > size:
            raise ValueError(f"a write of {s_new} entries does not fit a cache of {size}")
        return [(lo_row, min(max(start, 0), size - s_new), s_new)], start, lo_row, s_new
    runs, j = [], 0
    while j < s_new:
        slot = (start + j) % size
        n = min(s_new - j, size - slot)
        runs.append((lo_row + j, slot, n))
        j += n
    return runs, start, lo_row, s_new


def write_kv(cache, spec, k_new: torch.Tensor, v_new: torch.Tensor, start: int,
             axes: MeshAxes, heads_local: bool = False) -> None:
    """Write ``k_new``/``v_new`` (B, S_new, KV, Dh), every head (with
    ``heads_local``, this rank's block of a KV-head split), at absolute
    positions ``start``.. into the rank's block of ``cache`` (a KVCache
    whose k/v are laid out as ``spec.k``; ``pos`` whole on every rank), in
    place: each rank writes the slots it holds, its heads and head_dim."""
    k_spec = spec.k
    size = cache.pos.shape[0]
    runs, first, lo_row, s_new = _runs(start, k_new.shape[1], size, cache.ring)
    rows = (k_new, v_new)
    for d in (2, 3):
        if k_spec[d] is not None and not (d == 2 and heads_local):
            rows = tuple(take(t, d, k_spec[d], axes) for t in rows)
    s_ax = k_spec[1]
    mine = axes.part(s_ax, size) if s_ax is not None else slice(0, size)
    for row, slot, n in runs:
        cache.pos[slot:slot + n] = torch.arange(first + row - lo_row, first + row - lo_row + n,
                                                dtype=torch.int32, device=cache.pos.device)
        lo, hi = max(slot, mine.start), min(slot + n, mine.stop)
        if lo < hi:
            src = slice(row + lo - slot, row + hi - slot)
            cache.k[:, lo - mine.start:hi - mine.start] = rows[0][:, src]
            cache.v[:, lo - mine.start:hi - mine.start] = rows[1][:, src]


def attend_kv(q: torch.Tensor, cache, spec, q_positions: torch.Tensor, axes: MeshAxes, *,
              causal: bool = True, window: int = 0, attn_softcap: float = 0.0,
              heads_local: bool = False) -> torch.Tensor:
    """Decode attention of ``q`` (B, 1, Kh, G, Dh) over the rank's block of
    ``cache`` -> (B, 1, Kh, G, Dh), ``attention.attention``'s math split
    as the module docstring says.  ``heads_local``: ``q`` holds only this
    rank's kv heads' queries, the block of a KV-head split over ``model``
    that the caller's plan shares, and the output stays that block."""
    from repro_torch.models.layers import softcap

    s_ax, h_ax, d_ax = spec.k[1:4]
    kv_positions = cache.pos
    if s_ax is not None:
        kv_positions = take(kv_positions, 0, s_ax, axes)
    if h_ax is not None and not heads_local:
        q = take(q, 2, h_ax, axes)
    if d_ax is not None:
        q = take(q, 4, d_ax, axes)
    k, v = cache.k, cache.v
    dh = q.shape[-1] * (axes.sizes[d_ax] if d_ax is not None else 1)
    scale = 1.0 / (dh ** 0.5)
    if d_ax is None:
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    else:
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=axes.groups[d_ax])
        s = s * scale
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
    if s_ax is not None and axes.sizes[s_ax] > 1:
        group = axes.groups[s_ax]
        m_all = m.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
        c = torch.exp(m - m_all)
        both = torch.cat([pv * c, (l * c[..., 0])[..., None]], dim=-1)
        dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
        pv, l = both[..., :-1], both[..., -1]
    out = (pv / torch.clamp_min(l[..., None], 1e-30)).permute(0, 3, 1, 2, 4).to(q.dtype)
    if d_ax is not None:
        out = gather(out, 4, d_ax, axes)
    if h_ax is not None and not heads_local:
        out = gather(out, 2, h_ax, axes)
    return out


def gather_many(ts, dims, axis: str, axes: MeshAxes):
    """:func:`gather` of several tensors of one dtype (each along its dim
    of ``dims``) in one collective."""
    n = axes.sizes[axis]
    if n == 1:
        return list(ts)
    flat = torch.cat([t.reshape(-1) for t in ts])
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=axes.groups[axis])
    out, at = [], 0
    for t, d in zip(ts, dims):
        out.append(torch.cat([p[at:at + t.numel()].view(t.shape) for p in parts], dim=d))
        at += t.numel()
    return out


def full_heads(tp, kv_heads: int, axes: MeshAxes, q=None, k=None, v=None):
    """A block's projections under a plan that splits its heads -- q
    (B,S,Kh_l,G,Dh), or where the kv heads are not split (B,S,H_l,1,Dh)
    with k/v the kv head of each local query head -- -> every head's, q
    (B,S,Kh,G,Dh) and k/v (B,S,Kh,Dh), gathered over ``model`` in one
    collective; the ones given, in order."""
    given = [t for t in (q, k, v) if t is not None]
    full = gather_many(given, [2] * len(given), "model", axes)
    out = []
    for name, t in zip([n for n, t in (("q", q), ("k", k), ("v", v)) if t is not None], full):
        if not tp.kv_heads:
            if name == "q":
                b, s, h, _, dh = t.shape
                t = t.reshape(b, s, kv_heads, h // kv_heads, dh)
            else:
                t = t[:, :, ::t.shape[2] // kv_heads]
        out.append(t)
    return out
