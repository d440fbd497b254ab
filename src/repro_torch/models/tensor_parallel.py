"""Tensor parallelism over the mesh's ``model`` axis for the dense decoder
kinds (``attn_mlp``, ``attn_local_mlp``): column- and row-parallel
projections with explicit collectives, in the Megatron style.

Each rank of the ``model`` group holds the leaves' model-local blocks (the
rules of ``models/sharding.py``: heads, kv heads, ff and vocab over
``model``) and computes on plain tensors; the replicated stream between
blocks is bitwise the same on every rank.  Two autograd functions carry
the collectives:

* ``copy`` -- identity forward, SUM all_reduce of the gradient backward:
  where a replicated activation (or a replicated leaf, such as a ``wk``
  whose kv heads the model axis does not divide) enters a parallel region,
  whose ranks each see part of its gradient;
* ``reduce`` -- SUM all_reduce forward (in f32, cast back), identity
  backward: where a row-parallel product's partial sums leave the region.

Which blocks are parallel is the rules' verdict on this config, read once
from its specs (:func:`plan`): attention when ``model`` divides the heads
(the kv heads follow when it divides them too, else every rank gathers the
kv heads its query heads need), the MLP when it divides ``ff``, the
embedding and the logits when it divides the padded vocab (a masked lookup
summed over ranks; a vocab-parallel cross-entropy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["TensorParallel", "plan", "TP_KINDS"]

# the layer kinds whose leaves may be sharded over a model axis larger than 1
TP_KINDS = ("attn_mlp", "attn_local_mlp")


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group, accumulated in f32, in ``x``'s dtype."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place in the ``model`` group and which blocks are split."""

    group: object
    size: int
    rank: int
    heads: bool  # wq / wo (and bq) over heads
    kv_heads: bool  # wk / wv (and bk / bv) over kv heads
    ff: bool  # up / gate / down over ff
    vocab: bool  # the table (and an untied head) over the padded vocab

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """MAX over the group, outside autograd."""
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y


def plan(pspecs, group, size: int, rank: int) -> Optional[TensorParallel]:
    """The split of a model whose leaves resolve to ``pspecs`` (path ->
    spec) on a ``model`` axis of ``size``; None when nothing is split."""
    if size <= 1:
        return None

    def split(suffix: str) -> bool:
        return any(p.endswith(suffix) and "model" in s for p, s in pspecs.items())

    tp = TensorParallel(group, size, rank, heads=split(".attn.wq"), kv_heads=split(".attn.wk"),
                        ff=split(".mlp.up"), vocab=split("embed.table"))
    return tp if tp.heads or tp.ff or tp.vocab else None
