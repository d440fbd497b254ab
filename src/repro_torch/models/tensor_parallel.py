"""Tensor parallelism over the mesh's ``model`` axis, for every layer kind:
column- and row-parallel projections with explicit collectives, in the
Megatron style.

Each rank of the ``model`` group holds the leaves' model-local blocks (the
rules of ``models/sharding.py``) and computes on plain tensors; inside a
group of layers the stream is replicated, bitwise the same on every rank.
Two autograd functions carry most of the collectives:

* ``copy`` -- identity forward, SUM all_reduce of the gradient backward:
  where a replicated activation (or a replicated leaf, such as a ``wk``
  whose kv heads the model axis does not divide) enters a parallel region,
  whose ranks each see part of its gradient;
* ``reduce`` -- SUM all_reduce forward (in f32, cast back), identity
  backward: where a row-parallel product's partial sums leave the region.

Two more serve the kinds whose blocks are not split the way their math
runs: ``gather`` (a leaf's blocks joined along one dim, forward; this
rank's block of the gradient, backward -- for a leaf that a replicated
computation uses whole, so its gradient is the same on every rank) and
``halves`` (the ``[x | z]`` trap of the SSM's and the mLSTM's ``in_proj``,
below).  Every collective is a SUM all_reduce, which every backend carries
on every device (gloo's CUDA tensors included).

Between groups the stream is sequence-parallel (Megatron-SP at group
granularity, the reference's ``_constrain_stream``): where the model axis
divides the sequence, ``scatter`` keeps this rank's ``1/size`` of the
sequence dim after the embedding and at each group's exit, and ``gather``
joins it whole at each group's entry, so a checkpointed group stores only
its rank's shard of its input (``Plan.stream``, ``LM._sequence_parallel``).
The join is ``gather``'s SUM of zero-placed blocks: exact, but the
collective is handed ``size`` times the shard an all_gather would take.

The plan is per block (:func:`plan`): each block of leaves -- a layer's
``attn``, ``cross``, ``mlp``, ``moe``, ``ssm`` or ``cell``, the encoder's
``attn`` and ``mlp``, ``embed`` -- is split along its role's axis when the
rules shard every leaf on that axis over ``model``, and computes whole on
every rank otherwise, as does any block the rules leave replicated.  A
leaf the rules shard over ``model`` on an axis its block does not split
along is gathered whole at use (``TensorParallel.whole``).

* attention (self, cross, the encoder's): ``heads`` when ``model`` divides
  the heads (``wq``, ``wo``, ``bq``); the kv heads follow when it divides
  them too, else every rank gathers the kv heads its query heads need.  A
  cross block ``copy``s the memory where it enters, so the encoder's
  output gets its gradient summed over the ranks.
* MLP (and the sLSTM's FFN): ``ff``, column-parallel ``up``/``gate``, row-
  parallel ``down``.
* MoE: ``experts`` (expert-parallel: each rank runs its experts on their
  own slots and combines over them, and the partial sums are reduced: the
  reference's all-to-all is local work, since the stream is replicated and
  every rank can route every token) or ``ff`` (each expert column- and
  row-parallel inside).  Either way the routing runs whole on every rank
  and the groups and the combine weights are ``copy``'d where they enter
  the experts.  A router sharded over experts is gathered whole at use
  (``TensorParallel.whole``): its leaf is ``d x E`` where the logits are
  ``tokens x E``, and routing from the whole leaf gives every rank the
  unsplit model's logits bit for bit -- softmax, top-k, capacity and aux
  loss need every column.
* SSM and mLSTM: ``inner``, this rank's channels of ``d_inner``.  Their
  ``in_proj`` is ``(d, 2 * d_inner)``, the ``[x | z]`` halves side by side,
  and the rules split the ``2 * d_inner`` columns as one axis, so a rank's
  block is not its channels' ``x`` and ``z`` (at ``model`` 2, rank 0 holds
  all of ``x`` and rank 1 all of ``z``).  ``halves`` re-lays the local
  product with one exchange: it gives this rank the columns of its channels
  in each half (backward: the mirror exchange).  The conv and the SSM's scan
  run per channel; the products that contract the channels (the SSM's
  ``x_proj``, the mLSTM's ``wq``..``w_o``) are reduced, the mLSTM cell runs
  whole on every rank, and ``out_proj``/``down`` are row-parallel.
* embedding and head: ``vocab``, a masked lookup summed over ranks and a
  vocab-parallel cross-entropy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["TensorParallel", "Plan", "plan"]

# block name -> the logical axes it computes split along, in the order a
# split takes them (a block whose axes are all whole computes unsplit)
_ROLE_AXES = {"attn": ("heads", "kv_heads"), "cross": ("heads", "kv_heads"),
              "mlp": ("ff",), "moe": ("experts", "ff"), "ssm": ("ssm_inner",),
              "embed": ("vocab",)}
# a recurrent cell's block: the mLSTM's inner channels, the sLSTM's FFN
_CELL_AXES = {"mlstm": ("xlstm_inner",), "slstm": ("ff",)}
_FLAG = {"heads": "heads", "kv_heads": "kv_heads", "ff": "ff", "experts": "experts",
         "ssm_inner": "inner", "xlstm_inner": "inner", "vocab": "vocab"}


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group, accumulated in f32, in ``x``'s dtype."""
    y = x.float().contiguous()
    if y is x:
        y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


def _placed(x: torch.Tensor, dim: int, n: int, spans) -> torch.Tensor:
    """A zero tensor of ``x``'s shape with ``dim`` ``n`` long, holding
    ``x``'s consecutive pieces at ``spans`` (slices) along ``dim``."""
    shape = list(x.shape)
    shape[dim] = n
    out = x.new_zeros(shape)
    at = 0
    for span in spans:
        width = span.stop - span.start
        out.narrow(dim, span.start, width).copy_(x.narrow(dim, at, width))
        at += width
    return out


def _taken(x: torch.Tensor, dim: int, spans) -> torch.Tensor:
    return torch.cat([x.narrow(dim, s.start, s.stop - s.start) for s in spans], dim=dim)


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


class _Gather(torch.autograd.Function):
    """This rank's block placed at ``spans`` of a zero tensor, summed over
    the group (the whole tensor); backward: the gradient at ``spans``."""

    @staticmethod
    def forward(ctx, x, group, dim, n, spans):
        ctx.dim, ctx.spans = dim, spans
        return _all_reduce(_placed(x, dim, n, spans), group)

    @staticmethod
    def backward(ctx, g):
        return _taken(g, ctx.dim, ctx.spans), None, None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's block at ``spans`` of a tensor every rank holds whole
    and the same, in its own storage; backward: the ranks' blocks of the
    gradient joined (the whole gradient on every rank, as the replicated
    computation before it expects)."""

    @staticmethod
    def forward(ctx, x, group, dim, spans):
        ctx.group, ctx.dim, ctx.n, ctx.spans = group, dim, x.shape[dim], spans
        return _taken(x, dim, spans)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(_placed(g, ctx.dim, ctx.n, ctx.spans), ctx.group), None, None, None


class _Relay(torch.autograd.Function):
    """Columns at ``have`` (this rank's block) in, columns at ``want`` out,
    over one SUM exchange each way."""

    @staticmethod
    def forward(ctx, x, group, n, have, want):
        ctx.group, ctx.n, ctx.have, ctx.want = group, n, have, want
        return _taken(_all_reduce(_placed(x, -1, n, have), group), -1, want)

    @staticmethod
    def backward(ctx, g):
        full = _all_reduce(_placed(g, -1, ctx.n, ctx.want), ctx.group)
        return _taken(full, -1, ctx.have), None, None, None, None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place in the ``model`` group and how one block splits:
    which of its role's axes it computes split along, and which leaves it
    gathers whole at use (leaf -> dim of the per-group leaf)."""

    group: object
    size: int
    rank: int
    heads: bool = False  # wq / wo (and bq) over heads
    kv_heads: bool = False  # wk / wv (and bk / bv) over kv heads
    ff: bool = False  # up / gate / down over ff (an MLP's, the experts', the sLSTM's FFN)
    vocab: bool = False  # the table (and an untied head) over the padded vocab
    experts: bool = False  # the MoE's up / gate / down over experts
    inner: bool = False  # the SSM's / mLSTM's leaves over d_inner
    whole: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @property
    def split(self) -> bool:
        return self.heads or self.ff or self.vocab or self.experts or self.inner

    def part(self, n: int) -> slice:
        """This rank's span of an axis ``n`` long, split evenly."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """MAX over the group, outside autograd."""
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's block along ``dim``; backward
        takes this rank's block of a gradient that a replicated computation
        made the same on every rank.

        On the sequence-parallel stream (a group's entry) that holds because
        the group's layers use the gathered stream in replicated computations
        only: the residual adds and norms run whole on every rank, and every
        split block takes its input through ``copy``, whose backward sums the
        ranks' parts of the gradient, and returns ``reduce``'s whole output.
        So the gradient with respect to the gathered stream is the same on
        every rank, and this rank's block of it is its shard's gradient."""
        dim %= x.dim()
        n = x.shape[dim] * self.size
        return _Gather.apply(x, self.group, dim, n, (self.part(n),))

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of ``x``, which every rank holds
        whole and the same (the inverse of :meth:`gather`); backward joins
        the ranks' blocks of the gradient."""
        dim %= x.dim()
        return _Scatter.apply(x, self.group, dim, (self.part(x.shape[dim]),))

    def halves(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` this rank's block of the last axis of ``[x | z]`` (two
        halves of ``n`` columns, the ``2n`` split contiguously over the
        ranks) -> this rank's span of each half, ``[x_r | z_r]``."""
        n2 = y.shape[-1] * self.size
        n = n2 // 2
        mine = self.part(n)
        want = (mine, slice(n + mine.start, n + mine.stop))
        return _Relay.apply(y, self.group, n2, (self.part(n2),), want)

    def use(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``leaves`` (one group's) with the ``whole`` ones gathered."""
        return {k: self.gather(v, self.whole[k]) if k in self.whole else v
                for k, v in leaves.items()}


class Plan:
    """Block path -> its :class:`TensorParallel` (None: the block computes
    whole and uses its leaves as they are); ``stream``: the ``model``
    group's place, over which the stream between groups is scattered and
    gathered."""

    def __init__(self, blocks: Mapping[str, TensorParallel], stream: TensorParallel):
        self.blocks = dict(blocks)
        self.stream = stream

    def __call__(self, block: str) -> Optional[TensorParallel]:
        return self.blocks.get(block)

    def splits(self, path: str) -> bool:
        """Whether the block holding leaf ``path`` computes split."""
        tp = self.blocks.get(path.rpartition(".")[0])
        return tp is not None and tp.split


def _role_axes(block: str) -> Tuple[str, ...]:
    """The logical axes block ``block`` computes split along."""
    parts = block.split(".")
    if parts[-1] == "cell":
        return _CELL_AXES[parts[1].split("_", 1)[1]]
    return _ROLE_AXES.get(parts[-1], ())


def plan(pspecs, specs, group, size: int, rank: int) -> Optional[Plan]:
    """The split of a model whose leaves (``specs``: path -> ParamSpec)
    resolve to ``pspecs`` (path -> spec) on a ``model`` axis of ``size``;
    None when the axis is 1.  Needs no process group to be read."""
    if size <= 1:
        return None
    by_block: Dict[str, Dict[str, Tuple[Optional[str], int]]] = {}
    for path, spec in pspecs.items():
        block, _, leaf = path.rpartition(".")
        logical = specs[path].logical_axes
        # the per-group leaf: a stacked block drops its leading layers axis
        stacked = logical[:1] == ("layers",)
        at = spec.index("model") if "model" in spec else None
        by_block.setdefault(block, {})[leaf] = (
            None if at is None else logical[at], None if at is None else at - stacked)
    blocks = {}
    for block, leaves in by_block.items():
        role = _role_axes(block)
        split = {}
        for axis in role:
            users = [(leaf, on) for leaf, (on, _) in leaves.items()
                     if axis in specs[f"{block}.{leaf}"].logical_axes and leaf != "router"]
            # an axis splits when the model axis shards every leaf on it, and
            # only one axis of a block: the experts (or ff) of an MoE; the kv
            # heads beside the heads
            ok = bool(users) and all(on == axis for _, on in users)
            if axis == "kv_heads":
                ok = ok and split.get("heads", False)
            elif axis == "ff" and block.endswith(".moe"):
                ok = ok and not split.get("experts", False)
            split[axis] = ok
        taken = {a for a, ok in split.items() if ok}
        whole = {leaf: dim for leaf, (on, dim) in leaves.items()
                 if on is not None and (on not in taken or leaf == "router")}
        flags = {_FLAG[a]: True for a in taken}
        if flags or whole:
            blocks[block] = TensorParallel(group, size, rank, whole=whole, **flags)
    return Plan(blocks, TensorParallel(group, size, rank))
