"""The language model (port of ``repro.models.transformer.LM``, every
layer kind: ``forward``, ``loss`` and ``_chunked_ce`` for training,
``encode`` for an enc-dec arch, and ``init_caches``, ``prefill`` and
``decode_step`` for serving).

Layer kinds: ``attn_mlp`` and ``attn_local_mlp`` (dense; the local ones
windowed), ``attn_moe`` and ``attn_local_moe`` (mixture of experts, whose
aux losses are summed over the stack and divided by ``n_layers``),
``hybrid`` (hymba: attention and an SSM mixer side by side, each output
normed, averaged), ``mlstm`` and ``slstm`` (xlstm's cells),
``cross_attn_mlp`` and ``cross_attn_moe`` (llama-vision's image layers: a
cross block over the memory scaled by ``tanh(cross_gate)``, which starts at
zero, and no self attention) and ``dec_cross_mlp`` (an enc-dec decoder
layer: self attention, then cross attention over the encoder's output);
attention with or without the QKV bias (never on a cross block).  The
memory is the frontend's embeddings cast to bf16, or for an enc-dec arch
the encoder's output over them (``frontend_memory``): a stack of
bidirectional self-attention layers with rope, ``encoder.*``, and
``encoder_norm``.

Under the sharded ``pjit`` step the LM runs with a tensor-parallel plan
(``models/tensor_parallel.py``): each block -- a layer's ``attn``,
``cross``, ``mlp``, ``moe``, ``ssm`` or ``cell``, the encoder's ``attn``
and ``mlp``, ``embed`` -- computes split over the ``model`` axis or whole,
as the rules place its leaves, and the leaves it uses whole but holds a
block of are gathered at use.  Between groups the stream is
sequence-parallel where the model axis divides the sequence (the
reference's ``_constrain_stream``: ``S % size == 0 and S > 1``): each
rank carries its ``1/size`` of the sequence, scattered after the
embedding and at each group's exit and gathered whole at each group's
entry, inside the checkpointed function, so ``remat`` stores a rank's
shard of each group's input; it is gathered again before the final norm
and the head.  The encoder does the same per layer, and its output is
gathered whole before it becomes the memory.  The values are those of the
replicated stream, bit for bit: only data moves, by exact joins.
``prefill`` and ``decode_step`` run with no plan.

``cfg.remat`` is honoured as the reference's ``jax.checkpoint``: under
``"full"`` and ``"dots"`` each group of the stack (and each encoder layer)
runs under ``torch.utils.checkpoint`` when autograd records, ``"dots"``
keeping the weight products; backward recomputes the rest.  It changes no
number: loss and gradients are bitwise ``remat="none"``'s.

The parameter layout is the reference's tree, one ``nn.Parameter`` per leaf:
``embed.table`` (and, with ``tie_embeddings=False``, the output head
``embed.head`` of shape ``(d_model, padded_vocab)``, which the logits use
in place of the table's transpose), ``final_norm.scale`` and, for the
repeating group of layer kinds, ``layers.l{i}_{kind}.*`` with a leading
stacked ``(n_groups, ...)`` axis (the reference's ``_stack_spec``); the
forward pass indexes ``p[g]`` per group.  ``named_parameters()`` therefore
yields the reference's leaf paths, ``reducers.flatten_tree`` yields the
reference's flat vector in the same order, and ``convert.params_from_jax``
is a rename.  A leaf is drawn as the reference's ``init_params`` draws its
kind: zeros, ones (whatever the scale), or a normal times its scale (0.02,
and 0.02/sqrt(d) for a router), the bits from the caller's
``torch.Generator``.

The caches keep the reference's structure too: per layer kind
``l{i}_{kind}`` a :class:`KVCache` (a cross block's holds the memory's K/V,
as long as the memory), a ``(KVCache, SSMState)`` pair for ``hybrid``, a
``(self, cross)`` pair of them for ``dec_cross_mlp``, an
:class:`MLSTMState` or an :class:`SLSTMState`, every leaf with a leading
``(n_groups,)`` axis, so ``convert.caches_from_jax`` is a rename.
``prefill`` and ``decode_step`` run without autograd and write the caches
in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as A
from repro_torch.models import cache_sharding as CS
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.layers import (COMPUTE_DTYPE, embed, mlp, padded_vocab, rmsnorm,
                                       softcap, unembed)
from repro_torch.models.sharding import ParamSpec

__all__ = ["LM", "param_shapes", "param_specs", "init_caches", "CROSS_KINDS"]

Caches = Dict[str, object]

# the kinds whose layers attend to the memory (a frontend's or the encoder's)
CROSS_KINDS = ("cross_attn_mlp", "cross_attn_moe", "dec_cross_mlp")


def _norm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def _attn_shapes(cfg, cross: bool = False) -> Dict[str, ParamSpec]:
    """A self (or, with ``cross``, a cross) attention block's leaves; a
    cross block has no QKV bias (the reference's ``attention_spec``)."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {"wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
            "wk": ParamSpec((d, kh, dh), ("embed", "kv_heads", "head_dim")),
            "wv": ParamSpec((d, kh, dh), ("embed", "kv_heads", "head_dim")),
            "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed"))}
    if cfg.qkv_bias and not cross:
        spec.update(bq=ParamSpec((h, dh), ("heads", "head_dim"), init="zeros"),
                    bk=ParamSpec((kh, dh), ("kv_heads", "head_dim"), init="zeros"),
                    bv=ParamSpec((kh, dh), ("kv_heads", "head_dim"), init="zeros"))
    return spec


def _mlp_shapes(cfg) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    spec = {"up": ParamSpec((d, f), ("embed", "ff")), "down": ParamSpec((f, d), ("ff", "embed"))}
    if cfg.mlp_activation in ("swiglu", "geglu"):
        spec["gate"] = ParamSpec((d, f), ("embed", "ff"))
    return spec


def _layer_shapes(cfg, kind: str) -> Dict[str, ParamSpec]:
    """Leaf -> ParamSpec of one layer of ``kind`` (the reference's
    ``_layer_spec``)."""
    if kind not in ("mlstm", "slstm", "hybrid", "dec_cross_mlp") and not (
            kind.startswith(("attn", "cross_attn")) and kind.endswith(("mlp", "moe"))):
        raise ValueError(f"unknown layer kind {kind!r}")
    d = cfg.d_model
    parts = [("norm1", _norm_spec(d))]
    if kind in ("mlstm", "slstm"):
        parts.append(("cell", X.mlstm_shapes(cfg) if kind == "mlstm" else X.slstm_shapes(cfg)))
    else:
        if kind.startswith("attn") or kind in ("hybrid", "dec_cross_mlp"):
            parts.append(("attn", _attn_shapes(cfg)))
        if kind in CROSS_KINDS:
            parts.append(("cross", _attn_shapes(cfg, cross=True)))
        if kind.startswith("cross_attn"):
            parts.append(("cross_gate", ParamSpec((1,), (None,), init="zeros")))
        if kind == "dec_cross_mlp":
            parts.append(("norm_cross", _norm_spec(d)))
        if kind == "hybrid":
            parts += [("ssm", S.ssm_shapes(cfg)), ("norm_attn_out", _norm_spec(d)),
                      ("norm_ssm_out", _norm_spec(d))]
        elif kind.endswith("moe"):
            parts += [("norm2", _norm_spec(d)), ("moe", M.moe_shapes(cfg))]
        elif kind.endswith("mlp"):
            parts += [("norm2", _norm_spec(d)), ("mlp", _mlp_shapes(cfg))]
    out = {}
    for part, leaves in parts:
        if isinstance(leaves, dict):
            out.update({f"{part}.{leaf}": v for leaf, v in leaves.items()})
        else:
            out[part] = leaves
    return out


def _encoder_shapes(cfg) -> Dict[str, ParamSpec]:
    """One encoder layer's leaves: pre-norm self attention and MLP."""
    d = cfg.d_model
    parts = [("norm1", _norm_spec(d)), ("attn", _attn_shapes(cfg)),
             ("norm2", _norm_spec(d)), ("mlp", _mlp_shapes(cfg))]
    return {f"{part}.{leaf}": v for part, leaves in parts for leaf, v in leaves.items()}


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Leaf path -> shape, for the whole model."""
    return {k: s.shape for k, s in param_specs(cfg).items()}


def _stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """``spec`` with a leading stacked ``"layers"`` axis of ``n``."""
    return ParamSpec((n,) + spec.shape, ("layers",) + spec.logical_axes, spec.init, spec.scale)


def param_specs(cfg) -> Dict[str, ParamSpec]:
    """Leaf path -> ParamSpec for the whole model, from the shape tables
    alone (no allocation): the reference's ``LM.spec()`` flattened to the
    port's dotted leaf paths."""
    vp = padded_vocab(cfg.vocab_size)
    spec = {"embed.table": ParamSpec((vp, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        spec["embed.head"] = ParamSpec((cfg.d_model, vp), ("embed", "vocab"))
    spec["final_norm.scale"] = _norm_spec(cfg.d_model)["scale"]
    n = cfg.n_groups()
    for i, kind in enumerate(cfg.layer_pattern()):
        for name, leaf in _layer_shapes(cfg, kind).items():
            spec[f"layers.l{i}_{kind}.{name}"] = _stacked(leaf, n)
    if cfg.n_encoder_layers:
        for name, leaf in _encoder_shapes(cfg).items():
            spec[f"encoder.{name}"] = _stacked(leaf, cfg.n_encoder_layers)
        spec["encoder_norm.scale"] = _norm_spec(cfg.d_model)["scale"]
    return spec


def _attn_window(cfg, kind: str) -> int:
    return cfg.sliding_window if "local" in kind else 0


def _cross_cache(cfg, batch: int, length: int, dtype, device) -> A.KVCache:
    """A cross block's cache: the memory's K/V at every slot, position i
    at slot i."""
    kv = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return A.KVCache(k=torch.zeros(kv, dtype=dtype, device=device),
                     v=torch.zeros(kv, dtype=dtype, device=device),
                     pos=torch.arange(length, dtype=torch.int32, device=device), ring=False)


def _init_layer_cache(kind: str, cfg, batch: int, max_seq: int, dtype, device,
                      memory_len: Optional[int] = None):
    """One layer's empty cache (the reference's ``_init_layer_cache``); a
    cross block's is ``memory_len`` long, by default ``n_frontend_tokens``
    or ``max_seq`` as the reference's."""
    if kind == "mlstm":
        return X.init_mlstm_state(batch, cfg, dtype, device)
    if kind == "slstm":
        return X.init_slstm_state(batch, cfg, dtype, device)
    if kind in CROSS_KINDS:
        cross = _cross_cache(cfg, batch, memory_len or cfg.n_frontend_tokens or max_seq, dtype,
                             device)
        if kind != "dec_cross_mlp":
            return cross
    kv = A.init_kv_cache(batch, max_seq, cfg.n_kv_heads, cfg.head_dim,
                         window=_attn_window(cfg, kind), dtype=dtype, device=device)
    if kind == "dec_cross_mlp":
        return kv, cross
    return (kv, S.init_ssm_state(batch, cfg, dtype, device)) if kind == "hybrid" else kv


def _map_cache(fn, cache):
    """``cache`` with ``fn`` applied to every tensor leaf (a pair is mapped
    member by member; KVCache's ``ring`` flag is kept)."""
    if isinstance(cache, tuple):
        return tuple(_map_cache(fn, c) for c in cache)
    return type(cache)(**{f.name: fn(v) if isinstance(v, torch.Tensor) else v
                          for f in dataclasses.fields(cache)
                          for v in (getattr(cache, f.name),)})


def _group_cache(cache, g: int):
    """Group ``g``'s view of a stacked cache (writes land in the stack)."""
    return _map_cache(lambda t: t[g], cache)


def _map_fields(fn, state):
    """A recurrent state with ``fn(field name, tensor)`` applied to each
    leaf."""
    return type(state)(**{f.name: fn(f.name, getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def _write_state(view, new) -> None:
    """Copy a recurrent state's new leaves into its cache view."""
    for f in dataclasses.fields(view):
        getattr(view, f.name).copy_(getattr(new, f.name))


class _Node(nn.ModuleDict):
    """A ModuleDict that also holds parameter leaves (a cross layer's
    ``cross_gate`` beside its blocks), read by ``node[name]`` alike."""

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or super().__contains__(key)


def _container(leaves):
    """Nested ModuleDict / ParameterDict mirroring the tree of ``leaves``."""
    children = {}
    for parts, param in leaves:
        children.setdefault(parts[0], []).append((parts[1:], param))
    is_leaf = {k: len(v) == 1 and not v[0][0] for k, v in children.items()}
    if all(is_leaf.values()):
        return nn.ParameterDict({k: v[0][1] for k, v in children.items()})
    if not any(is_leaf.values()):
        return nn.ModuleDict({k: _container(v) for k, v in children.items()})
    node = _Node()
    for k, v in children.items():
        if is_leaf[k]:
            node.register_parameter(k, v[0][1])
        else:
            node[k] = _container(v)
    return node


def _save_weight_products(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy (the reference's
    ``dots_with_no_batch_dims_saveable``): keep the products of an
    activation with a weight, recompute everything else.  ``x @ W`` reaches
    ATen as ``mm`` and an einsum against a weight as a ``bmm`` of one batch;
    attention's and the experts' products are ``bmm``s over batch, head or
    expert, and are recomputed (a batch of one head and one row would count
    as a weight product: memory only, no value changes)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, *args, policy: str = "full"):
    """``fn(*args)`` under activation checkpointing: ``"full"`` keeps only
    its inputs, ``"dots"`` also the weight products; backward recomputes the
    rest, the same ops on the same inputs, so no value changes."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_weight_products))
    return checkpoint(fn, *args, use_reentrant=False)


def init_caches(cfg, batch: int, max_seq: int, *, dtype=None,
                memory_len: Optional[int] = None, device=None) -> Caches:
    """:meth:`LM.init_caches` of a config (``dtype`` None: the compute
    dtype), on ``device`` (``"meta"``, or under a ``FakeTensorMode`` any
    device, allocates nothing)."""
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    n = cfg.n_groups()
    return {f"l{i}_{kind}": _map_cache(lambda t: t[None].expand((n,) + t.shape).clone(),
                                       _init_layer_cache(kind, cfg, batch, max_seq, dtype,
                                                         device, memory_len))
            for i, kind in enumerate(cfg.layer_pattern())}


class LM(nn.Module):
    """An LM over a repeating group of layer kinds: decoder-only, or with a
    frontend's memory (a vision arch's patches) or an encoder's (enc-dec)
    that the cross kinds attend to."""

    def __init__(self, cfg, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.pattern = cfg.layer_pattern()
        self.n_groups = cfg.n_groups()
        leaves = []
        for path, spec in param_specs(cfg).items():
            if spec.init == "zeros":
                t = torch.zeros(spec.shape, dtype=torch.float32, device=device)
            elif spec.init == "ones":
                t = torch.ones(spec.shape, dtype=torch.float32, device=device)
            else:
                t = torch.empty(spec.shape, dtype=torch.float32, device=device)
                t.normal_(0.0, 0.02 if spec.scale is None else spec.scale, generator=generator)
            leaves.append((tuple(path.split(".")), nn.Parameter(t)))
        root = _container(leaves)
        for name, child in root.items():
            self.add_module(name, child)
        # tensor parallelism over the model axis (a models/tensor_parallel.py
        # Plan): set by the sharded train step around its loss and by the
        # sharded serving engine around its steps, None otherwise
        self._tp = None
        # the caches' placement on the mesh (a cache_sharding.ServeLayout):
        # set by the sharded serving engine around its steps, None otherwise
        self._serve = None

    def spec(self) -> Dict[str, ParamSpec]:
        """Leaf path -> ParamSpec (shape, logical axes, init)."""
        return param_specs(self.cfg)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Leaf path -> parameter, as a flat mapping."""
        return dict(self.named_parameters())

    def _split(self, block: str):
        """Block ``block``'s TensorParallel under the plan, or None."""
        return None if self._tp is None else self._tp(block)

    def _leaves(self, block: str, node, index: int) -> Dict[str, torch.Tensor]:
        """Block ``block``'s leaves (``node``) at stack index ``index``, the
        ones its plan uses whole gathered."""
        leaves = {k: v[index] for k, v in node.items()}
        tp = self._split(block)
        return leaves if tp is None else tp.use(leaves)

    def _sequence_parallel(self, s: int):
        """The ``model`` group's place when the stream between groups is
        sharded over it on a sequence ``s`` long (the reference's
        ``_constrain_stream`` condition), else None."""
        tp = None if self._tp is None else self._tp.stream
        return tp if tp is not None and s % tp.size == 0 and s > 1 else None

    def _remat(self) -> bool:
        """Whether a pass checkpoints its groups: ``cfg.remat`` is not
        ``"none"`` and autograd records (never in prefill or decode)."""
        return self.cfg.remat != "none" and torch.is_grad_enabled()

    def _heads_local(self, tp, lay) -> bool:
        """Whether a sharded cache's kv heads are split over ``model`` as
        the block's plan splits them (each rank then attends its own)."""
        return tp is not None and tp.heads and tp.kv_heads and lay.k[2] == "model"

    def _full_heads(self, tp, lay, **qkv):
        """The given projections of every head where the plan splits the
        heads and the cache's are not split with them (one gather), else as
        they are."""
        if tp is None or not tp.heads or self._heads_local(tp, lay):
            return list(qkv.values())
        return CS.full_heads(tp, self.cfg.n_kv_heads, self._serve.axes, **qkv)

    def _attend_kv(self, q, cache, lay, q_positions, tp, **kw) -> torch.Tensor:
        """Decode attention over the rank's block of a sharded cache:
        ``q`` the queries of every head (or, where the cache's kv heads are
        the plan's, this rank's) -> the output of the block's heads."""
        local = self._heads_local(tp, lay)
        split = tp is not None and tp.heads and not local
        out = CS.attend_kv(q, cache, lay, q_positions, self._serve.axes, heads_local=local, **kw)
        if split:
            b, s, kh, g, dh = out.shape
            if tp.kv_heads:
                out = out[:, :, tp.part(kh)]
            else:
                out = out.reshape(b, s, kh * g, 1, dh)[:, :, tp.part(kh * g)]
        return out

    def _attention(self, pa, h, kind: str, positions: torch.Tensor,
                   cache: Optional[A.KVCache], decode_pos: Optional[int],
                   tp=None, lay=None) -> torch.Tensor:
        """Self attention.  Full sequence: over its own keys and, given a
        cache, writes them at position 0 (the reference's
        ``_self_attention_full``); with ``decode_pos``: one token at that
        position, written into the cache, attending over the whole cache
        (``_self_attention_decode``).  ``lay``: the cache is the rank's
        block of a sharded one, laid out so (``cache_sharding``)."""
        cfg = self.cfg
        q, k, v = A.project_qkv(pa, h, h, positions, positions, cfg.rope_theta, tp=tp)
        window = _attn_window(cfg, kind)
        if lay is not None:
            local = self._heads_local(tp, lay)
            if decode_pos is None:
                kf, vf = self._full_heads(tp, lay, k=k, v=v)
                CS.write_kv(cache, lay, kf, vf, 0, self._serve.axes, heads_local=local)
                cache = None  # the prefill attends over its own keys
            else:
                qf, kf, vf = self._full_heads(tp, lay, q=q, k=k, v=v)
                CS.write_kv(cache, lay, kf, vf, decode_pos, self._serve.axes, heads_local=local)
                return A.attend(pa, self._attend_kv(qf, cache, lay, positions, tp, window=window,
                                                    attn_softcap=cfg.attn_softcap), tp=tp)
        kv_positions = positions
        if cache is not None:
            A.update_kv_cache(cache, k, v, 0 if decode_pos is None else decode_pos)
            if decode_pos is not None:
                k, v, kv_positions = cache.k, cache.v, cache.pos
        out = A.attention(q, k, v, positions, kv_positions, window=window,
                          attn_softcap=cfg.attn_softcap)
        return A.attend(pa, out, tp=tp)

    def _cross_attention(self, pa, h, memory: Optional[torch.Tensor],
                         cache: Optional[A.KVCache], decode_pos: Optional[int],
                         tp=None, lay=None) -> torch.Tensor:
        """Cross attention over the memory (B,Sm,D): no mask but the empty
        slots', no rope, no softcap (the reference's ``_cross_attention``).
        A prefill writes the memory's K/V into ``cache``; a decode step
        reads them from it and projects its queries alone."""
        if decode_pos is not None:
            q = torch.einsum("bsd,dhk->bshk", h, pa["wq"].to(h.dtype))
            b, s, nh, dh = q.shape
            if lay is not None:
                kh = self.cfg.n_kv_heads
                if tp is not None and tp.heads:
                    kh = kh // tp.size if tp.kv_heads else nh
                q, = self._full_heads(tp, lay, q=q.reshape(b, s, kh, nh // kh, dh))
                out = self._attend_kv(q, cache, lay, torch.zeros(s, dtype=torch.long,
                                                                 device=q.device), tp,
                                      causal=False)
                return A.attend(pa, out, tp=tp)
            q = q.reshape(b, s, cache.k.shape[2], nh // cache.k.shape[2], dh)
            k, v, kv_positions = cache.k, cache.v, cache.pos
        else:
            if memory is None:
                raise ValueError(f"{self.cfg.name}: a cross-attention layer needs the memory "
                                 "(the batch's frontend)")
            q, k, v = A.project_qkv(pa, h, memory, tp=tp)
            kv_positions = torch.arange(k.shape[1], device=k.device)
            if cache is not None and lay is not None:
                kf, vf = self._full_heads(tp, lay, k=k, v=v)
                CS.write_kv(cache, lay, kf, vf, 0, self._serve.axes,
                            heads_local=self._heads_local(tp, lay))
            elif cache is not None:
                cache.k.copy_(k)
                cache.v.copy_(v)
        out = A.attention(q, k, v, torch.zeros(q.shape[1], dtype=torch.long, device=q.device),
                          kv_positions, causal=False)
        return A.attend(pa, out, tp=tp)

    def _layer(self, i: int, kind: str, g: int, x: torch.Tensor, positions: torch.Tensor,
               cache=None, decode_pos: Optional[int] = None,
               memory: Optional[torch.Tensor] = None):
        """Layer ``l{i}_{kind}`` of group ``g`` -> (x, MoE aux or None); a
        recurrent state in ``cache`` is overwritten with the final one."""
        cfg = self.cfg
        prefix = f"layers.l{i}_{kind}"
        p = self.layers[f"l{i}_{kind}"]

        def group(name):
            return self._leaves(f"{prefix}.{name}", p[name], g)

        def tp(name):
            return self._split(f"{prefix}.{name}")

        lay = None if self._serve is None or cache is None else self._serve.specs[f"l{i}_{kind}"]
        h = rmsnorm(p["norm1"]["scale"][g], x, cfg.norm_eps)
        if kind in ("mlstm", "slstm"):
            apply = X.mlstm_apply if kind == "mlstm" else X.slstm_apply
            t = tp("cell")
            split = {"conv": 2} if kind == "mlstm" and t is not None and t.inner else {}
            out, state = apply(group("cell"), h, cfg, self._state_in(cache, lay, split), tp=t)
            if cache is not None:
                _write_state(cache, self._state_out(state, lay, split))
            return x + out, None
        if kind == "hybrid":
            kv, ssm_state = (None, None) if cache is None else cache
            kv_lay, ssm_lay = (None, None) if lay is None else lay
            attn_out = self._attention(group("attn"), h, kind, positions, kv, decode_pos,
                                       tp("attn"), kv_lay)
            t = tp("ssm")
            split = {"conv": 2, "h": 1} if t is not None and t.inner else {}
            st = self._state_in(ssm_state, ssm_lay, split)
            if decode_pos is None:
                ssm_out, state = S.ssm_apply(group("ssm"), h, cfg, st, tp=t)
            else:
                ssm_out, state = S.ssm_decode_step(group("ssm"), h, cfg, st, tp=t)
            if cache is not None:
                _write_state(ssm_state, self._state_out(state, ssm_lay, split))
            x = x + 0.5 * (rmsnorm(p["norm_attn_out"]["scale"][g], attn_out, cfg.norm_eps)
                           + rmsnorm(p["norm_ssm_out"]["scale"][g], ssm_out, cfg.norm_eps))
            return x, None
        if kind == "dec_cross_mlp":
            self_cache, cross_cache = (None, None) if cache is None else cache
            self_lay, cross_lay = (None, None) if lay is None else lay
            x = x + self._attention(group("attn"), h, kind, positions, self_cache, decode_pos,
                                    tp("attn"), self_lay)
            hc = rmsnorm(p["norm_cross"]["scale"][g], x, cfg.norm_eps)
            x = x + self._cross_attention(group("cross"), hc, memory, cross_cache, decode_pos,
                                          tp("cross"), cross_lay)
        elif kind.startswith("cross_attn"):
            gate = torch.tanh(p["cross_gate"][g].float())[0]
            x = x + gate.to(x.dtype) * self._cross_attention(group("cross"), h, memory, cache,
                                                              decode_pos, tp("cross"), lay)
        else:
            x = x + self._attention(group("attn"), h, kind, positions, cache, decode_pos,
                                    tp("attn"), lay)
        h2 = rmsnorm(p["norm2"]["scale"][g], x, cfg.norm_eps)
        if "moe" in p:
            # a serving rank that holds its own rows routes every row's tokens,
            # so the groups and their capacity are the unsplit batch's
            rows = self._serve is not None and self._serve.rows
            h_in = CS.gather(h2, 0, "data", self._serve.axes) if rows else h2
            out, aux = M.moe_apply(group("moe"), h_in, cfg, tp=tp("moe"))
            if rows:
                out = CS.take(out, 0, "data", self._serve.axes)
            return x + out, aux
        return x + mlp(group("mlp"), h2, cfg.mlp_activation, tp=tp("mlp")), None

    def _state_in(self, state, lay, split):
        """A recurrent state as its block's step computes it: the rank's
        block of a sharded one (``lay``) moved to the step's layout (whole,
        but over ``model`` on the dims ``split`` names), else as it is."""
        if lay is None:
            return state
        serve = self._serve
        return _map_fields(lambda f, t: CS.relayout(t, getattr(lay, f), CS.step_spec(
            getattr(lay, f), split.get(f), serve.rows), serve.axes), state)

    def _state_out(self, state, lay, split):
        """The step's new state back to the rank's block of the cache."""
        if lay is None:
            return state
        serve = self._serve
        return _map_fields(lambda f, t: CS.relayout(t, CS.step_spec(
            getattr(lay, f), split.get(f), serve.rows), getattr(lay, f), serve.axes), state)

    def _head(self) -> Optional[torch.Tensor]:
        """The untied output head, or None when the table is tied."""
        return self.embed["head"] if "head" in self.embed else None

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden (B,S,D) -> softcapped f32 logits (B,S,V); under a
        plan that splits the vocab, each rank's columns gathered."""
        tp = self._split("embed")
        if tp is not None and tp.vocab:
            logits = tp.gather(unembed(self.embed["table"], x, head=self._head()), -1)
        else:
            logits = unembed(self.embed["table"], x, self.cfg.vocab_size, head=self._head())
        return softcap(logits[..., : self.cfg.vocab_size], self.cfg.final_softcap)

    def _group(self, g: int, x: torch.Tensor, aux: torch.Tensor, positions: torch.Tensor,
               memory: Optional[torch.Tensor], sp=None, caches: Optional[Caches] = None,
               decode_pos: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Group ``g``'s layers -> (x, aux plus their MoE aux).  Under
        sequence parallelism ``sp`` the stream comes and goes as this rank's
        sequence shard, gathered whole for the layers."""
        if sp is not None:
            x = sp.gather(x, 1)
        for i, kind in enumerate(self.pattern):
            cache = None if caches is None else _group_cache(caches[f"l{i}_{kind}"], g)
            x, a = self._layer(i, kind, g, x, positions, cache, decode_pos, memory)
            if a is not None:
                aux = aux + a
        return (x if sp is None else sp.scatter(x, 1)), aux

    def _stack(self, x: torch.Tensor, positions: torch.Tensor, caches: Optional[Caches] = None,
               decode_pos: Optional[int] = None,
               memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer of every group, then the final norm -> (x, the MoE
        layers' aux summed and divided by ``n_layers``).  Under ``remat``
        each group is checkpointed (the reference's ``jax.checkpoint`` of
        its scan body), with its sequence shard as input when the stream is
        sequence-parallel."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = caches is None and self._remat()
        sp = self._sequence_parallel(x.shape[1])
        if sp is not None:
            x = sp.scatter(x, 1)
        for g in range(self.n_groups):
            if remat:
                x, aux = _checkpointed(self._group, g, x, aux, positions, memory, sp,
                                       policy=self.cfg.remat)
            else:
                x, aux = self._group(g, x, aux, positions, memory, sp, caches, decode_pos)
        if sp is not None:
            x = sp.gather(x, 1)
        x = rmsnorm(self.final_norm["scale"], x, self.cfg.norm_eps)
        return x, aux / max(self.cfg.n_layers, 1)

    def _encoder_layer(self, l: int, x: torch.Tensor, positions: torch.Tensor,
                       sp=None) -> torch.Tensor:
        """Encoder layer ``l``: bidirectional self attention with rope, then
        the MLP, each pre-normed and residual (under sequence parallelism
        ``sp``, from and to this rank's sequence shard)."""
        cfg = self.cfg
        if sp is not None:
            x = sp.gather(x, 1)
        p = {part: self._leaves(f"encoder.{part}", self.encoder[part], l)
             for part in ("norm1", "attn", "norm2", "mlp")}
        attn, ff = self._split("encoder.attn"), self._split("encoder.mlp")
        h = rmsnorm(p["norm1"]["scale"], x, cfg.norm_eps)
        q, k, v = A.project_qkv(p["attn"], h, h, positions, positions, cfg.rope_theta, tp=attn)
        x = x + A.attend(p["attn"], A.attention(q, k, v, positions, positions, causal=False),
                         tp=attn)
        h2 = rmsnorm(p["norm2"]["scale"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.mlp_activation, tp=ff)
        return x if sp is None else sp.scatter(x, 1)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, D), the frontend's embeddings -> the memory
        (B, S_enc, D) bf16.  Under ``remat`` each layer is checkpointed
        whole, as the reference checkpoints its encoder under either mode."""
        x = frames.to(COMPUTE_DTYPE)
        positions = torch.arange(x.shape[1], device=x.device)
        sp = self._sequence_parallel(x.shape[1])
        if sp is not None:
            x = sp.scatter(x, 1)
        for l in range(self.cfg.n_encoder_layers):
            if self._remat():
                x = _checkpointed(self._encoder_layer, l, x, positions, sp)
            else:
                x = self._encoder_layer(l, x, positions, sp)
        if sp is not None:
            x = sp.gather(x, 1)
        return rmsnorm(self.encoder_norm["scale"], x, self.cfg.norm_eps)

    def frontend_memory(self, frontend: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """What the cross kinds attend to, from a batch's ``frontend``: the
        encoder's output for an enc-dec arch, the embeddings cast to bf16
        for a frontend arch, None for an arch that takes none (the
        reference's ``loss`` and ``build_prefill_step``)."""
        if not self.cfg.n_encoder_layers and self.cfg.frontend == "none":
            return None
        if frontend is None:
            raise ValueError(f"{self.cfg.name} takes a frontend ({self.cfg.frontend}): "
                             "give the batch's 'frontend' embeddings")
        if self.cfg.n_encoder_layers:
            return self.encode(frontend)
        return frontend.to(COMPUTE_DTYPE)

    def forward(self, tokens: torch.Tensor, *, memory: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        """tokens (B,S) -> (logits (B,S,V) f32 | final hidden, aux)."""
        x, aux = self._stack(embed(self.embed["table"], tokens, tp=self._split("embed")),
                             torch.arange(tokens.shape[1], device=tokens.device),
                             memory=memory)
        if return_hidden:
            return x, aux
        return self._logits(x), aux

    def init_caches(self, batch: int, max_seq: int, dtype=COMPUTE_DTYPE,
                    memory_len: Optional[int] = None) -> Caches:
        """Empty caches for ``max_seq`` positions: ``l{i}_{kind}`` -> the
        kind's cache with a leading ``(n_groups,)`` axis on each leaf (a
        local layer's KV cache is a ring of ``sliding_window`` slots when
        the window is the shorter; a cross block's holds ``memory_len``
        slots, by default the reference's ``n_frontend_tokens or max_seq``)."""
        return init_caches(self.cfg, batch, max_seq, dtype=dtype, memory_len=memory_len,
                           device=self.embed["table"].device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, memory: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None, last_only: bool = False,
                caches: Optional[Caches] = None) -> Tuple[torch.Tensor, Caches]:
        """tokens (B,S) -> (logits, caches filled through S).  ``last_only``
        unembeds the final position alone, (B,1,V).  The cross caches hold
        the memory's K/V at its own length, as the reference's prefill
        returns them.  ``caches``: empty caches to fill (the sharded
        engine's blocks), else :meth:`init_caches`'."""
        b, s = tokens.shape
        if caches is None:
            caches = self.init_caches(b, max_seq or s,
                                      memory_len=None if memory is None else memory.shape[1])
        x, _ = self._stack(embed(self.embed["table"], tokens, tp=self._split("embed")),
                           torch.arange(s, device=tokens.device), caches, memory=memory)
        return self._logits(x[:, -1:] if last_only else x), caches

    @torch.no_grad()
    def decode_step(self, caches: Caches, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Caches]:
        """token (B,1) at position ``pos`` -> (logits (B,1,V), caches), the
        caches written in place (a cross block's memory K/V are read)."""
        pos = int(pos)
        positions = torch.full((1,), pos, dtype=torch.long, device=token.device)
        x, _ = self._stack(embed(self.embed["table"], token, tp=self._split("embed")), positions,
                           caches, pos)
        return self._logits(x), caches

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {tokens, targets[, frontend]} -> (ce + 0.01 aux, {ce, aux})."""
        memory = self.frontend_memory(batch.get("frontend"))
        hidden, aux = self.forward(batch["tokens"], memory=memory, return_hidden=True)
        ce = _chunked_ce(self.embed["table"], hidden, batch["targets"], self.cfg,
                         head=self._head(), tp=self._split("embed"))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _chunked_ce(table, hidden, targets, cfg, head=None, tp=None) -> torch.Tensor:
    """Mean cross-entropy over ``ce_chunk``-position slices of the sequence,
    so the (B, S, V) f32 logits never exist at once; under tensor
    parallelism over the vocab, each rank's logits are its columns
    (:func:`_vocab_parallel_ce`)."""
    s = hidden.shape[1]
    chunk = min(cfg.ce_chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        h_c, t_c = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        valid = t_c >= 0
        if tp is not None and tp.vocab:
            ce = _vocab_parallel_ce(table, tp.copy(h_c), torch.clamp_min(t_c, 0).long(), cfg,
                                    head, tp)
        else:
            logits = softcap(unembed(table, h_c, cfg.vocab_size, head=head),
                             cfg.final_softcap)
            logp = torch.log_softmax(logits.float(), dim=-1)
            ce = -torch.gather(logp, -1, torch.clamp_min(t_c, 0)[..., None].long())[..., 0]
        total = total + torch.where(valid, ce, 0.0).sum()
        count = count + valid.sum()
    return total / torch.clamp_min(count, 1.0)


def _vocab_parallel_ce(table, h, targets, cfg, head, tp) -> torch.Tensor:
    """Per-position cross-entropy from this rank's vocab columns: the
    logits' global max (MAX over the ranks, outside autograd: the value
    does not depend on it), the sum of exp and the target's logit summed
    over the ranks (one rank holds each target)."""
    w = table.T if head is None else head
    cols = w.shape[1]
    lo = tp.rank * cols
    logits = (h @ w.to(h.dtype)).float()
    col = lo + torch.arange(cols, device=logits.device)
    logits = softcap(torch.where(col < cfg.vocab_size, logits, -1e30), cfg.final_softcap)
    m = tp.max(torch.amax(logits, dim=-1))
    total = tp.reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    mine = (targets >= lo) & (targets < lo + cols)
    picked = torch.gather(logits, -1, torch.where(mine, targets - lo, 0)[..., None])[..., 0]
    target_logit = tp.reduce(torch.where(mine, picked, 0.0))
    return m + torch.log(total) - target_logit
