"""The language model (port of ``repro.models.transformer.LM``, every
decoder-only layer kind: ``forward``, ``loss`` and ``_chunked_ce`` for
training, and ``init_caches``, ``prefill`` and ``decode_step`` for serving).

Layer kinds: ``attn_mlp`` and ``attn_local_mlp`` (dense; the local ones
windowed), ``attn_moe`` and ``attn_local_moe`` (mixture of experts, whose
aux losses are summed over the stack and divided by ``n_layers``),
``hybrid`` (hymba: attention and an SSM mixer side by side, each output
normed, averaged), ``mlstm`` and ``slstm`` (xlstm's cells); attention with
or without the QKV bias.  The cross-attention kinds (``cross_attn_*``,
``dec_cross_mlp``) and the encoder raise ``NotImplementedError`` (ROADMAP.md).

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
``l{i}_{kind}`` a :class:`KVCache`, a ``(KVCache, SSMState)`` pair for
``hybrid``, an :class:`MLSTMState` or an :class:`SLSTMState`, every leaf
with a leading ``(n_groups,)`` axis, so ``convert.caches_from_jax`` is a
rename.  ``prefill`` and ``decode_step`` run without autograd and write the
caches in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.layers import (COMPUTE_DTYPE, embed, mlp, padded_vocab, rmsnorm,
                                       softcap, unembed)

__all__ = ["LM", "param_shapes", "unported_reason"]

Caches = Dict[str, object]


def unported_reason(cfg) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet, or None."""
    kinds = [k for k in cfg.layer_pattern() if k.startswith("cross_attn") or k == "dec_cross_mlp"]
    if kinds or cfg.n_encoder_layers or cfg.frontend != "none":
        return (f"{cfg.name}: the layer kinds {kinds}, the encoder and the frontend memory "
                "are not ported yet; see ROADMAP.md")
    return None


def _attn_shapes(cfg):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {"wq": ((d, h, dh), 0.02), "wk": ((d, kh, dh), 0.02), "wv": ((d, kh, dh), 0.02),
            "wo": ((h, dh, d), 0.02)}
    if cfg.qkv_bias:
        spec.update(bq=((h, dh), "zeros"), bk=((kh, dh), "zeros"), bv=((kh, dh), "zeros"))
    return spec


def _mlp_shapes(cfg):
    d, f = cfg.d_model, cfg.d_ff
    spec = {"up": ((d, f), 0.02), "down": ((f, d), 0.02)}
    if cfg.mlp_activation in ("swiglu", "geglu"):
        spec["gate"] = ((d, f), 0.02)
    return spec


def _layer_shapes(cfg, kind: str) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    """Leaf -> (shape, init) of one layer of ``kind`` (the reference's
    ``_layer_spec``); init is "zeros", "ones" or a normal's scale."""
    if kind not in ("mlstm", "slstm", "hybrid") and not (
            kind.startswith("attn") and kind.endswith(("mlp", "moe"))):
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet; see ROADMAP.md")
    d = cfg.d_model
    parts = [("norm1", {"scale": ((d,), "ones")})]
    if kind in ("mlstm", "slstm"):
        parts.append(("cell", X.mlstm_shapes(cfg) if kind == "mlstm" else X.slstm_shapes(cfg)))
    elif kind.startswith("attn") or kind == "hybrid":
        parts.append(("attn", _attn_shapes(cfg)))
        if kind == "hybrid":
            parts += [("ssm", S.ssm_shapes(cfg)), ("norm_attn_out", {"scale": ((d,), "ones")}),
                      ("norm_ssm_out", {"scale": ((d,), "ones")})]
        elif kind.endswith("moe"):
            parts += [("norm2", {"scale": ((d,), "ones")}), ("moe", M.moe_shapes(cfg))]
        elif kind.endswith("mlp"):
            parts += [("norm2", {"scale": ((d,), "ones")}), ("mlp", _mlp_shapes(cfg))]
    return {f"{part}.{leaf}": v for part, leaves in parts for leaf, v in leaves.items()}


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Leaf path -> shape, for the whole model."""
    return {k: s for k, (s, _) in _param_spec(cfg).items()}


def _param_spec(cfg) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    reason = unported_reason(cfg)
    if reason:
        raise NotImplementedError(reason)
    spec = {"embed.table": ((padded_vocab(cfg.vocab_size), cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        spec["embed.head"] = ((cfg.d_model, padded_vocab(cfg.vocab_size)), 0.02)
    spec["final_norm.scale"] = ((cfg.d_model,), "ones")
    n = cfg.n_groups()
    for i, kind in enumerate(cfg.layer_pattern()):
        for name, (shape, init) in _layer_shapes(cfg, kind).items():
            spec[f"layers.l{i}_{kind}.{name}"] = ((n,) + shape, init)
    return spec


def _attn_window(cfg, kind: str) -> int:
    return cfg.sliding_window if "local" in kind else 0


def _init_layer_cache(kind: str, cfg, batch: int, max_seq: int, dtype, device):
    """One layer's empty cache (the reference's ``_init_layer_cache``)."""
    if kind == "mlstm":
        return X.init_mlstm_state(batch, cfg, dtype, device)
    if kind == "slstm":
        return X.init_slstm_state(batch, cfg, dtype, device)
    if not (kind.startswith("attn") or kind == "hybrid"):
        raise NotImplementedError(f"the cache of layer kind {kind!r} is not ported yet; "
                                  "see ROADMAP.md")
    kv = A.init_kv_cache(batch, max_seq, cfg.n_kv_heads, cfg.head_dim,
                         window=_attn_window(cfg, kind), dtype=dtype, device=device)
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


def _write_state(view, new) -> None:
    """Copy a recurrent state's new leaves into its cache view."""
    for f in dataclasses.fields(view):
        getattr(view, f.name).copy_(getattr(new, f.name))


def _container(leaves):
    """Nested ModuleDict / ParameterDict mirroring the tree of ``leaves``."""
    children = {}
    for parts, param in leaves:
        children.setdefault(parts[0], []).append((parts[1:], param))
    if all(len(p) == 1 and not p[0][0] for p in children.values()):
        return nn.ParameterDict({k: v[0][1] for k, v in children.items()})
    return nn.ModuleDict({k: _container(v) for k, v in children.items()})


class LM(nn.Module):
    """Decoder-only LM over a repeating group of layer kinds."""

    def __init__(self, cfg, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.pattern = cfg.layer_pattern()
        self.n_groups = cfg.n_groups()
        leaves = []
        for path, (shape, init) in _param_spec(cfg).items():
            if init == "zeros":
                t = torch.zeros(shape, dtype=torch.float32, device=device)
            elif init == "ones":
                t = torch.ones(shape, dtype=torch.float32, device=device)
            else:
                t = torch.empty(shape, dtype=torch.float32, device=device)
                t.normal_(0.0, init, generator=generator)
            leaves.append((tuple(path.split(".")), nn.Parameter(t)))
        root = _container(leaves)
        for name, child in root.items():
            self.add_module(name, child)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Leaf path -> parameter, as a flat mapping."""
        return dict(self.named_parameters())

    def _attention(self, pa, h, kind: str, positions: torch.Tensor,
                   cache: Optional[A.KVCache], decode_pos: Optional[int]) -> torch.Tensor:
        """Self attention.  Full sequence: over its own keys and, given a
        cache, writes them at position 0 (the reference's
        ``_self_attention_full``); with ``decode_pos``: one token at that
        position, written into the cache, attending over the whole cache
        (``_self_attention_decode``)."""
        cfg = self.cfg
        q, k, v = A.project_qkv(pa, h, positions, cfg.rope_theta)
        kv_positions = positions
        if cache is not None:
            A.update_kv_cache(cache, k, v, 0 if decode_pos is None else decode_pos)
            if decode_pos is not None:
                k, v, kv_positions = cache.k, cache.v, cache.pos
        out = A.attention(q, k, v, positions, kv_positions, window=_attn_window(cfg, kind),
                          attn_softcap=cfg.attn_softcap)
        return A.attend(pa, out)

    def _layer(self, i: int, kind: str, g: int, x: torch.Tensor, positions: torch.Tensor,
               cache=None, decode_pos: Optional[int] = None):
        """Layer ``l{i}_{kind}`` of group ``g`` -> (x, MoE aux or None); a
        recurrent state in ``cache`` is overwritten with the final one."""
        cfg = self.cfg
        p = self.layers[f"l{i}_{kind}"]

        def group(name):
            return {k: v[g] for k, v in p[name].items()}

        h = rmsnorm(p["norm1"]["scale"][g], x, cfg.norm_eps)
        if kind in ("mlstm", "slstm"):
            apply = X.mlstm_apply if kind == "mlstm" else X.slstm_apply
            out, state = apply(group("cell"), h, cfg, cache)
            if cache is not None:
                _write_state(cache, state)
            return x + out, None
        if kind == "hybrid":
            kv, ssm_state = (None, None) if cache is None else cache
            attn_out = self._attention(group("attn"), h, kind, positions, kv, decode_pos)
            if decode_pos is None:
                ssm_out, state = S.ssm_apply(group("ssm"), h, cfg, ssm_state)
            else:
                ssm_out, state = S.ssm_decode_step(group("ssm"), h, cfg, ssm_state)
            if cache is not None:
                _write_state(ssm_state, state)
            x = x + 0.5 * (rmsnorm(p["norm_attn_out"]["scale"][g], attn_out, cfg.norm_eps)
                           + rmsnorm(p["norm_ssm_out"]["scale"][g], ssm_out, cfg.norm_eps))
            return x, None
        x = x + self._attention(group("attn"), h, kind, positions, cache, decode_pos)
        h2 = rmsnorm(p["norm2"]["scale"][g], x, cfg.norm_eps)
        if "moe" in p:
            out, aux = M.moe_apply(group("moe"), h2, cfg)
            return x + out, aux
        return x + mlp(group("mlp"), h2, cfg.mlp_activation), None

    def _head(self) -> Optional[torch.Tensor]:
        """The untied output head, or None when the table is tied."""
        return self.embed["head"] if "head" in self.embed else None

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden (B,S,D) -> softcapped f32 logits (B,S,V)."""
        logits = unembed(self.embed["table"], x, self.cfg.vocab_size,
                         head=self._head())[..., : self.cfg.vocab_size]
        return softcap(logits, self.cfg.final_softcap)

    def _stack(self, x: torch.Tensor, positions: torch.Tensor, caches: Optional[Caches] = None,
               decode_pos: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer of every group, then the final norm -> (x, the MoE
        layers' aux summed and divided by ``n_layers``)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self.n_groups):
            for i, kind in enumerate(self.pattern):
                cache = None if caches is None else _group_cache(caches[f"l{i}_{kind}"], g)
                x, a = self._layer(i, kind, g, x, positions, cache, decode_pos)
                if a is not None:
                    aux = aux + a
        x = rmsnorm(self.final_norm["scale"], x, self.cfg.norm_eps)
        return x, aux / max(self.cfg.n_layers, 1)

    def forward(self, tokens: torch.Tensor, *, return_hidden: bool = False):
        """tokens (B,S) -> (logits (B,S,V) f32 | final hidden, aux)."""
        x, aux = self._stack(embed(self.embed["table"], tokens),
                             torch.arange(tokens.shape[1], device=tokens.device))
        if return_hidden:
            return x, aux
        return self._logits(x), aux

    def init_caches(self, batch: int, max_seq: int, dtype=COMPUTE_DTYPE) -> Caches:
        """Empty caches for ``max_seq`` positions: ``l{i}_{kind}`` -> the
        kind's cache with a leading ``(n_groups,)`` axis on each leaf (a
        local layer's KV cache is a ring of ``sliding_window`` slots when
        the window is the shorter)."""
        device = self.embed["table"].device
        n = self.n_groups
        return {f"l{i}_{kind}": _map_cache(lambda t: t[None].expand((n,) + t.shape).clone(),
                                           _init_layer_cache(kind, self.cfg, batch, max_seq,
                                                             dtype, device))
                for i, kind in enumerate(self.pattern)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                last_only: bool = False) -> Tuple[torch.Tensor, Caches]:
        """tokens (B,S) -> (logits, caches filled through S).  ``last_only``
        unembeds the final position alone, (B,1,V)."""
        b, s = tokens.shape
        caches = self.init_caches(b, max_seq or s)
        x, _ = self._stack(embed(self.embed["table"], tokens),
                           torch.arange(s, device=tokens.device), caches)
        return self._logits(x[:, -1:] if last_only else x), caches

    @torch.no_grad()
    def decode_step(self, caches: Caches, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Caches]:
        """token (B,1) at position ``pos`` -> (logits (B,1,V), caches), the
        caches written in place."""
        pos = int(pos)
        positions = torch.full((1,), pos, dtype=torch.long, device=token.device)
        x, _ = self._stack(embed(self.embed["table"], token), positions, caches, pos)
        return self._logits(x), caches

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {tokens, targets} -> (ce + 0.01 aux, {ce, aux})."""
        hidden, aux = self.forward(batch["tokens"], return_hidden=True)
        ce = _chunked_ce(self.embed["table"], hidden, batch["targets"], self.cfg,
                         head=self._head())
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _chunked_ce(table, hidden, targets, cfg, head=None) -> torch.Tensor:
    """Mean cross-entropy over ``ce_chunk``-position slices of the sequence,
    so the (B, S, V) f32 logits never exist at once."""
    s = hidden.shape[1]
    chunk = min(cfg.ce_chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        h_c, t_c = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        logits = softcap(unembed(table, h_c, cfg.vocab_size, head=head), cfg.final_softcap)
        logp = torch.log_softmax(logits.float(), dim=-1)
        valid = t_c >= 0
        ce = -torch.gather(logp, -1, torch.clamp_min(t_c, 0)[..., None].long())[..., 0]
        total = total + torch.where(valid, ce, 0.0).sum()
        count = count + valid.sum()
    return total / torch.clamp_min(count, 1.0)
