"""The language model (port of ``repro.models.transformer.LM``, the dense
family: ``forward``, ``loss`` and ``_chunked_ce`` for training, and
``init_caches``, ``prefill`` and ``decode_step`` for serving).

The parameter layout is the reference's tree, one ``nn.Parameter`` per leaf:
``embed.table`` (and, with ``tie_embeddings=False``, the output head
``embed.head`` of shape ``(d_model, padded_vocab)``, which the logits use
in place of the table's transpose), ``final_norm.scale`` and, for the
repeating group of layer kinds,
``layers.l{i}_{kind}.{attn,mlp,norm1,norm2}.*`` with a leading
stacked ``(n_groups, ...)`` axis (the reference's ``_stack_spec``); the
forward pass indexes ``p[g]`` per group.  ``named_parameters()`` therefore
yields the reference's leaf paths, ``reducers.flatten_tree`` yields the
reference's flat vector in the same order, and ``convert.params_from_jax``
is a rename.

The caches keep the reference's structure too: one :class:`KVCache` a layer
kind, ``l{i}_{kind}``, every leaf with a leading ``(n_groups,)`` axis, so
``convert.caches_from_jax`` is a rename.  ``prefill`` and ``decode_step``
run without autograd and write the caches in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models.layers import (COMPUTE_DTYPE, embed, mlp, padded_vocab, rmsnorm,
                                       softcap, unembed)

__all__ = ["LM", "param_shapes"]

Caches = Dict[str, A.KVCache]


def _layer_shapes(cfg, kind: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "norm1.scale": ((d,), "ones"),
        "attn.wq": ((d, h, dh), "normal"),
        "attn.wk": ((d, kh, dh), "normal"),
        "attn.wv": ((d, kh, dh), "normal"),
        "attn.wo": ((h, dh, d), "normal"),
        "norm2.scale": ((d,), "ones"),
        "mlp.up": ((d, cfg.d_ff), "normal"),
        "mlp.down": ((cfg.d_ff, d), "normal"),
    }
    if cfg.mlp_activation in ("swiglu", "geglu"):
        spec["mlp.gate"] = ((d, cfg.d_ff), "normal")
    if not kind.startswith("attn") or not kind.endswith("mlp") or cfg.qkv_bias:
        raise NotImplementedError(f"layer kind {kind!r} (qkv_bias={cfg.qkv_bias}) is not "
                                  "ported yet; see ROADMAP.md")
    return spec


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Leaf path -> shape, for the whole model."""
    return {k: s for k, (s, _) in _param_spec(cfg).items()}


def _param_spec(cfg) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    spec = {"embed.table": ((padded_vocab(cfg.vocab_size), cfg.d_model), "normal")}
    if not cfg.tie_embeddings:
        spec["embed.head"] = ((cfg.d_model, padded_vocab(cfg.vocab_size)), "normal")
    spec["final_norm.scale"] = ((cfg.d_model,), "ones")
    n = cfg.n_groups()
    for i, kind in enumerate(cfg.layer_pattern()):
        for name, (shape, init) in _layer_shapes(cfg, kind).items():
            spec[f"layers.l{i}_{kind}.{name}"] = ((n,) + shape, init)
    return spec


def _attn_window(cfg, kind: str) -> int:
    return cfg.sliding_window if "local" in kind else 0


def _init_layer_cache(kind: str, cfg, batch: int, max_seq: int, dtype, device) -> A.KVCache:
    if not kind.startswith("attn"):
        raise NotImplementedError(f"the cache of layer kind {kind!r} is not ported yet; "
                                  "see ROADMAP.md")
    return A.init_kv_cache(batch, max_seq, cfg.n_kv_heads, cfg.head_dim,
                           window=_attn_window(cfg, kind), dtype=dtype, device=device)


def _group_cache(cache: A.KVCache, g: int) -> A.KVCache:
    """Group ``g``'s view of a stacked cache (writes land in the stack)."""
    return A.KVCache(cache.k[g], cache.v[g], cache.pos[g], cache.ring)


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
            if init == "ones":
                t = torch.ones(shape, dtype=torch.float32, device=device)
            else:
                t = torch.empty(shape, dtype=torch.float32, device=device)
                t.normal_(0.0, 0.02, generator=generator)
            leaves.append((tuple(path.split(".")), nn.Parameter(t)))
        root = _container(leaves)
        for name, child in root.items():
            self.add_module(name, child)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Leaf path -> parameter, as a flat mapping."""
        return dict(self.named_parameters())

    def _layer(self, i: int, kind: str, g: int, x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[A.KVCache] = None,
               decode_pos: Optional[int] = None) -> torch.Tensor:
        """Layer ``l{i}_{kind}`` of group ``g``.  Full sequence: attends over
        its own keys and, given a cache, writes them at position 0 (the
        reference's ``_self_attention_full``); with ``decode_pos``: one
        token at that position, written into the cache, attending over the
        whole cache (``_self_attention_decode``)."""
        cfg = self.cfg
        p = self.layers[f"l{i}_{kind}"]
        h = rmsnorm(p["norm1"]["scale"][g], x, cfg.norm_eps)
        pa = {k: v[g] for k, v in p["attn"].items()}
        q, k, v = A.project_qkv(pa, h, positions, cfg.rope_theta)
        kv_positions = positions
        if cache is not None:
            A.update_kv_cache(cache, k, v, 0 if decode_pos is None else decode_pos)
            if decode_pos is not None:
                k, v, kv_positions = cache.k, cache.v, cache.pos
        out = A.attention(q, k, v, positions, kv_positions, window=_attn_window(cfg, kind),
                          attn_softcap=cfg.attn_softcap)
        x = x + A.attend(pa, out)
        h2 = rmsnorm(p["norm2"]["scale"][g], x, cfg.norm_eps)
        return x + mlp({k: v[g] for k, v in p["mlp"].items()}, h2, cfg.mlp_activation)

    def _head(self) -> Optional[torch.Tensor]:
        """The untied output head, or None when the table is tied."""
        return self.embed["head"] if "head" in self.embed else None

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden (B,S,D) -> softcapped f32 logits (B,S,V)."""
        logits = unembed(self.embed["table"], x, self.cfg.vocab_size,
                         head=self._head())[..., : self.cfg.vocab_size]
        return softcap(logits, self.cfg.final_softcap)

    def _stack(self, x: torch.Tensor, positions: torch.Tensor, caches: Optional[Caches] = None,
               decode_pos: Optional[int] = None) -> torch.Tensor:
        """Every layer of every group, then the final norm."""
        for g in range(self.n_groups):
            for i, kind in enumerate(self.pattern):
                cache = None if caches is None else _group_cache(caches[f"l{i}_{kind}"], g)
                x = self._layer(i, kind, g, x, positions, cache, decode_pos)
        return rmsnorm(self.final_norm["scale"], x, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *, return_hidden: bool = False):
        """tokens (B,S) -> (logits (B,S,V) f32 | final hidden, aux)."""
        x = self._stack(embed(self.embed["table"], tokens),
                        torch.arange(tokens.shape[1], device=tokens.device))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, aux
        return self._logits(x), aux

    def init_caches(self, batch: int, max_seq: int, dtype=COMPUTE_DTYPE) -> Caches:
        """Empty caches for ``max_seq`` positions: ``l{i}_{kind}`` ->
        :class:`KVCache` with a leading ``(n_groups,)`` axis on each leaf (a
        local layer's is a ring of ``sliding_window`` slots when the window
        is the shorter)."""
        device = self.embed["table"].device
        out = {}
        for i, kind in enumerate(self.pattern):
            one = _init_layer_cache(kind, self.cfg, batch, max_seq, dtype, device)
            out[f"l{i}_{kind}"] = A.KVCache(
                *(t[None].expand((self.n_groups,) + t.shape).clone()
                  for t in (one.k, one.v, one.pos)), one.ring)
        return out

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                last_only: bool = False) -> Tuple[torch.Tensor, Caches]:
        """tokens (B,S) -> (logits, caches filled through S).  ``last_only``
        unembeds the final position alone, (B,1,V)."""
        b, s = tokens.shape
        caches = self.init_caches(b, max_seq or s)
        x = self._stack(embed(self.embed["table"], tokens),
                        torch.arange(s, device=tokens.device), caches)
        return self._logits(x[:, -1:] if last_only else x), caches

    @torch.no_grad()
    def decode_step(self, caches: Caches, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Caches]:
        """token (B,1) at position ``pos`` -> (logits (B,1,V), caches), the
        caches written in place."""
        pos = int(pos)
        positions = torch.full((1,), pos, dtype=torch.long, device=token.device)
        x = self._stack(embed(self.embed["table"], token), positions, caches, pos)
        return self._logits(x), caches

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {tokens, targets} -> (loss, {ce, aux})."""
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
