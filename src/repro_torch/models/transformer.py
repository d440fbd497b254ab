"""The language model (port of ``repro.models.transformer.LM``, the dense
family's training path: ``forward``, ``loss`` and ``_chunked_ce``).

The parameter layout is the reference's tree, one ``nn.Parameter`` per leaf:
``embed.table``, ``final_norm.scale`` and, for the repeating group of layer
kinds, ``layers.l{i}_{kind}.{attn,mlp,norm1,norm2}.*`` with a leading
stacked ``(n_groups, ...)`` axis (the reference's ``_stack_spec``); the
forward pass indexes ``p[g]`` per group.  ``named_parameters()`` therefore
yields the reference's leaf paths, ``reducers.flatten_tree`` yields the
reference's flat vector in the same order, and ``convert.params_from_jax``
is a rename.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models.layers import embed, mlp, padded_vocab, rmsnorm, softcap, unembed

__all__ = ["LM", "param_shapes"]


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
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings are not ported yet; see ROADMAP.md")
    spec = {"embed.table": ((padded_vocab(cfg.vocab_size), cfg.d_model), "normal"),
            "final_norm.scale": ((cfg.d_model,), "ones")}
    n = cfg.n_groups()
    for i, kind in enumerate(cfg.layer_pattern()):
        for name, (shape, init) in _layer_shapes(cfg, kind).items():
            spec[f"layers.l{i}_{kind}.{name}"] = ((n,) + shape, init)
    return spec


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

    def forward(self, tokens: torch.Tensor, *, return_hidden: bool = False):
        """tokens (B,S) -> (logits (B,S,V) f32 | final hidden, aux)."""
        cfg = self.cfg
        table = self.embed["table"]
        x = embed(table, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for g in range(self.n_groups):
            for i, kind in enumerate(self.pattern):
                p = self.layers[f"l{i}_{kind}"]
                window = cfg.sliding_window if "local" in kind else 0
                h = rmsnorm(p["norm1"]["scale"][g], x, cfg.norm_eps)
                pa = {k: v[g] for k, v in p["attn"].items()}
                q, k, v = A.project_qkv(pa, h, positions, cfg.rope_theta)
                out = A.attention(q, k, v, positions, window=window,
                                  attn_softcap=cfg.attn_softcap)
                x = x + A.attend(pa, out)
                h2 = rmsnorm(p["norm2"]["scale"][g], x, cfg.norm_eps)
                x = x + mlp({k: v[g] for k, v in p["mlp"].items()}, h2, cfg.mlp_activation)
        x = rmsnorm(self.final_norm["scale"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, aux
        logits = unembed(table, x, cfg.vocab_size)[..., : cfg.vocab_size]
        return softcap(logits, cfg.final_softcap), aux

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {tokens, targets} -> (loss, {ce, aux})."""
        hidden, aux = self.forward(batch["tokens"], return_hidden=True)
        ce = _chunked_ce(self.embed["table"], hidden, batch["targets"], self.cfg)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _chunked_ce(table, hidden, targets, cfg) -> torch.Tensor:
    """Mean cross-entropy over ``ce_chunk``-position slices of the sequence,
    so the (B, S, V) f32 logits never exist at once."""
    s = hidden.shape[1]
    chunk = min(cfg.ce_chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        h_c, t_c = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        logits = softcap(unembed(table, h_c, cfg.vocab_size), cfg.final_softcap)
        logp = torch.log_softmax(logits.float(), dim=-1)
        valid = t_c >= 0
        ce = -torch.gather(logp, -1, torch.clamp_min(t_c, 0)[..., None].long())[..., 0]
        total = total + torch.where(valid, ce, 0.0).sum()
        count = count + valid.sum()
    return total / torch.clamp_min(count, 1.0)
