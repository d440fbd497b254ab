"""Mixture of experts (port of ``repro.models.moe``): GShard-style grouped
one-hot dispatch with a static capacity per expert and group,

    C = max(4, ceil(group_size * top_k / n_experts * capacity_factor)),

overflow dropped.  Tokens are cut into groups of ``moe_group_size``; each
(token, choice) takes a slot of its expert in choice-major order, so every
token's first choice claims capacity before any second choice.  The router
runs in f32 and its top-k is a stable descending sort, so ties go to the
lower expert index as ``lax.top_k`` sends them.  Returns the Switch
load-balancing aux loss beside the output.

Under tensor parallelism (``tp``, ``models/tensor_parallel.py``) the
routing runs whole on every rank of the ``model`` group, whose stream is
replicated, and the experts split: over experts (``tp.experts``: each rank
dispatches to its own experts' slots, runs them and combines over them --
the reference's ``P("model", batch)`` constraints on the dispatched slots
and the expert outputs, with the all-to-all turned into local work) or
over ``ff`` inside every expert (``tp.ff``); either way the partial sums
are reduced once.  The groups and the combine weights enter the experts
through ``copy``, so their gradients sum over the ranks before they reach
the router; the einsums carry every expert, an empty one too, so every
rank reaches every collective whatever the routing.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import ParamSpec

__all__ = ["moe_shapes", "capacity", "top_k", "Routing", "route", "moe_apply"]


def moe_shapes(cfg) -> Dict[str, ParamSpec]:
    """Leaf -> ParamSpec of one MoE block (the reference's ``moe_spec``:
    the router drawn at 0.02 / sqrt(d))."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    spec = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.02 / math.sqrt(d)),
        "up": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "down": ParamSpec((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.mlp_activation in ("swiglu", "geglu"):
        spec["gate"] = ParamSpec((e, d, f), ("experts", "embed", "ff"))
    return spec


def capacity(cfg, group_size: Optional[int] = None) -> int:
    sg = group_size or cfg.moe_group_size
    return max(4, math.ceil(sg * cfg.experts_per_token / cfg.n_experts
                            * cfg.moe_capacity_factor))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot; an index outside [0, n) gives a zero row (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class Routing(NamedTuple):
    """Where the router sends each group's tokens: ``probs`` (G, Sg, E) f32,
    ``top_p`` and ``top_e`` (G, Sg, k) each token's choices (``top_p``
    renormalized where the config says so), ``slot`` (G, Sg, k) f32 each
    choice's slot within its expert -- a choice is kept when ``slot <
    cap`` -- and ``onehot_e`` (G, Sg, k, E)."""
    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    slot: torch.Tensor
    onehot_e: torch.Tensor
    cap: int


def route(groups: torch.Tensor, router: torch.Tensor, cfg) -> Routing:
    """groups (G, Sg, D) -> their routing."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(torch.einsum("gsd,de->gse", groups.float(), router.float()), dim=-1)
    top_p, top_e = top_k(probs, k)  # (G, Sg, k)
    if cfg.router_normalize_topk:
        top_p = top_p / torch.clamp_min(torch.sum(top_p, dim=-1, keepdim=True), 1e-9)
    onehot_e = _one_hot(top_e, e)  # (G, Sg, k, E)
    # slot of each (token, choice) within its expert, choice-major
    sg = groups.shape[1]
    flat = onehot_e.transpose(1, 2).reshape(-1, k * sg, e)  # (G, k*Sg, E)
    pos = torch.cumsum(flat, dim=1) - flat
    slot = torch.sum(pos * flat, dim=-1).reshape(-1, k, sg).transpose(1, 2)
    return Routing(probs, top_p, top_e, slot, onehot_e, capacity(cfg, sg))


def moe_apply(p, x: torch.Tensor, cfg, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss f32 scalar); under ``tp``
    the experts' leaves are this rank's blocks (the router whole)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    sg = min(cfg.moe_group_size, b * s)
    dt = x.dtype
    tokens = x.reshape(-1, d)
    tokens = F.pad(tokens, (0, 0, 0, (-tokens.shape[0]) % sg))
    groups = tokens.reshape(-1, sg, d)  # (G, Sg, D)
    r = route(groups, p["router"], cfg)

    # Switch aux loss: e * sum_e (fraction dispatched) * (mean prob)
    f_e = torch.mean(torch.sum(r.onehot_e, dim=2), dim=(0, 1)) / k
    aux = e * torch.sum(f_e * torch.mean(r.probs, dim=(0, 1)))

    onehot_c = _one_hot(r.slot.long(), r.cap) * (r.slot < r.cap)[..., None].float()
    onehot_e, top_p = r.onehot_e, r.top_p
    split = tp is not None and (tp.experts or tp.ff)
    if split:
        groups, top_p = tp.copy(groups), tp.copy(top_p)
    if split and tp.experts:
        onehot_e = onehot_e[..., tp.part(e)]
    dispatch = torch.einsum("gske,gskc->gsec", onehot_e, onehot_c).to(dt)
    combine = torch.einsum("gske,gskc->gsec", onehot_e * top_p[..., None], onehot_c).to(dt)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, groups.to(dt))
    up = torch.einsum("egcd,edf->egcf", xe, p["up"].to(dt))
    if "gate" in p:
        gate = torch.einsum("egcd,edf->egcf", xe, p["gate"].to(dt))
        h = (F.silu(gate) if cfg.mlp_activation == "swiglu"
             else F.gelu(gate, approximate="tanh")) * up
    else:
        h = F.relu(up)
    ye = torch.einsum("egcf,efd->egcd", h, p["down"].to(dt))
    y = torch.einsum("gsec,egcd->gsd", combine, ye)
    if split:
        y = tp.reduce(y)
    return y.reshape(-1, d)[: b * s].reshape(b, s, d), aux.float()
