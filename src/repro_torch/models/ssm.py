"""Selective state-space (Mamba-style) mixer, the SSM half of hymba's layers
(port of ``repro.models.ssm``).

Full sequence: the depthwise causal conv, then the recurrence

    h_t = exp(delta_t * A) h_{t-1} + delta_t * B_t * x_t

walked in chunks of 64 steps carrying the ``(B, d_inner, state)`` f32 state;
within a chunk it is a first-order linear scan solved by
:func:`~repro_torch.models.layers.associative_scan` (the reference's
``lax.associative_scan``, the same combines).  Decode: one step of the
recurrence, the conv's ``width - 1`` last inputs and ``h`` carried in an
:class:`SSMState` (the conv tail kept bf16 whatever the compute dtype, as
the reference keeps it).

Under tensor parallelism over ``d_inner`` (``tp.inner``,
``models/tensor_parallel.py``) a rank holds its channels' leaves: the
``in_proj`` product is re-laid to its channels' ``xs`` and ``z``
(``tp.halves``), the conv and the scan run on its channels, ``x_proj``'s
partial sums are reduced (and ``copy``'d back in, for the other ranks'
channels' share of their gradient), and ``out_proj`` is row-parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, associative_scan
from repro_torch.models.sharding import ParamSpec

__all__ = ["ssm_shapes", "SSMState", "init_ssm_state", "ssm_apply", "ssm_decode_step",
           "softplus", "causal_conv"]

_DT_RANK = 16
_SEQ_CHUNK = 64


def ssm_shapes(cfg) -> Dict[str, ParamSpec]:
    """Leaf -> ParamSpec of one SSM mixer (the reference's ``ssm_spec``)."""
    d, di, st = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv_width, di), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "x_proj": ParamSpec((di, _DT_RANK + 2 * st), ("ssm_inner", None)),
        "dt_proj": ParamSpec((_DT_RANK, di), (None, "ssm_inner")),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((di, st), ("ssm_inner", "state"), init="zeros"),
        "d_skip": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


@dataclasses.dataclass
class SSMState:
    conv: torch.Tensor  # (B, conv_width - 1, d_inner) bf16
    h: torch.Tensor  # (B, d_inner, state) f32


def init_ssm_state(batch: int, cfg, dtype=COMPUTE_DTYPE, device=None) -> SSMState:
    di = cfg.ssm_expand * cfg.d_model
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dtype, device=device),
        h=torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear branch above a
    threshold (``F.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(w: torch.Tensor, b: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """Depthwise conv along the sequence of ``xp`` (B, S + width - 1, C), no
    padding: a cross-correlation, as ``conv_general_dilated`` computes it,
    with ``w`` (width, C) and the bias ``b`` (C,) -> (B, S, C)."""
    dt = xp.dtype
    out = F.conv1d(xp.transpose(1, 2), w.to(dt).T[:, None, :], groups=w.shape[1])
    return out.transpose(1, 2) + b.to(dt)


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def _chunk(h, xck, dk, bk, ck, a):
    """One chunk of L steps from state ``h``: (y (B, L, di), h_end)."""
    da = torch.exp(dk[..., None] * a)  # (B, L, di, st)
    dbx = dk[..., None] * bk[:, :, None, :] * xck[..., None]
    # the carry is step 0, with decay 1
    da_all = torch.cat([torch.ones_like(da[:, :1]), da], dim=1)
    dbx_all = torch.cat([h[:, None], dbx], dim=1)
    _, hs = associative_scan(_combine, (da_all, dbx_all), dim=1)
    hs = hs[:, 1:]
    return torch.sum(hs * ck[:, :, None, :], dim=-1), hs[:, -1]


def _ssm_inner(p, xc, h0, cfg, tp=None):
    """The selective scan on the conv'd activations ``xc`` (B, S, di) ->
    (y (B, S, di) in xc's dtype, final state (B, di, state) f32)."""
    st = cfg.ssm_state
    proj = xc @ p["x_proj"].to(xc.dtype)
    if tp is not None and tp.inner:
        proj = tp.copy(tp.reduce(proj))
    dt_in, b_t, c_t = torch.split(proj, [_DT_RANK, st, st], dim=-1)
    delta = softplus(dt_in.float() @ p["dt_proj"].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    s = xc.shape[1]
    chunk = min(_SEQ_CHUNK, s)
    pad = (-s) % chunk
    # padded steps are inert: delta 0 keeps the state (decay 1, input 0)
    xf, dk, bk, ck = (F.pad(t, (0, 0, 0, pad)) for t in
                      (xc.float(), delta, b_t.float(), c_t.float()))
    h, ys = h0, []
    for lo in range(0, s + pad, chunk):
        y, h = _chunk(h, *(t[:, lo:lo + chunk] for t in (xf, dk, bk, ck)), a)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] + xc.float() * p["d_skip"].float()
    return y.to(xc.dtype), h


def ssm_apply(p, x: torch.Tensor, cfg, state: Optional[SSMState] = None,
              tp=None) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence mixer: x (B, S, D) -> (y (B, S, D), final state); from
    ``state`` when given (its conv tail prefixes the sequence).  Under
    ``tp`` the state and the tail are this rank's channels'."""
    dt = x.dtype
    split = tp is not None and tp.inner
    if split:
        xs, z = torch.chunk(tp.halves(tp.copy(x) @ p["in_proj"].to(dt)), 2, dim=-1)
    else:
        xs, z = torch.chunk(x @ p["in_proj"].to(dt), 2, dim=-1)
    width = cfg.ssm_conv_width
    if state is None:
        hist = xs
        xp = F.pad(xs, (0, 0, width - 1, 0))
        h0 = torch.zeros((x.shape[0], xs.shape[-1], cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
    else:
        hist = xp = torch.cat([state.conv.to(dt), xs], dim=1)
        h0 = state.h
    xc = F.silu(causal_conv(p["conv_w"], p["conv_b"], xp))
    y, h_final = _ssm_inner(p, xc, h0, cfg, tp)
    out = (y * F.silu(z)) @ p["out_proj"].to(dt)
    if split:
        out = tp.reduce(out)
    # the last (width - 1) of [prefix ++ xs]
    tail = hist[:, hist.shape[1] - (width - 1):].to(torch.bfloat16)
    return out, SSMState(conv=tail, h=h_final)


def ssm_decode_step(p, x: torch.Tensor, cfg, state: SSMState,
                    tp=None) -> Tuple[torch.Tensor, SSMState]:
    """One token: x (B, 1, D) -> (y (B, 1, D), state'); under ``tp`` the
    state is this rank's channels', as in :func:`ssm_apply`."""
    dt = x.dtype
    split = tp is not None and tp.inner
    if split:
        xs, z = torch.chunk(tp.halves(tp.copy(x) @ p["in_proj"].to(dt)), 2, dim=-1)
    else:
        xs, z = torch.chunk(x @ p["in_proj"].to(dt), 2, dim=-1)  # (B, 1, di)
    conv_in = torch.cat([state.conv.to(dt), xs], dim=1)  # (B, width, di)
    w = p["conv_w"].to(dt)
    xc = F.silu(torch.sum(conv_in * w[None], dim=1, keepdim=True) + p["conv_b"].to(dt))
    st = cfg.ssm_state
    proj = xc @ p["x_proj"].to(dt)
    if split:
        proj = tp.copy(tp.reduce(proj))
    dt_in, b_t, c_t = torch.split(proj, [_DT_RANK, st, st], dim=-1)
    delta = softplus(dt_in.float() @ p["dt_proj"].float() + p["dt_bias"].float())[:, 0]
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(delta[..., None] * a)  # (B, di, st)
    dbx = delta[..., None] * b_t.float()[:, 0, None, :] * xc.float()[:, 0, :, None]
    h = da * state.h + dbx
    y = torch.sum(h * c_t.float()[:, 0, None, :], dim=-1)
    y = y + xc.float()[:, 0] * p["d_skip"].float()
    out = (y[:, None].to(dt) * F.silu(z)) @ p["out_proj"].to(dt)
    if split:
        out = tp.reduce(out)
    return out, SSMState(conv=conv_in[:, 1:].to(torch.bfloat16), h=h)
