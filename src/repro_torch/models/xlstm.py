"""xLSTM cells: the mLSTM (matrix memory) and the sLSTM (scalar memory,
exponential gating), port of ``repro.models.xlstm``.

Both track a log-space stabilizer m_t so the exponential input gate never
overflows:

    m_t = max(log f_t + m_{t-1}, log i_t)
    f'  = exp(log f_t + m_{t-1} - m_t),  i' = exp(log i_t - m_t)

mLSTM:  C_t = f' C_{t-1} + i' v_t k_t^T ;  n_t = f' n_{t-1} + i' k_t
        h_t = o_t * (C_t q_t) / max(|n_t . q_t|, 1)
sLSTM:  c_t = f' c_{t-1} + i' tanh(z_t) ; n_t = f' n_{t-1} + i'
        h_t = o_t * c_t / n_t

The mLSTM runs in the chunkwise-parallel form, chunks of 256 steps carrying
(C, n, m) across chunk boundaries; under autograd each chunk is
checkpointed (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint``), so backward stores boundary states, not per-step
ones.  A sequence that is not a multiple of the chunk is padded with inert
steps (log f 0, log i -1e30).  A decode step is the same function at one
step.  The sLSTM's recurrence is a loop over the sequence (its recurrent
matrix makes every step depend on the last ``h``), followed by its
gated FFN; decode is the loop at one step.

Under tensor parallelism (``tp``, ``models/tensor_parallel.py``) the mLSTM
splits over ``d_inner`` (``tp.inner``): ``in_proj``'s product is re-laid to
this rank's channels of ``xm`` and ``z`` (``tp.halves``), the conv runs on
them, the products that contract them (``wq``, ``wk``, ``wv``, ``w_i``,
``w_f``, ``w_o``) are reduced, the cell runs whole on every rank, and
``down`` is row-parallel on this rank's channels of its output.  The
sLSTM's cell replicates and its FFN splits over ``ff`` (``tp.ff``) as the
MLP does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import COMPUTE_DTYPE, rmsnorm
from repro_torch.models.sharding import ParamSpec
from repro_torch.models.ssm import causal_conv

__all__ = ["mlstm_shapes", "MLSTMState", "init_mlstm_state", "mlstm_apply",
           "mlstm_decode_step", "slstm_shapes", "SLSTMState", "init_slstm_state",
           "slstm_apply", "slstm_decode_step"]

_TIME_CHUNK = 256
_NEG = -1e30


def _di(cfg) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_shapes(cfg) -> Dict[str, ParamSpec]:
    """Leaf -> ParamSpec of one mLSTM cell (the reference's ``mlstm_spec``;
    ``b_f`` is ones: the ``ones`` init ignores its scale of 3)."""
    d, h, di = cfg.d_model, cfg.n_heads, _di(cfg)
    inner = ("xlstm_inner", None)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "xlstm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv_width, di), ("conv", "xlstm_inner")),
        "conv_b": ParamSpec((di,), ("xlstm_inner",), init="zeros"),
        "wq": ParamSpec((di, di), inner),
        "wk": ParamSpec((di, di), inner),
        "wv": ParamSpec((di, di), inner),
        "w_i": ParamSpec((di, h), ("xlstm_inner", "heads")),
        "b_i": ParamSpec((h,), ("heads",), init="zeros"),
        "w_f": ParamSpec((di, h), ("xlstm_inner", "heads")),
        "b_f": ParamSpec((h,), ("heads",), init="ones", scale=3.0),
        "w_o": ParamSpec((di, di), inner),
        "norm": ParamSpec((di,), ("embed",), init="ones"),
        "down": ParamSpec((di, d), ("xlstm_inner", "embed")),
    }


@dataclasses.dataclass
class MLSTMState:
    c: torch.Tensor  # (B, H, dh, dh) f32
    n: torch.Tensor  # (B, H, dh) f32
    m: torch.Tensor  # (B, H) f32
    conv: torch.Tensor  # (B, width - 1, di) bf16 in a cache


def init_mlstm_state(batch: int, cfg, dtype=COMPUTE_DTYPE, device=None) -> MLSTMState:
    h, di = cfg.n_heads, _di(cfg)
    dh = di // h
    return MLSTMState(
        c=torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, h), _NEG, dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dtype, device=device))


def _gates_qkv(p, x, cfg, conv_prefix, tp=None):
    """x (B,S,D) -> (q, k, v (B,S,H,dh), log_i, log_f (B,S,H) f32, o, z,
    conv tail); under ``tp.inner`` z and the tail are this rank's channels'
    (and so is ``conv_prefix``)."""
    dt = x.dtype
    h, di = cfg.n_heads, _di(cfg)
    dh = di // h
    if tp is not None and tp.inner:
        xm, z = torch.chunk(tp.halves(tp.copy(x) @ p["in_proj"].to(dt)), 2, dim=-1)
        full = tp.reduce
    else:
        xm, z = torch.chunk(x @ p["in_proj"].to(dt), 2, dim=-1)

        def full(t):
            return t
    width = cfg.ssm_conv_width
    xp = torch.cat([conv_prefix.to(dt), xm], dim=1)
    xc = F.silu(causal_conv(p["conv_w"], p["conv_b"], xp))
    b, s = x.shape[:2]
    q = full(xc @ p["wq"].to(dt)).reshape(b, s, h, dh)
    k = full(xc @ p["wk"].to(dt)).reshape(b, s, h, dh) / (dh ** 0.5)
    v = full(xm @ p["wv"].to(dt)).reshape(b, s, h, dh)
    log_i = full(xm @ p["w_i"].to(dt)).float() + p["b_i"].float()
    log_f = F.logsigmoid(full(xm @ p["w_f"].to(dt)).float() + p["b_f"].float())
    o = torch.sigmoid(full(xm @ p["w_o"].to(dt)))
    # the last (width - 1) of [prefix ++ xm], whatever S is
    return q, k, v, log_i, log_f, o, z, xp[:, xp.shape[1] - (width - 1):]


def _mlstm_chunk(c0, n0, m0, q, k, v, li, lf):
    """One chunk of L steps, time-major ((L,B,H,dh) x3, (L,B,H) x2), from
    the boundary state (C0, n0, m0) -> (C1, n1, m1, h (L,B,H,dh)).

    With b_t = sum_{r<=t} log f_r within the chunk:
        m_t = max(b_t + m0, max_{j<=t}(b_t - b_j + li_j))
        C_t = e^{b_t+m0-m_t} C0 + sum_{j<=t} e^{b_t-b_j+li_j-m_t} v_j k_j^T
    """
    L = q.shape[0]
    b_t = torch.cumsum(lf, dim=0)
    run_max = torch.cummax(li - b_t, dim=0).values
    m_t = torch.maximum(b_t + m0[None], b_t + run_max)
    # D[t, j] for j <= t, masked in log space before exp (no inf, no NaN grad)
    log_d = b_t[:, None] - b_t[None, :] + li[None, :] - m_t[:, None]  # (L,L,B,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    log_d = torch.where(causal[:, :, None, None], log_d, _NEG)
    d = torch.exp(torch.clamp_max(log_d, 30.0))
    scores = torch.einsum("tbhd,jbhd->tjbh", q, k)
    y_intra = torch.einsum("tjbh,jbhd->tbhd", scores * d, v)
    n_intra = torch.einsum("tjbh,jbhd->tbhd", d, k)
    inter_w = torch.exp(b_t + m0[None] - m_t)
    y = y_intra + torch.einsum("bhij,tbhj->tbhi", c0, q) * inter_w[..., None]
    n_t = n_intra + n0[None] * inter_w[..., None]
    den = torch.clamp_min(torch.abs(torch.einsum("tbhd,tbhd->tbh", n_t, q)), 1.0)
    h_t = y / den[..., None]
    m1 = m_t[-1]
    w_end = torch.exp(b_t[-1][None] - b_t + li - m1[None])
    w_end = torch.where(torch.isfinite(w_end), w_end, 0.0)
    decay = torch.exp(b_t[-1] + m0 - m1)
    c1 = decay[..., None, None] * c0 + torch.einsum("jbhd,jbhe->bhde", w_end[..., None] * v, k)
    n1 = decay[..., None] * n0 + torch.einsum("jbh,jbhd->bhd", w_end, k)
    return c1, n1, m1, h_t


def mlstm_apply(p, x: torch.Tensor, cfg, state: Optional[MLSTMState] = None,
                tp=None) -> Tuple[torch.Tensor, MLSTMState]:
    """x (B,S,D) -> (out (B,S,D), final state); under ``tp.inner`` the
    state's conv tail is this rank's channels'."""
    dt = x.dtype
    b, s, _ = x.shape
    split = tp is not None and tp.inner
    if state is None:
        state = init_mlstm_state(b, cfg, dt, x.device)
        if split:
            state.conv = state.conv[..., tp.part(_di(cfg))]
    q, k, v, log_i, log_f, o, z, conv_tail = _gates_qkv(p, x, cfg, state.conv, tp)
    xs = [q.transpose(0, 1).float(), k.transpose(0, 1).float(), v.transpose(0, 1).float(),
          log_i.transpose(0, 1), log_f.transpose(0, 1)]
    chunk = min(_TIME_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        xs = [F.pad(a, (0, 0) * (a.dim() - 1) + (0, pad)) for a in xs]
        xs[3] = torch.cat([xs[3][:s], torch.full_like(xs[3][s:], _NEG)])
    c, n, m = state.c, state.n, state.m
    hs = []
    for lo in range(0, s + pad, chunk):
        part = [a[lo:lo + chunk] for a in xs]
        if torch.is_grad_enabled():
            c, n, m, h_t = checkpoint(_mlstm_chunk, c, n, m, *part, use_reentrant=False)
        else:
            c, n, m, h_t = _mlstm_chunk(c, n, m, *part)
        hs.append(h_t)
    hs = torch.cat(hs)[:s].transpose(0, 1).reshape(b, s, _di(cfg)).to(dt)
    hs = rmsnorm(p["norm"], hs, cfg.norm_eps) * o
    if split:
        hs = tp.copy(hs)[..., tp.part(hs.shape[-1])]
    out = (hs * F.silu(z)) @ p["down"].to(dt)
    if split:
        out = tp.reduce(out)
    return out, MLSTMState(c, n, m, conv_tail.to(torch.bfloat16))


def mlstm_decode_step(p, x: torch.Tensor, cfg, state: MLSTMState, tp=None):
    """x (B,1,D): one step, the chunkwise form at L = 1."""
    return mlstm_apply(p, x, cfg, state, tp=tp)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_shapes(cfg) -> Dict[str, ParamSpec]:
    """Leaf -> ParamSpec of one sLSTM cell and its post-FFN (the
    reference's ``slstm_spec``)."""
    d = cfg.d_model
    f = max(1, int(d * 4 // 3))
    return {
        "w": ParamSpec((d, 4 * d), ("embed", None)),
        "r": ParamSpec((d, 4 * d), ("embed", None)),
        "b": ParamSpec((4 * d,), (None,), init="zeros"),
        "ffn_gate": ParamSpec((d, f), ("embed", "ff")),
        "ffn_up": ParamSpec((d, f), ("embed", "ff")),
        "ffn_down": ParamSpec((f, d), ("ff", "embed")),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
    }


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor  # (B, D) f32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def init_slstm_state(batch: int, cfg, dtype=COMPUTE_DTYPE, device=None) -> SLSTMState:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z + 1e-6, h=z, m=z + _NEG)


def slstm_apply(p, x: torch.Tensor, cfg, state: Optional[SLSTMState] = None,
                tp=None) -> Tuple[torch.Tensor, SLSTMState]:
    """x (B,S,D) -> (out (B,S,D), final state), the post-FFN included
    (under ``tp.ff`` column- and row-parallel)."""
    dt = x.dtype
    if state is None:
        state = init_slstm_state(x.shape[0], cfg, dt, x.device)
    xw = (x @ p["w"].to(dt)).float() + p["b"].float()
    r = p["r"].float()
    c, n, h, m = state.c, state.n, state.h, state.m
    hs = []
    for t in range(x.shape[1]):
        zt, it, ft, ot = torch.chunk(xw[:, t] + h @ r, 4, dim=-1)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        fp = torch.exp(log_f + m - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(dt)
    yn = rmsnorm(p["ffn_norm"], y, cfg.norm_eps)
    split = tp is not None and tp.ff
    if split:
        yn = tp.copy(yn)
    ff = (F.gelu(yn @ p["ffn_gate"].to(dt), approximate="tanh")
          * (yn @ p["ffn_up"].to(dt))) @ p["ffn_down"].to(dt)
    if split:
        ff = tp.reduce(ff)
    return y + ff, SLSTMState(c, n, h, m)


def slstm_decode_step(p, x: torch.Tensor, cfg, state: SLSTMState, tp=None):
    return slstm_apply(p, x, cfg, state, tp=tp)
