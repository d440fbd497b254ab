"""Plain PyTorch reference of the benchmark's two model shapes.

* decoder-only (phi3): token embedding; each layer pre-normed (RMSNorm)
  grouped-query self attention with rotary embeddings and a causal mask,
  then a pre-normed SwiGLU MLP, each added to the residual stream; a final
  RMSNorm and an untied head; the mean cross-entropy of every position.
* encoder-decoder (seamless): the encoder runs the frames through
  pre-normed bidirectional self attention (rotary) and a ReLU MLP a layer,
  then a final RMSNorm, and is the memory; each decoder layer adds causal
  self attention (rotary), cross attention over the memory (no positions,
  no mask) and the MLP, each pre-normed.

Precision, as the configurations state it: parameters float32, cast to
bfloat16 at use; activations and matrix products in bfloat16; norms, the
softmax and the loss in float32 (the softmax's numerator enters the value
product in bfloat16 and its sum divides the product after it).

The parameters are named and stacked as the port lays them out (one leaf a
kind of matrix, every layer's on a leading axis; the embedding table and
the head padded to a multiple of 128 rows), so the two are compared leaf
by leaf.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

COMPUTE = torch.bfloat16
# positions a block of the loss: the logits of one block live at a time
CE_BLOCK = 512


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def _attn_shapes(d, h, kh, dh) -> Dict[str, tuple]:
    return {"wq": (d, h, dh), "wk": (d, kh, dh), "wv": (d, kh, dh), "wo": (h, dh, d)}


def _mlp_shapes(arch) -> Dict[str, tuple]:
    d, f = arch["d_model"], arch["d_ff"]
    out = {"up": (d, f), "down": (f, d)}
    if arch["mlp_activation"] == "swiglu":
        out["gate"] = (d, f)
    return out


def layer_kind(arch) -> str:
    return "dec_cross_mlp" if arch.get("n_encoder_layers") else "attn_mlp"


def leaf_shapes(arch) -> Dict[str, tuple]:
    """Leaf path -> shape of the whole model."""
    d, h, kh, dh = arch["d_model"], arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    vp = padded_vocab(arch["vocab_size"])
    out = {"embed.table": (vp, d)}
    if not arch.get("tie_embeddings", False):
        out["embed.head"] = (d, vp)
    out["final_norm.scale"] = (d,)
    layer = {"norm1.scale": (d,), "norm2.scale": (d,)}
    layer.update({f"attn.{k}": s for k, s in _attn_shapes(d, h, kh, dh).items()})
    layer.update({f"mlp.{k}": s for k, s in _mlp_shapes(arch).items()})
    if arch.get("n_encoder_layers"):
        layer["norm_cross.scale"] = (d,)
        layer.update({f"cross.{k}": s for k, s in _attn_shapes(d, h, kh, dh).items()})
        enc = {"norm1.scale": (d,), "norm2.scale": (d,)}
        enc.update({f"attn.{k}": s for k, s in _attn_shapes(d, h, kh, dh).items()})
        enc.update({f"mlp.{k}": s for k, s in _mlp_shapes(arch).items()})
        out.update({f"encoder.{k}": (arch["n_encoder_layers"],) + s for k, s in enc.items()})
        out["encoder_norm.scale"] = (d,)
    kind = layer_kind(arch)
    out.update({f"layers.l0_{kind}.{k}": (arch["n_layers"],) + s for k, s in layer.items()})
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, s, heads, dh): the first and second halves of each head
    rotated by position x inverse frequency theta^(-2i/dh), in float32."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = torch.exp(torch.arange(half, device=x.device, dtype=torch.float32)
                    * (-math.log(theta) / half))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention(p, xq, xkv, arch, *, causal: bool, rope: bool) -> torch.Tensor:
    d, h, kh, dh = arch["d_model"], arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    b, s, _ = xq.shape
    t = xkv.shape[1]
    q = (xq @ p["wq"].to(COMPUTE).reshape(d, h * dh)).view(b, s, h, dh)
    k = (xkv @ p["wk"].to(COMPUTE).reshape(d, kh * dh)).view(b, t, kh, dh)
    v = (xkv @ p["wv"].to(COMPUTE).reshape(d, kh * dh)).view(b, t, kh, dh)
    if rope:
        q, k = rotary(q, arch["rope_theta"]), rotary(k, arch["rope_theta"])
    q = q.view(b, s, kh, h // kh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * (1.0 / math.sqrt(dh))
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=xq.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    # the softmax's numerator in bfloat16 for the value product, its sum in
    # float32 dividing the product
    num = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bkgst,btkd->bskgd", num.to(COMPUTE), v).float()
    out = (pv / num.sum(dim=-1).permute(0, 3, 1, 2)[..., None]).to(COMPUTE)
    return out.reshape(b, s, h * dh) @ p["wo"].to(COMPUTE).reshape(h * dh, d)


def mlp(p, x, arch) -> torch.Tensor:
    up = x @ p["up"].to(COMPUTE)
    if arch["mlp_activation"] == "swiglu":
        hidden = F.silu(x @ p["gate"].to(COMPUTE)) * up
    elif arch["mlp_activation"] == "relu":
        hidden = F.relu(up)
    else:
        raise ValueError(f"no reference for activation {arch['mlp_activation']!r}")
    return hidden @ p["down"].to(COMPUTE)


def _layer_params(params, prefix: str, index: int) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, t in params.items():
        if path.startswith(prefix):
            block, leaf = path[len(prefix):].split(".")
            out.setdefault(block, {})[leaf] = t[index]
    return out


def _encoder_layer(x, p, arch):
    hn = rmsnorm(x, p["norm1"]["scale"], arch["norm_eps"])
    x = x + attention(p["attn"], hn, hn, arch, causal=False, rope=True)
    return x + mlp(p["mlp"], rmsnorm(x, p["norm2"]["scale"], arch["norm_eps"]), arch)


def _decoder_layer(x, memory, p, arch):
    eps = arch["norm_eps"]
    hn = rmsnorm(x, p["norm1"]["scale"], eps)
    x = x + attention(p["attn"], hn, hn, arch, causal=True, rope=True)
    if memory is not None:
        hc = rmsnorm(x, p["norm_cross"]["scale"], eps)
        x = x + attention(p["cross"], hc, memory, arch, causal=False, rope=False)
    return x + mlp(p["mlp"], rmsnorm(x, p["norm2"]["scale"], eps), arch)


def _layer(fn, *args):
    """A layer whose activations are recomputed in the backward pass when
    autograd records (the same ops on the same inputs: no value changes),
    so the reference fits beside its state at the cells' sizes."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, frames, arch) -> torch.Tensor:
    x = frames.to(COMPUTE)
    for i in range(arch["n_encoder_layers"]):
        x = _layer(_encoder_layer, x, _layer_params(params, "encoder.", i), arch)
    return rmsnorm(x, params["encoder_norm.scale"], arch["norm_eps"])


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], arch,
         rows: Optional[slice] = None) -> torch.Tensor:
    """Mean cross-entropy of the batch's targets (of ``rows`` only, when
    given: a fault the harness's test plants), the logits made
    ``CE_BLOCK`` positions at a time."""
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    memory = encode(params, batch["frontend"], arch) if arch.get("n_encoder_layers") else None
    x = F.embedding(batch["tokens"], params["embed.table"]).to(COMPUTE)
    prefix = f"layers.l0_{layer_kind(arch)}."
    for i in range(arch["n_layers"]):
        x = _layer(_decoder_layer, x, memory, _layer_params(params, prefix, i), arch)
    x = rmsnorm(x, params["final_norm.scale"], arch["norm_eps"])
    head = params["embed.head"] if "embed.head" in params else params["embed.table"].T
    vocab = arch["vocab_size"]
    targets = batch["targets"]
    total = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, x.shape[1], CE_BLOCK):
        logits = (x[:, lo:lo + CE_BLOCK] @ head.to(COMPUTE)).float()[..., :vocab]
        total = total + F.cross_entropy(logits.reshape(-1, vocab),
                                        targets[:, lo:lo + CE_BLOCK].reshape(-1), reduction="sum")
    return total / targets.numel()
