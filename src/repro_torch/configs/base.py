"""Architecture and shape configuration (port of ``repro.configs.base``).

One :class:`ArchConfig` describes any of the ten architectures;
``layer_pattern()`` is the repeating group of layer kinds the stack walks
``n_groups()`` times, and ``reduced()`` the tiny same-family config the CPU
tests use.  Every field of the reference is here, so ``dataclasses.asdict``
of a config equals the reference's; the port reads every field but
``scan_layers`` and the flash-tile sizes, which it keeps for that parity
alone (the port walks the groups in a Python loop and materializes one
layer's scores at once).  ``remat`` checkpoints each group of the stack as
the reference does (``models/transformer.py``).

:class:`ShapeConfig` and ``SHAPES`` are the four assigned input shapes.

``param_count()`` sums the port's own parameter shapes, which are the
reference spec's.  The reference's analytic ``ArchConfig.param_count`` is not
ported: it disagrees with its own spec for hymba (it counts an MLP that a
``hybrid`` layer does not build), for xlstm, and for seamless and
llama-vision (it counts a self attention that a ``cross_attn_*`` layer does
not build; ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    rope_theta: float = 1e4
    qkv_bias: bool = False
    attn_softcap: float = 0.0  # gemma2: 50.0
    final_softcap: float = 0.0  # gemma2: 30.0
    sliding_window: int = 0  # mixtral / gemma2 local layers
    local_global_period: int = 0  # gemma2: 2 -> [local, global] alternating
    mlp_activation: str = "swiglu"  # swiglu | geglu | relu

    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 512
    moe_capacity_factor: float = 1.25
    router_normalize_topk: bool = True

    # ssm / hybrid (hymba)
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2

    # xlstm
    slstm_every: int = 0  # every k-th layer is sLSTM (0 = none)
    xlstm_proj_factor: float = 2.0

    # enc-dec / cross-attn
    n_encoder_layers: int = 0
    cross_attn_period: int = 0  # llama-vision: every 5th decoder layer

    # modality frontend stub: precomputed embeddings
    frontend: str = "none"  # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    remat: str = "full"  # full | dots | none: checkpoint each group of the stack
    scan_layers: bool = True  # the reference's lax.scan over groups
    ce_chunk: int = 512  # chunked cross-entropy: seq positions per unembed
    attn_q_chunk: int = 512  # the reference's flash tile sizes
    attn_kv_chunk: int = 1024

    def layer_pattern(self) -> Tuple[str, ...]:
        """The repeating group of layer kinds the stack walks."""
        if self.n_encoder_layers:  # enc-dec: every decoder layer has cross-attn
            return ("dec_cross_mlp",)
        if self.family == "ssm":  # xlstm
            period = self.slstm_every or self.n_layers + 1
            return tuple("slstm" if (i + 1) % period == 0 else "mlstm" for i in range(period))
        if self.family == "hybrid":
            return ("hybrid",)
        mlp = "moe" if self.n_experts else "mlp"
        if self.local_global_period:
            return tuple(f"attn_local_{mlp}" if i % self.local_global_period == 0
                         else f"attn_{mlp}" for i in range(self.local_global_period))
        if self.cross_attn_period:
            return tuple([f"attn_{mlp}"] * (self.cross_attn_period - 1)
                         + [f"cross_attn_{mlp}"])
        if self.sliding_window:
            return (f"attn_local_{mlp}",)
        return (f"attn_{mlp}",)

    def n_groups(self) -> int:
        pattern = self.layer_pattern()
        if self.n_layers % len(pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by "
                             f"pattern length {len(pattern)}")
        return self.n_layers // len(pattern)

    def param_count(self) -> int:
        from repro_torch.models.transformer import param_shapes

        return sum(int(_numel(s)) for s in param_shapes(self).values())

    def active_param_count(self) -> int:
        """The parameters a token uses (the reference's): of each MoE
        layer's experts only ``experts_per_token`` of ``n_experts``."""
        if not self.n_experts:
            return self.param_count()
        glu_mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        per_expert = self.n_layers * glu_mult * self.d_model * self.d_ff
        return self.param_count() - (self.n_experts - self.experts_per_token) * per_expert

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        return dataclasses.replace(
            self,
            n_layers=len(self.layer_pattern()) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.n_experts else 0,
            moe_group_size=32,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            n_frontend_tokens=16 if self.frontend != "none" else 0,
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
