"""Architecture configuration (port of ``repro.configs.base.ArchConfig``, the
fields and methods of the dense family).

One :class:`ArchConfig` describes a model; ``layer_pattern()`` is the
repeating group of layer kinds the stack walks ``n_groups()`` times, and
``reduced()`` the tiny same-family config the CPU tests use.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # the port runs the dense family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 1e4
    qkv_bias: bool = False
    attn_softcap: float = 0.0  # gemma2: 50.0
    final_softcap: float = 0.0  # gemma2: 30.0
    sliding_window: int = 0
    local_global_period: int = 0  # gemma2: 2 -> [local, global]
    mlp_activation: str = "swiglu"  # swiglu | geglu | relu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    ce_chunk: int = 512  # chunked cross-entropy: seq positions per unembed

    def layer_pattern(self) -> Tuple[str, ...]:
        """The repeating group of layer kinds."""
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: family {self.family!r} is not ported yet (ROADMAP.md)")
        if self.local_global_period:
            return tuple("attn_local_mlp" if i % self.local_global_period == 0 else "attn_mlp"
                         for i in range(self.local_global_period))
        if self.sliding_window:
            return ("attn_local_mlp",)
        return ("attn_mlp",)

    def n_groups(self) -> int:
        pattern = self.layer_pattern()
        if self.n_layers % len(pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by "
                             f"pattern length {len(pattern)}")
        return self.n_layers // len(pattern)

    def param_count(self) -> int:
        from repro_torch.models.transformer import param_shapes

        return sum(int(_numel(s)) for s in param_shapes(self).values())

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
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
        )


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
