"""One config module per architecture (the reference's ten, same values)."""

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_NAMES", "get_config"]

# the reference's order (repro.models.registry.ARCH_NAMES)
ARCH_NAMES = (
    "seamless_m4t_large_v2",
    "internlm2_20b",
    "qwen1_5_110b",
    "gemma2_2b",
    "phi3_medium_14b",
    "hymba_1_5b",
    "llama3_2_vision_11b",
    "xlstm_1_3b",
    "mixtral_8x22b",
    "qwen3_moe_235b_a22b",
)


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown architecture {name!r}; one of {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
