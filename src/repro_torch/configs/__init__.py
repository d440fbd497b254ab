"""Model configurations of the port (gemma2_2b so far)."""

from repro_torch.configs.base import ArchConfig

__all__ = ["ArchConfig", "ARCH_NAMES", "get_config"]

ARCH_NAMES = ("gemma2_2b",)


def get_config(name: str) -> ArchConfig:
    if name == "gemma2_2b":
        from repro_torch.configs.gemma2_2b import CONFIG

        return CONFIG
    raise NotImplementedError(
        f"architecture {name!r} is not ported yet (ported: {ARCH_NAMES}); see ROADMAP.md")
