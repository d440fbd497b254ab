"""Models of the port (the dense transformer family so far)."""

from repro_torch.models.transformer import LM

__all__ = ["LM", "build"]


def build(cfg, *, device=None, generator=None) -> LM:
    """The model for ``cfg`` with weights drawn from ``generator``."""
    return LM(cfg, device=device, generator=generator)
