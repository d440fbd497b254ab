"""Models of the port: the decoder-only LM zoo (dense, MoE, hybrid, xLSTM)
and the convnet."""

from repro_torch.models.registry import build
from repro_torch.models.transformer import LM

__all__ = ["LM", "build"]
