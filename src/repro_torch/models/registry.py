"""Architecture registry (port of ``repro.models.registry``): name ->
ArchConfig -> LM, the long-context cells, and small concrete batches.

``make_batch`` draws its tokens from a ``torch.Generator``: the same
contract as the reference's, not its ``jax.random`` bits.  The ``frontend``
entry of the archs that take one (precomputed frame or patch embeddings)
waits for those archs (``unported_reason``), as does ``input_specs`` (the
dry-run's abstract inputs); see ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_NAMES, ArchConfig, ShapeConfig, get_config
from repro_torch.models.transformer import LM, unported_reason

__all__ = ["ARCH_NAMES", "LONG_CONTEXT_OK", "get_config", "build", "cell_is_supported",
           "make_batch", "check_arch", "unported_reason"]

# archs with sub-quadratic or bounded-window sequence mixing run long_500k
LONG_CONTEXT_OK = {"xlstm_1_3b", "hymba_1_5b", "gemma2_2b", "mixtral_8x22b"}


def build(cfg_or_name, *, device=None, generator: Optional[torch.Generator] = None) -> LM:
    """The model for a config (or an arch name) with weights drawn from
    ``generator``."""
    cfg = get_config(cfg_or_name) if isinstance(cfg_or_name, str) else cfg_or_name
    return LM(cfg, device=device, generator=generator)


def cell_is_supported(name: str, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is skipped."""
    if shape.name == "long_500k" and name not in LONG_CONTEXT_OK:
        return "pure full-attention arch: 500k dense-KV decode out of scope"
    return None


def make_batch(cfg: ArchConfig, batch: int, seq: int, *,
               generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """A random batch: ``tokens`` and ``targets`` (B, S) int64 in the vocab."""
    return {key: torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                               device=device) for key in ("tokens", "targets")}


def check_arch(ap, arch: str, n_layers) -> None:
    """A CLI's ``ap.error`` unless the port builds ``arch`` and ``n_layers``
    (when given) is a whole number of its layer pattern."""
    cfg = get_config(arch)
    reason = unported_reason(cfg)
    if reason:
        ap.error(reason)
    period = len(cfg.layer_pattern())
    if n_layers is not None and (n_layers <= 0 or n_layers % period):
        ap.error(f"--n-layers {n_layers}: {arch}'s layer pattern is {period} layers long "
                 f"({', '.join(cfg.layer_pattern())}); give a multiple of it")
