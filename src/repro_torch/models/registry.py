"""Architecture registry (port of ``repro.models.registry``): name ->
ArchConfig -> LM, the long-context cells, and small concrete batches.

``make_batch`` draws its tokens, and the ``frontend`` embeddings of the
archs that take them (audio frames as long as the sequence, or a vision
arch's patches), from a ``torch.Generator``: the same contract as the
reference's, not its ``jax.random`` bits.  ``input_specs`` gives a cell's
step inputs as tensors that hold no storage (``meta`` tensors, or fakes
under the caller's ``FakeTensorMode``): what ``launch/dryrun.py`` traces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_NAMES, ArchConfig, ShapeConfig, get_config
from repro_torch.models.transformer import LM, init_caches

__all__ = ["ARCH_NAMES", "LONG_CONTEXT_OK", "get_config", "build", "cell_is_supported",
           "make_batch", "check_arch", "frontend_len", "with_depth", "input_specs"]

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


def frontend_len(cfg: ArchConfig, seq_len: int) -> int:
    """Frontend positions of a batch of ``seq_len`` tokens (the reference's
    ``_frontend_len``): audio frames track the sequence, a vision arch has
    ``n_frontend_tokens`` patches (1601 when unset), others none."""
    if cfg.frontend == "audio_frames":
        return seq_len
    if cfg.frontend == "vision_patches":
        return cfg.n_frontend_tokens or 1601
    return 0


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, device="meta") -> Dict:
    """The (train | prefill | decode) step's inputs for a cell, as the
    reference's ``input_specs`` names and types them, holding no storage:
    ``tokens`` and ``targets`` (B, S) int32 and, for an arch with a
    frontend, ``frontend`` (B, frontend_len, d_model) f32; decode has
    ``caches`` (the port's ``init_caches`` at the cell's sequence length),
    ``token`` (B, 1) int32 and ``pos`` () int32.  ``device="meta"``
    allocates nothing; under a ``FakeTensorMode`` any device gives fakes."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def empty(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":
        return {"caches": init_caches(cfg, b, s, device=device), "token": empty(b, 1),
                "pos": empty()}
    specs = {"tokens": empty(b, s)}
    if shape.kind == "train":
        specs["targets"] = empty(b, s)
    fl = frontend_len(cfg, s)
    if fl:
        specs["frontend"] = empty(b, fl, cfg.d_model, dtype=torch.float32)
    return specs


def with_depth(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    """``cfg`` cut (or grown) to ``n_layers`` decoder layers at full width;
    an enc-dec arch's encoder gets as many (the CLIs' ``--n-layers``, a
    flag of the port's own)."""
    changes = {"n_layers": int(n_layers)}
    if cfg.n_encoder_layers:
        changes["n_encoder_layers"] = int(n_layers)
    return dataclasses.replace(cfg, **changes)


def make_batch(cfg: ArchConfig, batch: int, seq: int, *,
               generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """A random batch: ``tokens`` and ``targets`` (B, S) int64 in the vocab,
    and for an arch with a frontend ``frontend`` (B, frontend_len, d_model)
    f32, N(0, 1) x 0.02."""
    out = {key: torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                              device=device) for key in ("tokens", "targets")}
    fl = frontend_len(cfg, seq)
    if fl:
        out["frontend"] = torch.randn((batch, fl, cfg.d_model), generator=generator,
                                      device=device) * 0.02
    return out


def check_arch(ap, arch: str, n_layers) -> None:
    """A CLI's ``ap.error`` unless ``n_layers`` (when given) is a whole
    number of ``arch``'s layer pattern."""
    cfg = get_config(arch)
    period = len(cfg.layer_pattern())
    if n_layers is not None and (n_layers <= 0 or n_layers % period):
        ap.error(f"--n-layers {n_layers}: {arch}'s layer pattern is {period} layers long "
                 f"({', '.join(cfg.layer_pattern())}); give a multiple of it")
