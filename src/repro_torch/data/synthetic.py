"""Deterministic synthetic streams (port of the ``markov`` kind of
``repro.data.synthetic.SyntheticStream``, and of ``ImageStream``).

``markov`` walks a fixed random first-order Markov chain over the vocab:
learnable structure whose loss falls toward log(branching).  The successor
table comes from numpy's generator seeded as in the reference (the same
table); the walks come from a ``torch.Generator`` seeded from (seed, step),
so batch ``i`` is a pure function of (seed, i) but not the reference's
batch ``i`` -- parity tests hand both packages the same tokens.  With
``frontend_dim`` a batch also carries ``frontend`` (rows, frontend_len,
frontend_dim) f32 embeddings, N(0, 1) x 0.02 drawn from the same generator
after the walk (the stub modality of an audio or vision arch).

``ImageStream`` (the convnet's data, paper Fig. 11/12 trained CNNs) draws
its class prototypes with numpy's generator at 4x4, upsamples them
bilinearly with half-pixel centres (what ``jax.image.resize(...,
"linear")`` computes when it upsamples), and draws labels and noise from a
``torch.Generator`` seeded from (seed, step, host) -- the same contract,
not the reference's values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["SyntheticConfig", "SyntheticStream", "ImageConfig", "ImageStream",
           "upsample_prototypes"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 4  # markov: candidate successors per token
    frontend_dim: int = 0  # >0: also emit frontend embeddings (stub modality)
    frontend_len: int = 0


class SyntheticStream:
    """Stateless stream: ``batch_at(step) -> {tokens, targets[, frontend]}``
    (int64, f32; on ``device``)."""

    def __init__(self, config: SyntheticConfig, device=None):
        self.config = config
        self.device = device
        rng = np.random.default_rng(config.seed)
        succ = rng.integers(0, config.vocab_size, size=(config.vocab_size, config.branching),
                            dtype=np.int32)
        self._succ = torch.from_numpy(succ.astype(np.int64))

    def batch_at(self, step: int, host_index: int = 0, num_hosts: int = 1) -> Dict:
        cfg = self.config
        rows = cfg.global_batch // num_hosts
        gen = torch.Generator().manual_seed(
            (cfg.seed * 1_000_003 + step) * 1_009 + host_index)
        start = torch.randint(0, cfg.vocab_size, (rows,), generator=gen)
        choices = torch.randint(0, cfg.branching, (cfg.seq_len, rows), generator=gen)
        seq = [start]
        for t in range(cfg.seq_len):
            seq.append(self._succ[seq[-1], choices[t]])
        toks = torch.stack(seq, dim=1)
        batch = {"tokens": toks[:, :-1].to(self.device), "targets": toks[:, 1:].to(self.device)}
        if cfg.frontend_dim:
            batch["frontend"] = (torch.randn((rows, cfg.frontend_len, cfg.frontend_dim),
                                             generator=gen) * 0.02).to(self.device)
        return batch

    def entropy_floor(self) -> float:
        """Markov chain cross-entropy floor (nats): successors may collide, so
        the floor is at most log(branching)."""
        return float(np.log(self.config.branching))


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    """Class-conditional gaussian-blob images: learnable, dataset-free."""

    n_classes: int = 10
    img_size: int = 32
    global_batch: int = 16
    seed: int = 1234
    noise: float = 0.5  # per-sample noise scale around the class prototype


def upsample_prototypes(coarse: torch.Tensor, size: int) -> torch.Tensor:
    """(classes, h, w, 3) -> (classes, size, size, 3), bilinear with
    half-pixel centres (``jax.image.resize``'s ``linear`` when upsampling)."""
    nchw = coarse.permute(0, 3, 1, 2)
    up = F.interpolate(nchw, size=(size, size), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


class ImageStream:
    """Stateless image stream with :class:`SyntheticStream`'s ``batch_at``
    contract: ``batch_at(step, host_index, num_hosts) -> {images (rows, H,
    W, 3) f32 NHWC, labels (rows,) int64}`` on ``device``, a pure function
    of (seed, step, host)."""

    def __init__(self, config: ImageConfig, device=None):
        self.config = config
        self.device = device
        # one blob per class, drawn at low resolution and upsampled so the
        # class signal is low-frequency like natural images (white-noise
        # prototypes would give conv gradients a flat spectrum no spectral
        # method compresses)
        rng = np.random.default_rng(config.seed + 1)
        coarse = rng.standard_normal((config.n_classes, 4, 4, 3)).astype(np.float32)
        self._protos = upsample_prototypes(torch.from_numpy(coarse), config.img_size) * 2.0

    def batch_at(self, step: int, host_index: int = 0, num_hosts: int = 1) -> Dict:
        cfg = self.config
        rows = cfg.global_batch // num_hosts
        gen = torch.Generator().manual_seed(
            (cfg.seed * 1_000_003 + step) * 1_009 + host_index)
        labels = torch.randint(0, cfg.n_classes, (rows,), generator=gen)
        noise = torch.randn((rows, cfg.img_size, cfg.img_size, 3), generator=gen)
        images = self._protos[labels] + cfg.noise * noise
        return {"images": images.to(self.device), "labels": labels.to(self.device)}

    def entropy_floor(self) -> float:
        """Bayes loss is near 0 once prototypes separate; report 0."""
        return 0.0
