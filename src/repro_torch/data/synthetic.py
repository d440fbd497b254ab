"""Deterministic synthetic token stream (port of the ``markov`` kind of
``repro.data.synthetic.SyntheticStream``).

``markov`` walks a fixed random first-order Markov chain over the vocab:
learnable structure whose loss falls toward log(branching).  The successor
table comes from numpy's generator seeded as in the reference (the same
table); the walks come from a ``torch.Generator`` seeded from (seed, step),
so batch ``i`` is a pure function of (seed, i) but not the reference's
batch ``i`` -- parity tests hand both packages the same tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["SyntheticConfig", "SyntheticStream"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 4  # markov: candidate successors per token


class SyntheticStream:
    """Stateless stream: ``batch_at(step) -> {tokens, targets}`` (int64, on
    ``device``)."""

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
        return {"tokens": toks[:, :-1].to(self.device), "targets": toks[:, 1:].to(self.device)}
