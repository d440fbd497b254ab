"""Weights and rows from the run's seed, made on the device.

Each parameter leaf is drawn by its own ``torch.Generator`` on the device,
seeded from (run seed, leaf path): one call a leaf (a stacked leaf holds
every layer), in float32, the type the parameters are kept in.  So the
program's leaves are filled in place during set-up, and the reference, or a
reading after some steps, draws any leaf again alone.  Norm scales are ones,
biases and gates zeros, every other leaf N(0, 0.02).
"""

from __future__ import annotations

import zlib

import torch

STD = 0.02


def leaf_seed(seed: int, path: str) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (2 ** 63 - 1)


def init_kind(path: str) -> str:
    leaf = path.rsplit(".", 1)[-1]
    if leaf == "scale":
        return "ones"
    if leaf in ("bq", "bk", "bv", "cross_gate"):
        return "zeros"
    return "normal"


def fill_(t: torch.Tensor, seed: int, path: str) -> torch.Tensor:
    """``t`` (float32, contiguous) overwritten with leaf ``path``'s draw."""
    kind = init_kind(path)
    with torch.no_grad():
        if kind == "ones":
            return t.fill_(1.0)
        if kind == "zeros":
            return t.zero_()
        gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, path))
        return t.normal_(0.0, STD, generator=gen)


def leaf(seed: int, path: str, shape, device) -> torch.Tensor:
    return fill_(torch.empty(tuple(shape), dtype=torch.float32, device=device), seed, path)
