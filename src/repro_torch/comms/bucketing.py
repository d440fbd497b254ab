"""Deterministic, chunk-aligned bucketing of the flat gradient space (port of
``repro.comms.bucketing``: ``BucketLayout``, ``build_layout``,
``split_buckets``, ``concat_buckets``, ``stack_buckets``,
``unstack_buckets``, ``sub_layout``).

``[0, total)`` is cut into size-targeted buckets whose interior boundaries
are multiples of the FFT chunk, so per-chunk selection is the same at any
bucket size and unpadding is exact.  The layout is a pure function of
``(total, bucket_bytes, chunk)``: every worker derives the same one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import fft as cfft

__all__ = ["BucketLayout", "build_layout", "split_buckets", "concat_buckets",
           "stack_buckets", "unstack_buckets", "sub_layout"]


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Partition of ``[0, total)``: ``boundaries`` has ``n_buckets + 1``
    entries from 0 to ``total``, strictly increasing, interior ones
    chunk-aligned."""

    total: int
    boundaries: Tuple[int, ...]
    chunk: int

    def __post_init__(self):
        b = self.boundaries
        if len(b) < 2 or b[0] != 0 or b[-1] != self.total:
            raise ValueError(f"bad boundaries {b} for total={self.total}")
        if any(lo >= hi for lo, hi in zip(b, b[1:])):
            raise ValueError(f"boundaries must be strictly increasing: {b}")
        if any(x % self.chunk for x in b[1:-1]):
            raise ValueError(f"interior boundaries must be chunk-aligned: {b}")

    @property
    def n_buckets(self) -> int:
        return len(self.boundaries) - 1

    def sizes(self) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in zip(self.boundaries, self.boundaries[1:]))

    def chunk_counts(self) -> Tuple[int, ...]:
        return tuple(-(-s // self.chunk) for s in self.sizes())

    @property
    def max_chunks(self) -> int:
        return max(self.chunk_counts())

    @property
    def padded_size(self) -> int:
        """Row width of the stacked matrix, in elements."""
        return self.max_chunks * self.chunk

    @property
    def uniform(self) -> bool:
        """Every bucket fills a full row: stack/unstack are reshapes."""
        return all(s == self.padded_size for s in self.sizes())


def build_layout(total: int, bucket_bytes: Optional[int], chunk: int = cfft.DEFAULT_CHUNK,
                 dtype_bytes: int = 4) -> BucketLayout:
    """~``bucket_bytes`` per bucket, chunk-aligned; ``None`` (or a target at
    least the buffer's size) gives one bucket.  A tail shorter than one
    chunk rides the previous bucket."""
    if total <= 0:
        raise ValueError(f"total must be positive, got {total}")
    if bucket_bytes is None or bucket_bytes >= total * dtype_bytes:
        return BucketLayout(total, (0, total), chunk)
    target = max(1, bucket_bytes // dtype_bytes)
    target = max(chunk, -(-target // chunk) * chunk)
    boundaries = list(range(0, total, target))
    if total - boundaries[-1] < chunk and len(boundaries) > 1:
        boundaries.pop()
    boundaries.append(total)
    return BucketLayout(total, tuple(boundaries), chunk)


def split_buckets(flat: torch.Tensor, layout: BucketLayout) -> List[torch.Tensor]:
    """Views of the flat buffer, one per bucket (the per-bucket loop's input)."""
    if flat.shape[0] != layout.total:
        raise ValueError(f"flat has {flat.shape[0]} elems, layout {layout.total}")
    return [flat[lo:hi] for lo, hi in zip(layout.boundaries, layout.boundaries[1:])]


def concat_buckets(parts: Sequence[torch.Tensor], layout: BucketLayout) -> torch.Tensor:
    """Inverse of :func:`split_buckets`; checks the sizes match the layout."""
    sizes = tuple(int(p.shape[0]) for p in parts)
    if sizes != layout.sizes():
        raise ValueError(f"part sizes {sizes} != layout sizes {layout.sizes()}")
    return parts[0] if len(parts) == 1 else torch.cat(list(parts))


def stack_buckets(flat: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """Flat buffer -> ``(n_buckets, padded_size)``, each bucket zero-padded on
    the right to the widest bucket's chunk-rounded width."""
    if flat.shape[0] != layout.total:
        raise ValueError(f"flat has {flat.shape[0]} elems, layout {layout.total}")
    padded = layout.padded_size
    if layout.uniform:
        return flat.reshape(layout.n_buckets, padded)
    out = flat.new_zeros((layout.n_buckets, padded))
    for b, (lo, hi) in enumerate(zip(layout.boundaries, layout.boundaries[1:])):
        out[b, : hi - lo] = flat[lo:hi]
    return out


def unstack_buckets(stacked: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """Inverse of :func:`stack_buckets`."""
    if tuple(stacked.shape) != (layout.n_buckets, layout.padded_size):
        raise ValueError(f"stacked is {tuple(stacked.shape)}, layout wants "
                         f"{(layout.n_buckets, layout.padded_size)}")
    if layout.uniform:
        return stacked.reshape(-1)
    return torch.cat([stacked[b, :s] for b, s in enumerate(layout.sizes())])


def sub_layout(layout: BucketLayout, lo_bucket: int, hi_bucket: int) -> BucketLayout:
    """The layout of buckets ``[lo_bucket, hi_bucket)`` over their own flat
    slice, re-based to 0: the same bucket boundaries, so the same payload
    codes and per-bucket quantizer fits as in the whole layout (a streamed
    dispatch group runs every flat entry point on its slice)."""
    if not 0 <= lo_bucket < hi_bucket <= layout.n_buckets:
        raise ValueError(f"bad bucket range [{lo_bucket}, {hi_bucket}) for "
                         f"{layout.n_buckets} buckets")
    base = layout.boundaries[lo_bucket]
    bounds = tuple(x - base for x in layout.boundaries[lo_bucket: hi_bucket + 1])
    return BucketLayout(bounds[-1], bounds, layout.chunk)
