"""Gradient reducers (port of ``repro.comms.reducers``: ``flatten_tree``,
``unflatten_tree``, the ``ReducerConfig`` fields the exchange uses, and
``make_reducer``).

Kinds: ``dense`` (the mean over the group, the paper's "orig" baseline: one
SUM all_reduce divided by the world size, as ``pmean``), ``fft`` (the
paper's compressed exchange), ``timedomain`` (top-k of the raw values,
Fig. 12), ``terngrad`` and ``qsgd`` (Table I).  The compressed kinds run
with and without error feedback over the transports of
``comms/transport.py``.

A gradient tree here is a mapping from dotted parameter paths to tensors
(``"layers.l0_attn_local_mlp.attn.wq"``).  :func:`flatten_tree` walks it in
the reference's leaf order -- JAX flattens nested dicts by sorted key at
every level, which is the order of the paths as tuples of their parts -- so
bucket boundaries, per-bucket quantizer fits and the error-feedback residual
cover the same coefficients in both packages.

The ``hierarchical`` kind, the scheduler, calibration, faults, validation
and the degradation ladder are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comms import bucketing
from repro_torch.comms.transport import TRANSPORT_NAMES, get_transport
from repro_torch.core import baselines
from repro_torch.core.compressor import (FFTCompressor, FFTCompressorConfig,
                                         TimeDomainCompressor)
from repro_torch.core.selection import SELECTOR_NAMES
from repro_torch.dist_util import world_size
from repro_torch.kernels.engine import BACKEND_NAMES

__all__ = ["ReducerConfig", "make_reducer", "dense_mean", "flatten_tree", "unflatten_tree",
           "leaf_order", "residual_size", "REDUCER_KINDS"]

REDUCER_KINDS = ("dense", "fft", "timedomain", "terngrad", "qsgd", "hierarchical")

LeafSpec = Tuple[str, torch.Size, torch.dtype]


def leaf_order(names) -> List[str]:
    """Dotted paths in the reference's flatten order (sorted as tuples)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def flatten_tree(tree: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, List[LeafSpec]]:
    """Concatenate all leaves into one f32 vector -> (flat, specs)."""
    specs, parts = [], []
    for name in leaf_order(tree.keys()):
        leaf = tree[name]
        specs.append((name, leaf.shape, leaf.dtype))
        parts.append(leaf.reshape(-1).float())
    return torch.cat(parts), specs


def unflatten_tree(flat: torch.Tensor, specs: List[LeafSpec]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_tree` (leaves are views of ``flat`` when the
    dtype is already f32)."""
    out, offset = {}, 0
    for name, shape, dtype in specs:
        size = shape.numel()
        out[name] = flat[offset: offset + size].reshape(shape).to(dtype)
        offset += size
    return out


def residual_size(params: Mapping[str, torch.Tensor]) -> int:
    """Flat residual length for error-feedback state."""
    return sum(p.numel() for p in params.values())


@dataclasses.dataclass(frozen=True)
class ReducerConfig:
    """The reference's reducer knobs that the ported exchange reads; the
    schedule, calibration and resilience knobs are not ported yet."""

    kind: str = "dense"
    theta: float = 0.7
    n_bits: int = 8
    m_bits: int = 3
    chunk: int = 4096
    quantize: bool = True
    range_mode: str = "auto"  # "fixed": every fit uses fixed_range
    fixed_range: Tuple[float, float] = (-1.0, 1.0)
    error_feedback: bool = False
    bucket_bytes: Optional[int] = None  # None: one monolithic bucket
    transport: str = "allgather"  # allgather | sequenced | psum (the ported ones)
    backend: str = "reference"
    # batched bucket executor: every bucket in one batched pass and one
    # StackedPayload per exchange; False runs the per-bucket loop
    stacked: bool = True
    selector: str = "sort"
    sample_rate: float = 1.0 / 64.0
    tau_refine_iters: int = 16

    def __post_init__(self):
        if self.kind not in REDUCER_KINDS:
            raise ValueError(f"unknown reducer kind {self.kind!r}; expected one of "
                             f"{REDUCER_KINDS}")
        if self.selector not in SELECTOR_NAMES:
            raise ValueError(
                f"unknown selector {self.selector!r}; expected one of {SELECTOR_NAMES}")
        if self.transport not in TRANSPORT_NAMES + ("auto",):
            raise ValueError(f"unknown transport {self.transport!r}; expected one of "
                             f"{TRANSPORT_NAMES + ('auto',)}")
        if self.bucket_bytes is not None and self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got {self.bucket_bytes}")
        if self.backend not in BACKEND_NAMES:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKEND_NAMES}")

    def compressor_config(self) -> FFTCompressorConfig:
        return FFTCompressorConfig(
            theta=self.theta, n_bits=self.n_bits, m_bits=self.m_bits, chunk=self.chunk,
            quantize=self.quantize, range_mode=self.range_mode, fixed_range=self.fixed_range,
            backend=self.backend, selector=self.selector,
            sample_rate=self.sample_rate, tau_refine_iters=self.tau_refine_iters)

    def layout_for(self, total: int) -> bucketing.BucketLayout:
        return bucketing.build_layout(total, self.bucket_bytes, self.chunk)


def dense_mean(grads: Mapping[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The mean of every worker's gradient tree: ONE SUM all_reduce of the
    flattened tree, divided by the world size (``pmean`` divides, it does not
    multiply by 1/P).  With one worker the tree comes back as it is, and no
    collective runs."""
    world = world_size(group)
    if world == 1:
        return dict(grads)
    flat, specs = flatten_tree(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return unflatten_tree(flat / world, specs)


def _make_compressor(config: ReducerConfig):
    if config.kind == "fft":
        return FFTCompressor(config.compressor_config())
    if config.kind == "timedomain":
        return TimeDomainCompressor(config.compressor_config())
    if config.kind == "terngrad":
        return baselines.TernGrad()
    if config.kind == "qsgd":
        return baselines.QSGD()
    raise NotImplementedError(
        f"reducer kind {config.kind!r} is not ported yet; see ROADMAP.md")


def make_reducer(config: ReducerConfig, group=None):
    """Returns the reduce function of ``config.kind``.

    ``dense``: ``reduce(grads) -> mean_grads``; it raises with error
    feedback, which has nothing to accumulate.  The compressed kinds:
    without error feedback ``reduce(grads) -> mean_grads``; with it
    ``reduce(grads, residual) -> (mean_grads, residual')`` where
    ``residual' = corrected - local_roundtrip(corrected)`` and
    ``corrected = flat(grads) + residual``.

    ``group`` is the ``torch.distributed`` group the mean runs over (the
    default group when one is initialized, else one worker)."""
    if config.kind == "dense":
        if config.error_feedback:
            raise ValueError("error feedback is meaningless for dense reduction")
        return lambda grads: dense_mean(grads, group)
    comp = _make_compressor(config)
    transport = get_transport(config.transport)

    def _run(flat, local: bool):
        return transport.run(flat, comp=comp, layout=config.layout_for(flat.shape[0]),
                             local=local, group=group, stacked=config.stacked)

    def compressed_reduce(grads):
        flat, specs = flatten_tree(grads)
        return unflatten_tree(_run(flat, local=False), specs)

    if not config.error_feedback:
        return compressed_reduce

    def ef_reduce(grads, residual_flat):
        flat, specs = flatten_tree(grads)
        corrected = flat.add_(residual_flat)  # flat is a fresh buffer
        local_hat = _run(corrected, local=True)
        new_residual = corrected - local_hat
        del local_hat
        mean_flat = _run(corrected, local=False)
        return unflatten_tree(mean_flat, specs), new_residual

    return ef_reduce
