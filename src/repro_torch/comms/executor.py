"""Entry points of the batched bucket executor (port of
``repro.comms.executor``), as thin calls into ``comms/transport.py``.

The reference caches one jitted executable per (entry point, compressor
class, compressor config, bucket layout) for the callers that drive
compression from Python (benchmarks, smoke runs, error-feedback probes).
PyTorch runs eagerly here and the port does not use ``torch.compile``, so
there is nothing to compile and nothing to cache: each entry point returns
a closure over the transport's own compress and roundtrip, the code the
train step runs, which launches the kernels on the card.  The reference's
``cache_size`` and ``clear_cache`` have no counterpart.  There is no buffer
donation: every call allocates its outputs and leaves its input intact.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.comms import bucketing, transport

__all__ = ["compress_fn", "roundtrip_fn", "looped_compress_fn", "streamed_compress_fn",
           "streamed_roundtrip_fn"]


def compress_fn(comp, layout: bucketing.BucketLayout) -> Callable:
    """flat -> ``StackedPayload``: one batched compress of every bucket."""
    return lambda flat: transport._compress_stacked(flat, layout, comp)


def roundtrip_fn(comp, layout: bucketing.BucketLayout) -> Callable:
    """flat -> flat reconstruction through the stacked compress ->
    decompress (what error feedback accumulates against)."""
    return lambda flat: transport._stacked_roundtrip(flat, layout, comp)


def looped_compress_fn(comp, layout: bucketing.BucketLayout) -> Callable:
    """flat -> per-bucket payloads through the per-bucket loop."""
    return lambda flat: transport._compress_all(bucketing.split_buckets(flat, layout), comp)


def streamed_compress_fn(comp, plan) -> Callable:
    """flat -> one ``StackedPayload`` per readiness group, in readiness
    order."""
    return lambda flat: [transport._compress_stacked(flat[lo:hi], sub, comp)
                         for lo, hi, sub in plan.group_slices()]


def streamed_roundtrip_fn(comp, plan) -> Callable:
    """flat -> flat reconstruction at the streamed dispatch granularity:
    one stacked roundtrip per readiness group, reassembled in index order
    (``Transport.run(plan=..., local=True)``)."""
    return lambda flat: transport.get_transport("sequenced").run(flat, comp=comp, plan=plan,
                                                                 local=True)
