"""Training-side weight-delta publisher (port of ``repro.serve.publish``).

Every ``publish_every`` committed steps the trainer diffs its live
parameters against a local REPLICA MIRROR -- the exact weights a subscriber
that has applied every published delta holds -- compresses the diff through
the same ``BucketLayout -> compress_stacked -> StackedPayload`` pipeline the
gradient exchange uses, and appends the byte-codec blob to the on-disk ring
(``serve/ring.py``).  Mirroring the subscriber instead of the previous
parameters is the DGC-style error-feedback trick (arXiv 1712.01887):
whatever the lossy codec dropped from delta v lands back in delta v+1, so a
replica's staleness is bounded by ONE delta's compression error and never
accumulates.

The replica state is the pair ``(base, spectrum_sum)``:

    weights == base + irfft(spectrum_sum)        # materialized lazily

By FFT linearity, folding a delta is one complex add of its dequantized
spectrum -- no inverse FFT -- and a replica K deltas behind catches up by
summing K spectra before ONE irfft.  Every replica (the publisher's mirror
included) folds the same spectra in the same version order onto the same
base, so on one device their materialized weights are BITWISE identical
however they batched the catch-up.  Rebase points (snapshots, every
``snapshot_every`` deltas) collapse the pair to ``(weights, 0)`` at the
same versions on every replica, so equality survives snapshot boundaries --
including the fallback that loads the snapshot file instead of rebasing
locally (the file holds the same materialized bits).

The flat vector is ``comms.reducers.flatten_tree`` of the model's leaves,
the reference's order.  On a sharded state (``DTensor`` leaves, the sharded
``pjit`` step) each leaf is gathered whole first, leaf by leaf in the
mapping's order, for the version-0 snapshot and on every publish: a
collective over the leaf's mesh.  One rank writes the ring; every other rank
runs :func:`gather_hook`, which joins the same gathers at the same cadence
and drops what they return.  The writer holds the full f32 model and the
mirror, as the reference's publisher, whose arrays are global, does.

The delta codec runs on the parameters' device through ``FFTCompressor``'s
backend: ``PublishConfig``'s default is the reference's,
``backend="reference"`` with the ``sort`` selector (plain stages).  The
training CLI passes its ``--backend`` (default ``auto``) and
``--selector`` (default ``auto``), so on the card each publish runs the
sampled threshold kernel (B4) and the fused compress kernel (B2); the
reference CLI keeps the defaults.  The selector shapes which bins a delta
keeps, not how it decodes, so the ring's manifest does not carry it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional

import torch

from repro_torch.comms import bucketing
from repro_torch.comms.reducers import flatten_tree
from repro_torch.convert import full_tensor
from repro_torch.core import fft as cfft
from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig
from repro_torch.serve.ring import RingWriter

__all__ = ["PublishConfig", "SpectrumReplicaState", "WeightDeltaPublisher", "gather_hook"]


@dataclasses.dataclass(frozen=True)
class PublishConfig:
    """Static knobs of the publish path."""

    publish_every: int = 1  # trainer steps between deltas
    capacity: int = 64  # ring depth (deltas buffered for laggards)
    snapshot_every: int = 16  # deltas between snapshots/rebase points
    theta: float = 0.0  # spectrum drop-out of the delta codec
    n_bits: int = 8
    m_bits: int = 3
    chunk: int = 4096
    bucket_bytes: int = 4 << 20
    quantize: bool = True
    backend: str = "reference"
    selector: str = "sort"

    def __post_init__(self):
        if self.publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {self.publish_every}")
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {self.snapshot_every}")
        if self.capacity < self.snapshot_every:
            # a replica that wrapped must bridge snapshot -> latest from the
            # buffered deltas alone; a shallower ring could strand it
            raise ValueError(
                f"capacity ({self.capacity}) must be >= snapshot_every "
                f"({self.snapshot_every}) so the snapshot always reaches the "
                f"buffered tail")

    def compressor_config(self) -> FFTCompressorConfig:
        return FFTCompressorConfig(
            theta=self.theta, n_bits=self.n_bits, m_bits=self.m_bits, chunk=self.chunk,
            quantize=self.quantize, backend=self.backend, selector=self.selector)


class SpectrumReplicaState:
    """The ``(base, spectrum_sum)`` pair every replica folds deltas onto.

    ``fold`` is spectrum-only (one complex add a delta, no inverse FFT);
    ``materialize`` runs the ONE irfft and caches it until the next fold;
    ``rebase`` collapses to ``(weights, 0)``.  ``decompress_count`` counts
    irfft materializations."""

    def __init__(self, base_flat, layout: bucketing.BucketLayout, comp: FFTCompressor,
                 device=None):
        self.layout = layout
        self.comp = comp
        self.base = torch.as_tensor(base_flat, dtype=torch.float32, device=device)
        self._spectrum: Optional[torch.Tensor] = None  # None == zero (no deltas since rebase)
        self._cached: Optional[torch.Tensor] = self.base
        self.decompress_count = 0

    def fold(self, payload) -> None:
        """Accumulate one delta payload's dequantized spectrum."""
        spec = self.comp.decompress_spectrum(payload)
        self._spectrum = spec if self._spectrum is None else self._spectrum + spec
        self._cached = None

    def materialize(self) -> torch.Tensor:
        """Current replica weights: base + irfft(spectrum_sum), cached."""
        if self._cached is None:
            rows = cfft.irfft_rows(self._spectrum, self.layout.chunk)
            self._cached = self.base + bucketing.unstack_buckets(rows, self.layout)
            self.decompress_count += 1
        return self._cached

    def rebase(self) -> torch.Tensor:
        """Collapse to (weights, 0): the snapshot-version contract."""
        self.base = self.materialize()
        self._spectrum = None
        self._cached = self.base
        return self.base


def _flat(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The leaves whole (a ``DTensor``'s gathered, in ``params``' order),
    flattened."""
    with torch.no_grad():
        return flatten_tree({k: full_tensor(v.detach()) for k, v in params.items()})[0]


def _join_gathers(params: Mapping[str, torch.Tensor]) -> None:
    """The gathers :func:`_flat` makes, one leaf at a time, dropped."""
    with torch.no_grad():
        for v in params.values():
            full_tensor(v.detach())


def gather_hook(init_params: Mapping[str, torch.Tensor],
                config: PublishConfig) -> Callable[[int, Dict], None]:
    """The publish hook of a rank that does not write the ring: the
    writer's publisher gathers a sharded state's leaves for the version-0
    snapshot when it is built and on every ``publish_every``-th step, so
    every other rank of the mesh joins those gathers, in the same order, and
    drops the result (plain leaves gather nothing).  Joins the version-0
    snapshot's gathers now: build it where the writer builds its publisher."""
    _join_gathers(init_params)

    def _hook(step: int, state: Dict) -> None:
        if step % config.publish_every == 0:
            _join_gathers(state["model"].leaves())
    return _hook


class WeightDeltaPublisher:
    """Appends compressed weight deltas (and periodic snapshots) to a ring.

    Owns the single ``RingWriter``; versions are monotone, one per
    published delta.  Construction writes snapshot version 0 (the initial
    weights), so a subscriber can join before the first delta exists.
    ``params`` are mappings of leaf path -> tensor (``LM.leaves()``); the
    mirror lives on their device.  ``timings`` holds one record a publish:
    ``encode_s`` (diff, compress and the blob's copy to the host, which
    waits for the card), ``write_s`` (the delta file and the manifest),
    ``snapshot_s`` (the rebase's weights to the host and their file; 0
    between snapshots) and the blob's ``bytes``."""

    def __init__(self, ring_dir: str, init_params: Mapping[str, torch.Tensor],
                 config: PublishConfig = PublishConfig(),
                 extra_meta: Optional[Dict] = None):
        self.config = config
        flat0 = _flat(init_params)
        total = int(flat0.shape[0])
        self.comp = FFTCompressor(config.compressor_config())
        self.layout = bucketing.build_layout(total, config.bucket_bytes, config.chunk)
        meta = {
            "flat_len": total,
            "bucket_bytes": int(config.bucket_bytes),
            "chunk": int(config.chunk),
            "snapshot_every": int(config.snapshot_every),
            "publish_every": int(config.publish_every),
            "compressor": {
                "theta": float(config.theta),
                "n_bits": int(config.n_bits),
                "m_bits": int(config.m_bits),
                "chunk": int(config.chunk),
                "quantize": bool(config.quantize),
                "backend": str(config.backend),
            },
        }
        if extra_meta:
            meta.update(extra_meta)
        self.writer = RingWriter(ring_dir, capacity=config.capacity, meta=meta)
        self.state = SpectrumReplicaState(flat0, self.layout, self.comp)
        self.writer.write_snapshot(self.state.base.cpu().numpy(), version=0, step=-1)
        self.delta_bytes_total = 0
        self.snapshot_bytes_total = int(4 * total)  # the v0 snapshot
        self.timings: List[Dict] = []

    @property
    def version(self) -> int:
        return self.writer.latest_version

    def publish(self, step: int, params: Mapping[str, torch.Tensor]) -> int:
        """Diff params against the replica mirror, append one delta; returns
        the new version."""
        flat = _flat(params)
        if int(flat.shape[0]) != self.layout.total:
            raise ValueError(
                f"param tree flattens to {int(flat.shape[0])} elements; "
                f"publisher was built for {self.layout.total}")
        t0 = time.perf_counter()
        delta = flat - self.state.materialize()
        del flat
        payload = self.comp.compress_stacked(
            bucketing.stack_buckets(delta, self.layout), self.layout.sizes())
        del delta
        blob = payload.to_bytes()
        t1 = time.perf_counter()
        version = self.writer.append_delta(blob, step=step, theta=self.config.theta)
        t2 = time.perf_counter()
        self.delta_bytes_total += len(blob)
        record = {"version": version, "bytes": len(blob), "encode_s": t1 - t0,
                  "write_s": t2 - t1, "snapshot_s": 0.0}
        del blob
        # fold AFTER the write: the mirror tracks what subscribers can read
        self.state.fold(payload)
        if version % self.config.snapshot_every == 0:
            t3 = time.perf_counter()
            weights = self.state.rebase()
            self.writer.write_snapshot(weights.cpu().numpy(), version=version, step=step)
            self.snapshot_bytes_total += 4 * self.layout.total
            record["snapshot_s"] = time.perf_counter() - t3
        self.timings.append(record)
        return version

    def on_step(self, step: int, params: Mapping[str, torch.Tensor]) -> Optional[int]:
        """Cadence filter: publish on every ``publish_every``-th step."""
        if step % self.config.publish_every == 0:
            return self.publish(step, params)
        return None

    def hook(self) -> Callable[[int, Dict], None]:
        """A ``TrainLoopConfig.publish_hook`` bound to this publisher: it
        publishes ``state["model"].leaves()``, skipped steps included, as
        the reference's loop does."""
        def _hook(step: int, state: Dict) -> None:
            self.on_step(step, state["model"].leaves())
        return _hook

    def close(self) -> None:
        """Mark the ring closed so tailing subscribers can exit."""
        self.writer.close()
