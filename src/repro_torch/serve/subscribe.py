"""Serving-side replica subscriber (port of ``repro.serve.subscribe``).

Tails a delta ring (``serve/ring.py``) and folds each compressed delta into
the same ``(base, spectrum_sum)`` replica state the publisher mirrors
(``serve/publish.py``).  The subscriber never compresses: it dequantizes
spectra, sums them (FFT linearity), and runs ONE inverse FFT a
materialization however many deltas the sync covered.

Catch-up ladder, per ``sync()``:

1. up to date -- nothing to do;
2. the buffered deltas reach back to our version -- replay them in version
   order (spectrum adds only), rebase locally at every ``snapshot_every``
   boundary (the publisher's versions, so bitwise the same collapse), one
   irfft at the end;
3. GAP -- the ring's tail wrapped past ``version + 1``: reload the latest
   snapshot (``gap_detected``/``snapshot_loads`` in the stats), then replay
   the buffered deltas after it.  ``capacity >= snapshot_every`` (enforced
   by ``PublishConfig``) guarantees the snapshot reaches the tail.

The decompression pipeline (compressor config and bucket layout) is rebuilt
from the manifest's ``meta`` block: a subscriber process needs the ring
directory and nothing else.  A ring of either package reads here; the
reference's backend name ``"pallas"`` reads as ``"cuda"`` (every backend
decodes a payload's spectrum the same way).  The replica state lives on the
subscriber's device: ``cuda`` unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.comms import bucketing
from repro_torch.comms.reducers import leaf_order, unflatten_tree
from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig, StackedPayload
from repro_torch.serve.publish import SpectrumReplicaState
from repro_torch.serve.ring import RingReader

__all__ = ["SyncStats", "ReplicaSubscriber"]

# backend names of the reference's rings -> the port's
_BACKEND_ALIASES = {"pallas": "cuda"}


@dataclasses.dataclass
class SyncStats:
    """What one ``sync()`` call did."""

    applied: int = 0  # deltas folded this sync
    decompress_count: int = 0  # irfft materializations this sync
    rebases: int = 0  # local snapshot-boundary collapses
    snapshot_loads: int = 0  # full-weight fallbacks (gap path)
    gap_detected: bool = False
    bytes_read: int = 0
    version: int = 0  # replica version after the sync
    closed: bool = False  # publisher marked the stream finished


class ReplicaSubscriber:
    """One serving replica's view of the ring."""

    def __init__(self, ring_dir: str, device=None):
        self.device = device_mod.resolve(device)
        self.reader = RingReader(ring_dir)
        manifest = self.reader.manifest()
        meta = manifest["meta"]
        comp_cfg = dict(meta["compressor"])
        comp_cfg["backend"] = _BACKEND_ALIASES.get(comp_cfg.get("backend"),
                                                   comp_cfg.get("backend", "reference"))
        self.comp = FFTCompressor(FFTCompressorConfig(**comp_cfg))
        self.layout = bucketing.build_layout(
            int(meta["flat_len"]), int(meta["bucket_bytes"]), int(meta["chunk"]))
        self.snapshot_every = int(meta["snapshot_every"])
        self.meta = meta
        version, _, flat = self.reader.read_snapshot(manifest)
        self.state = self._state(flat)
        self.version = version

    def _state(self, flat) -> SpectrumReplicaState:
        return SpectrumReplicaState(torch.from_numpy(flat), self.layout, self.comp,
                                    device=self.device)

    # -- catch-up ------------------------------------------------------------

    def sync(self) -> SyncStats:
        """Fold every ring delta newer than ``self.version``; one irfft."""
        stats = SyncStats()
        count0 = self.state.decompress_count
        manifest = self.reader.manifest()
        stats.closed = bool(manifest.get("closed", False))
        latest = int(manifest["latest_version"])
        if latest > self.version:
            tail = self.reader.tail_version(manifest)
            start = self.version + 1
            if tail is None or start < tail:
                # the ring wrapped past us: snapshot fallback
                stats.gap_detected = True
                snap_v, _, flat = self.reader.read_snapshot(manifest)
                if tail is not None and snap_v + 1 < tail:
                    raise RuntimeError(
                        f"ring wrapped past its own snapshot (snapshot v{snap_v}, tail "
                        f"v{tail}): capacity < snapshot_every?")
                self.state = self._state(flat)
                count0 = 0  # fresh state: its counter restarts at zero
                self.version = snap_v
                stats.snapshot_loads += 1
                stats.bytes_read += 4 * self.layout.total
                start = snap_v + 1
            for v in range(start, latest + 1):
                blob = self.reader.read_delta(manifest, v)
                stats.bytes_read += len(blob)
                self.state.fold(StackedPayload.from_bytes(blob, self.device))
                stats.applied += 1
                self.version = v
                if v % self.snapshot_every == 0:
                    # the publisher collapsed (base, S) at this version;
                    # collapse identically so bitwise equality survives the
                    # boundary (no file read: the rebase is local)
                    self.state.rebase()
                    stats.rebases += 1
            self.state.materialize()  # the ONE catch-up irfft
        stats.decompress_count = self.state.decompress_count - count0
        stats.version = self.version
        return stats

    def follow(self, *, poll_s: float = 0.2, timeout_s: Optional[float] = None,
               on_sync=None) -> int:
        """Tail the ring until the publisher closes it; returns the final
        version.  ``on_sync(stats)`` fires after every sync that advanced."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            stats = self.sync()
            if on_sync is not None and stats.applied:
                on_sync(stats)
            if stats.closed and stats.version >= 0 and stats.applied == 0:
                return self.version
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ring not closed after {timeout_s}s (at v{self.version})")
            if stats.applied == 0:
                time.sleep(poll_s)

    # -- weight access -------------------------------------------------------

    def weights(self) -> torch.Tensor:
        """Flat f32 replica weights at ``self.version`` (cached), on the
        subscriber's device."""
        return self.state.materialize()

    def params_like(self, params_template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Unflatten :meth:`weights` into the template's leaves (leaf path ->
        tensor, views of the flat weights where the dtype is f32)."""
        specs = [(name, params_template[name].shape, params_template[name].dtype)
                 for name in leaf_order(params_template.keys())]
        return unflatten_tree(self.weights(), specs)
