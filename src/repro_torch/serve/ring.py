"""Versioned on-disk ring buffer of compressed weight deltas (the port's own
copy of ``repro.serve.ring``, byte-compatible with it: a ring written by
either package reads in the other).

The publisher/subscriber boundary is a DIRECTORY, not a socket: the training
job appends compressed delta payloads (``core.bytecodec`` blobs) plus
periodic dense snapshots, and any number of serving replicas tail the
directory from separate processes with no coordination beyond the
filesystem.  Layout:

    <ring_dir>/
      manifest.json        the only mutable file (written atomically)
      delta_0000042.rpay   bytecodec blob of delta version 42
      snapshot_0000040.f32 raw little-endian f32 flat weights at version 40

Consistency contract: payload/snapshot files are fully written and fsynced
BEFORE the manifest that references them is swapped into place
(tmp + ``os.replace``), so a reader that loads the manifest never sees a
torn entry; a reader that loads a file evicted after its manifest read gets
a clean ``FileNotFoundError`` and simply re-reads the manifest.  Versions
are monotone (one per delta, starting at 1); the ring holds the most recent
``capacity`` deltas and the most recent snapshot -- older delta files are
unlinked on eviction.

The manifest's ``meta`` block carries everything a subscriber needs to
rebuild the decompression pipeline with no side channel: the flat length,
the bucket layout parameters, the compressor config, and the snapshot
cadence (the subscriber rebases at the same versions the publisher does --
see serve/subscribe.py).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["RingWriter", "RingReader", "RING_FORMAT_VERSION", "MANIFEST_NAME"]

RING_FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"


def _delta_name(version: int) -> str:
    return f"delta_{version:07d}.rpay"


def _snapshot_name(version: int) -> str:
    return f"snapshot_{version:07d}.f32"


def _write_file(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class RingWriter:
    """Single-writer append side of the ring (the training job owns it)."""

    def __init__(self, ring_dir: str, *, capacity: int, meta: dict):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.ring_dir = str(ring_dir)
        self.capacity = int(capacity)
        os.makedirs(self.ring_dir, exist_ok=True)
        self._manifest = {
            "format_version": RING_FORMAT_VERSION,
            "capacity": self.capacity,
            "latest_version": 0,
            "closed": False,
            "meta": dict(meta),
            "deltas": [],  # oldest -> newest, at most `capacity` entries
            "snapshot": None,  # {"version", "step", "path", "nbytes"}
        }
        self._flush_manifest()

    # -- internals ----------------------------------------------------------

    def _flush_manifest(self) -> None:
        _write_file(os.path.join(self.ring_dir, MANIFEST_NAME),
                    json.dumps(self._manifest, indent=1).encode("utf-8"))

    # -- append API ---------------------------------------------------------

    @property
    def latest_version(self) -> int:
        return self._manifest["latest_version"]

    def append_delta(self, blob: bytes, *, step: int, theta: float) -> int:
        """Write one compressed delta; returns its (monotone) version."""
        if self._manifest["closed"]:
            raise RuntimeError("ring is closed")
        version = self._manifest["latest_version"] + 1
        name = _delta_name(version)
        _write_file(os.path.join(self.ring_dir, name), blob)
        self._manifest["deltas"].append(
            {"version": version, "step": int(step), "path": name,
             "nbytes": len(blob), "theta": float(theta)})
        evicted = self._manifest["deltas"][:-self.capacity]
        self._manifest["deltas"] = self._manifest["deltas"][-self.capacity:]
        self._manifest["latest_version"] = version
        self._flush_manifest()  # manifest stops referencing evictees first
        for entry in evicted:
            try:
                os.unlink(os.path.join(self.ring_dir, entry["path"]))
            except FileNotFoundError:
                pass
        return version

    def write_snapshot(self, flat: np.ndarray, *, version: int,
                       step: int) -> None:
        """Dense f32 weights AT ``version`` (after that delta was applied)."""
        if self._manifest["closed"]:
            raise RuntimeError("ring is closed")
        # written from the array's own buffer: no bytes copy of a
        # multi-GB vector (the file's bytes are the reference's)
        data = memoryview(np.ascontiguousarray(flat, dtype="<f4")).cast("B")
        name = _snapshot_name(version)
        _write_file(os.path.join(self.ring_dir, name), data)
        old = self._manifest["snapshot"]
        self._manifest["snapshot"] = {
            "version": int(version), "step": int(step), "path": name,
            "nbytes": data.nbytes}
        self._flush_manifest()
        if old is not None and old["path"] != name:
            try:
                os.unlink(os.path.join(self.ring_dir, old["path"]))
            except FileNotFoundError:
                pass

    def close(self) -> None:
        """Mark the stream finished: tailing subscribers can exit."""
        if not self._manifest["closed"]:
            self._manifest["closed"] = True
            self._flush_manifest()


class RingReader:
    """Read side: re-reads the manifest on demand (any number of these)."""

    def __init__(self, ring_dir: str):
        self.ring_dir = str(ring_dir)

    def manifest(self) -> dict:
        path = os.path.join(self.ring_dir, MANIFEST_NAME)
        with open(path, "rb") as f:
            m = json.loads(f.read().decode("utf-8"))
        version = m.get("format_version")
        if version != RING_FORMAT_VERSION:
            raise ValueError(
                f"unsupported ring format version {version!r} "
                f"(this reader supports {RING_FORMAT_VERSION})")
        return m

    def read_delta(self, manifest: dict, version: int) -> bytes:
        for entry in manifest["deltas"]:
            if entry["version"] == version:
                with open(os.path.join(self.ring_dir, entry["path"]),
                          "rb") as f:
                    return f.read()
        raise KeyError(f"delta version {version} is not in the ring "
                       f"(tail has wrapped past it)")

    def read_snapshot(self, manifest: dict) -> Tuple[int, int, np.ndarray]:
        """-> (version, step, flat f32 weights)."""
        snap = manifest.get("snapshot")
        if snap is None:
            raise KeyError("ring has no snapshot yet")
        flat = np.fromfile(os.path.join(self.ring_dir, snap["path"]), dtype="<f4")
        return int(snap["version"]), int(snap["step"]), flat

    def tail_version(self, manifest: dict) -> Optional[int]:
        """Oldest delta version still buffered (None when the ring is empty)."""
        deltas = manifest["deltas"]
        return int(deltas[0]["version"]) if deltas else None
