"""Checkpoints: atomic, verified, resumable (port of ``repro.train.checkpoint``).

Layout per checkpoint, the reference's own:  ``<dir>/step_<N>/``
    manifest.json   -- leaf keys, shapes, dtypes, per-array sha256 digests
    arrays.npz      -- every leaf, on the host

Leaf keys are the reference's (``['params']['embed']['table']``,
``['opt']['mu'][...]``, ``['opt']['count']``, ``['step']``,
``['residual']``; ``convert.state_leaves``), so a checkpoint written by
either package restores in the other.  The residual is saved as one row per
worker, ``(workers, n)``: in a process group the rows are gathered over
``row_group`` (the ranks of the residual's workers -- on a mesh, the group
of ``step.residual_axes``; by default every rank) and rank 0 writes; every
rank restores its own row (``row``, by default its rank).  A sharded
state's ``DTensor`` leaves are written whole (every rank joins the gather)
and restored as each rank's block of the full array, on whatever mesh the
state to restore into lives: the reference's elastic remesh.

* atomic: written to ``step_<N>.tmp`` and renamed; a ``.tmp`` left by a
  dead writer is invisible to :func:`latest_step` and :func:`restore`;
* verified: :func:`restore` re-hashes every array and, when the newest
  checkpoint fails, warns and falls back to the previous step;
* async: ``save(block=False)`` snapshots the state to the host before it
  returns (the port updates its state in place) and writes on a tracked
  thread, which the next ``save``, ``restore``, the manager's GC and
  :func:`wait` join first.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.dist_util import rank_and_world

__all__ = ["save", "restore", "latest_step", "wait", "CheckpointError", "CheckpointManager"]


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot be trusted (digest mismatch, torn
    archive).  A ``RuntimeError``, so the loop's recovery may absorb it."""


_STEP_RE = re.compile(r"^step_(\d+)$")
_RESIDUAL = convert.keystr("residual")

_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT: Optional[threading.Thread] = None


def wait() -> None:
    """Join the in-flight async save, if any."""
    with _INFLIGHT_LOCK:
        t = _INFLIGHT
    if t is not None:
        t.join()


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()


def _host(value) -> np.ndarray:
    """A host copy that later in-place updates of the state cannot touch."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value, copy=True)


def _gather_rows(row: torch.Tensor, world: int, group) -> torch.Tensor:
    """(1, n) on every rank -> (world, n) in rank order."""
    out = row.new_empty((world,) + tuple(row.shape[1:]))
    dist.all_gather_into_tensor(out, row.contiguous(), group=group)
    return out


def save(directory: str, step: int, state, *, block: bool = True, group=None,
         row_group=None) -> str:
    """Write ``state`` atomically; returns the final checkpoint path (with
    ``block=False`` it exists once the next save, restore or :func:`wait`
    has joined the writer)."""
    global _INFLIGHT
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    rank, world = rank_and_world(group)
    leaves = {k: convert.full_tensor(v) if isinstance(v, torch.Tensor) else v
              for k, v in convert.state_leaves(state).items()}
    row_group = group if row_group is None else row_group
    rows = rank_and_world(row_group)[1]
    if rows > 1 and _RESIDUAL in leaves:
        leaves[_RESIDUAL] = _gather_rows(leaves[_RESIDUAL], rows, row_group)
    if rank != 0:
        return final
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _host(v) for k, v in leaves.items()}
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)} for k, a in arrays.items()},
        "digests": {k: _digest(a) for k, a in arrays.items()},
    }

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    wait()  # never two writers in flight
    if block:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        with _INFLIGHT_LOCK:
            _INFLIGHT = t
        t.start()
    return final


def _step_numbers(directory: str):
    """Sorted steps of complete checkpoints; ``.tmp`` leftovers and other
    names are ignored."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.isdir(os.path.join(directory, d)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _step_numbers(directory)
    return steps[-1] if steps else None


def _load_verified(directory: str, step: int):
    """Load and digest-check one checkpoint; CheckpointError when the archive
    is torn or an array's sha256 disagrees with the manifest."""
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except Exception as e:  # torn zip, truncated json, interrupted GC, ...
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    for k, want in (manifest.get("digests") or {}).items():
        if k not in arrays:
            raise CheckpointError(f"{path}: manifest names missing leaf {k}")
        if _digest(arrays[k]) != want:
            raise CheckpointError(f"{path}: digest mismatch on {k} (corrupt array)")
    return arrays


def restore(directory: str, state, *, step: Optional[int] = None, group=None,
            row: Optional[int] = None):
    """Restore into ``state`` in place -> ``(state, step)``; the residual
    takes row ``row`` (default: this rank's).

    Every array is verified against its digest; without an explicit
    ``step``, a newest checkpoint that fails is skipped with a warning for
    the one before it."""
    wait()
    rank, world = rank_and_world(group)
    if world > 1:
        dist.barrier(group=group)  # rank 0's writer has finished
    if step is not None:
        candidates = [step]
    else:
        candidates = list(reversed(_step_numbers(directory)))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    last_err: Optional[Exception] = None
    for s in candidates:
        try:
            arrays = _load_verified(directory, s)
        except CheckpointError as e:
            last_err = e
            if step is not None:
                raise
            warnings.warn(f"checkpoint step {s} failed verification ({e}); "
                          f"falling back to the previous step")
            continue
        convert.load_state_leaves(state, arrays, row=rank if row is None else row)
        return state, s
    raise CheckpointError(f"no verifiable checkpoint under {directory}") from last_err


class CheckpointManager:
    """Saves every ``every`` steps and keeps the last ``keep``."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_save: bool = False, group=None, row_group=None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self.group = group
        self.row_group = row_group

    def maybe_save(self, step: int, state) -> Optional[str]:
        if step % self.every != 0:
            return None
        path = save(self.directory, step, state, block=not self.async_save, group=self.group,
                    row_group=self.row_group)
        self._gc()
        return path

    def wait(self) -> None:
        wait()

    def _gc(self):
        if rank_and_world(self.group)[0] != 0:
            return
        wait()  # never race a rename; the newest must be visible first
        for s in _step_numbers(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
