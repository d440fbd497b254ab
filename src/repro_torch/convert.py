"""Weight and state transfer between the reference's trees and the port.

The port keeps the reference's tree layout (one parameter per leaf, stacked
``(n_groups, ...)`` layer axis), so the transfer is a rename between nested
dict keys and dotted paths.  Arrays travel as numpy.

The train state maps onto the reference's state tree ``{"params", "opt":
{"mu"[, "nu"], "count"}, "step"[, "residual"]}`` leaf by leaf, under the
keys ``jax.tree_util.keystr`` spells (``['params']['embed']['table']``):
what ``train/checkpoint.py`` writes, so a checkpoint of either package
restores in the other.  The step and the optimizer's count are int32
scalars there; the residual is one row per worker, ``(workers, n)``.  A
sharded state's leaves are ``DTensor`` blocks: :func:`params_to_jax` and
the checkpoint gather them whole (a collective every rank makes), and
:func:`load_state_leaves` copies each rank's block of a full array into
them, whatever mesh they live on.

The encoder (``encoder.*``, ``encoder_norm``), the cross blocks
(``cross.*``) and a cross layer's ``cross_gate`` are leaves of the same
tree.  Serving caches map the same way: the reference's
``{"l{i}_{kind}": cache}`` (a ``KVCache(k, v, pos, ring)``, a cross
block's as long as the memory; a ``(KVCache, SSMState)`` pair for a hybrid
layer, a ``(self, cross)`` pair of KVCaches for ``dec_cross_mlp``, an
``MLSTMState`` or an ``SLSTMState``), each leaf with its
leading ``(n_groups,)`` axis, is the port's structure, so
:func:`caches_from_jax` is a rename by class name and field (bf16 arrays
travel as their bit patterns).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "caches_from_jax", "keystr", "state_leaves",
           "load_state_leaves", "full_tensor"]


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (numpy or anything ``np.asarray`` takes) ->
    ``state_dict`` keyed by dotted path."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, prefix=path + "."))
        else:
            out[path] = torch.from_numpy(np.array(value, copy=True))
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: dotted paths -> nested dict of
    numpy arrays."""
    out: Dict[str, Any] = {}
    for path, tensor in state_dict.items():
        node = out
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = full_tensor(tensor).detach().cpu().numpy()
    return out


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor's blocks gathered (collective), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _tensor(arr) -> torch.Tensor:
    """numpy (bf16 included, as ``ml_dtypes`` spells it) -> tensor."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def caches_from_jax(caches: Mapping[str, Any]):
    """The reference's caches (``{"l{i}_{kind}": cache}`` whose leaves are
    numpy arrays, or anything ``np.asarray`` takes) -> the port's, leaf for
    leaf: each reference cache class becomes the port's class of that name
    (``KVCache``, ``SSMState``, ``MLSTMState``, ``SLSTMState``), a pair
    stays a pair."""
    return {key: _cache_from_jax(c) for key, c in caches.items()}


def _cache_from_jax(cache):
    import dataclasses

    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMState
    from repro_torch.models.xlstm import MLSTMState, SLSTMState

    if isinstance(cache, (tuple, list)):
        return tuple(_cache_from_jax(c) for c in cache)
    cls = {c.__name__: c for c in (KVCache, SSMState, MLSTMState, SLSTMState)}[
        type(cache).__name__]
    return cls(**{f.name: bool(v) if f.name == "ring" else _tensor(v)
                  for f in dataclasses.fields(cls) for v in (getattr(cache, f.name),)})


def keystr(*parts: str) -> str:
    """A leaf key as ``jax.tree_util.keystr`` spells a path of dict keys."""
    return "".join(f"['{p}']" for p in parts)


def state_leaves(state) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
    """The port's train state as the reference's state leaves: key ->
    tensor (parameters, moments, this worker's residual row ``(1, n)``) or
    int32 scalar (step, count).  Tensors are the state's own, not copies."""
    out: Dict[str, Union[torch.Tensor, np.ndarray]] = {}
    for path, t in state["model"].leaves().items():
        out[keystr("params", *path.split("."))] = t
    opt = state["opt"]
    for moment in ("mu", "nu"):
        for path, t in opt.get(moment, {}).items():
            out[keystr("opt", moment, *path.split("."))] = t
    out[keystr("opt", "count")] = np.asarray(opt["count"], np.int32)
    out[keystr("step")] = np.asarray(state["step"], np.int32)
    if "residual" in state:
        out[keystr("residual")] = state["residual"][None]
    return out


def load_state_leaves(state, arrays: Mapping[str, np.ndarray], *, row: int = 0) -> None:
    """Copy the reference's state leaves (numpy, by key) into ``state`` in
    place: every leaf of :func:`state_leaves` must be there, others are
    ignored.  The residual takes row ``row`` of a ``(workers, n)`` array; a
    DTensor leaf takes this rank's block of the full array."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import block_of

    missing = sorted(set(state_leaves(state)) - set(arrays))
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    with torch.no_grad():
        for key, like in state_leaves(state).items():
            if key == keystr("residual"):
                arr = arrays[key]
                state["residual"].copy_(torch.from_numpy(np.asarray(arr[row] if arr.ndim == 2
                                                                    else arr)))
            elif isinstance(like, DTensor):
                full = torch.from_numpy(np.asarray(arrays[key]))
                like.to_local().copy_(block_of(full, like).to(like.dtype))
            elif isinstance(like, torch.Tensor):
                like.copy_(torch.from_numpy(np.asarray(arrays[key])).to(like.dtype))
    state["opt"]["count"] = int(arrays[keystr("opt", "count")])
    state["step"] = int(arrays[keystr("step")])
