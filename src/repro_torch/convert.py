"""Weight transfer between the reference's parameter tree and the port.

The port keeps the reference's tree layout (one parameter per leaf, stacked
``(n_groups, ...)`` layer axis), so the transfer is a rename between nested
dict keys and dotted paths.  Arrays travel as numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]


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
        node[leaf] = tensor.detach().cpu().numpy()
    return out
