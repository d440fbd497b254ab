"""SGD with momentum and AdamW with bias correction (port of
``repro.optim.optimizers``).

The reference returns new trees; the port updates the parameters and the
moments IN PLACE (at full width each tree is 3.6 GB, and a second copy per
step buys nothing), with the reference's expressions and their rounding:
``sgd``: ``mu = momentum*mu + g``, ``p = p - lr*(mu + wd*p)``; ``adamw``:
``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu + (1-b2)*g*g``,
``p = p - lr*(mhat/(sqrt(vhat)+eps) + wd*p)`` with the bias corrections
``1 - b**count`` computed in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch

from repro_torch import tracing

__all__ = ["OptConfig", "init_opt_state", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | sgd
    lr: float = 3e-4  # base lr; the schedule multiplies
    momentum: float = 0.9  # sgd
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0


def init_opt_state(config: OptConfig, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    zeros = lambda: {k: torch.zeros_like(v, memory_format=torch.contiguous_format)
                     for k, v in params.items()}
    if config.kind == "sgd":
        return {"mu": zeros(), "count": 0}
    if config.kind == "adamw":
        return {"mu": zeros(), "nu": zeros(), "count": 0}
    raise ValueError(f"unknown optimizer {config.kind!r}")


@torch.no_grad()
def apply_updates(config: OptConfig, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                  lr_scale: float = 1.0) -> None:
    """One optimizer step, in place on ``params`` and ``state``."""
    with tracing.span("optim.update"):
        _apply_updates(config, params, grads, state, lr_scale)


def _apply_updates(config: OptConfig, params, grads, state, lr_scale: float) -> None:
    count = state["count"] + 1
    lr = config.lr * lr_scale
    if config.kind == "sgd":
        for name, p in params.items():
            m = state["mu"][name]
            m.mul_(config.momentum).add_(grads[name])
            p.sub_(lr * (m + config.weight_decay * p))
        state["count"] = count
        return
    c = torch.tensor(float(count), dtype=torch.float32)
    b1c = float(1.0 - torch.tensor(config.b1, dtype=torch.float32) ** c)
    b2c = float(1.0 - torch.tensor(config.b2, dtype=torch.float32) ** c)
    for name, p in params.items():
        g = grads[name]
        m, v = state["mu"][name], state["nu"][name]
        m.mul_(config.b1).add_(g * (1 - config.b1))
        v.mul_(config.b2).add_((g * g) * (1 - config.b2))
        upd = (m / b1c) / (torch.sqrt(v / b2c) + config.eps) + config.weight_decay * p
        p.sub_(lr * upd)
    state["count"] = count
