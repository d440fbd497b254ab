"""Train state (port of ``repro.train.state``): the model (which holds the
parameters), the optimizer state, the step counter and, with error feedback,
ONE flat f32 residual over the whole gradient (bucket slices are taken
inside the reducer, so the state does not depend on the layout)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.comms.reducers import residual_size
from repro_torch.optim import OptConfig, init_opt_state

__all__ = ["TrainState", "init_state"]

TrainState = Dict[str, Any]  # {"model", "opt", "step"[, "residual"]}


def init_state(model, opt_cfg: OptConfig, *, error_feedback: bool = False) -> TrainState:
    params = model.leaves()
    device = next(iter(params.values())).device
    state: TrainState = {"model": model, "opt": init_opt_state(opt_cfg, params), "step": 0}
    if error_feedback:
        state["residual"] = torch.zeros((residual_size(params),), dtype=torch.float32,
                                        device=device)
    return state
