"""Optimizers built from scratch (port of ``repro.optim``): SGD with
momentum, AdamW with bias correction, global-norm clipping, LR schedules."""

from repro_torch.optim.optimizers import OptConfig, init_opt_state, apply_updates
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim import lr_schedules

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "clip_by_global_norm",
           "global_norm", "lr_schedules"]
