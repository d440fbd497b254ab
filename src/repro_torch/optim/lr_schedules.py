"""LR schedules as step -> multiplier callables (port of
``repro.optim.lr_schedules``: ``cosine`` and ``warmup_cosine``)."""

from __future__ import annotations

import math

__all__ = ["cosine", "warmup_cosine"]


def cosine(total_steps: int, final: float = 0.1):
    def f(step):
        frac = min(step / max(total_steps, 1), 1.0)
        return final + (1 - final) * 0.5 * (1 + math.cos(math.pi * frac))

    return f


def warmup_cosine(warmup: int, total_steps: int, final: float = 0.1):
    cos = cosine(total_steps - warmup, final)

    def f(step):
        if step < warmup:
            return (step + 1) / warmup
        return cos(step - warmup)

    return f
