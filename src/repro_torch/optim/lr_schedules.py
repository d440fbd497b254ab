"""LR schedules as step -> multiplier callables (port of
``repro.optim.lr_schedules``).

``rsqrt_decay`` is the diminishing step size of Theorem 3.5 (sum eta = inf,
sum eta^2 < inf); ``core.schedules.thm35_schedule`` pairs it with theta."""

from __future__ import annotations

import math

__all__ = ["constant", "cosine", "warmup_cosine", "rsqrt_decay", "step_decay"]


def constant():
    return lambda step: 1.0


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


def rsqrt_decay(warmup: int = 100):
    def f(step):
        return min((step + 1) / warmup, math.sqrt(warmup / max(step + 1, 1)))

    return f


def step_decay(boundaries, factor=0.1):
    def f(step):
        mult = 1.0
        for b in boundaries:
            if step >= b:
                mult *= factor
        return mult

    return f
