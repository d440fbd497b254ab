"""Theta (drop-out ratio) schedules (port of ``repro.core.schedules``; paper
§IV-A1 and Theorem 3.5).

The paper trains with a static theta <= 0.7, shows that theta >= 0.9
degrades accuracy (Thm 3.4's noise-ball term), and repairs that by
shrinking theta during training ("mixed comp": theta = 0.99 early, 0 late).
Thm 3.5 proves convergence when theta_t^2 = L * eta_t with a diminishing
step size.  Schedules are plain step -> float callables evaluated on the
host; a theta change alters the kept-k, so the training loop builds one
step function per distinct quantized theta.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

__all__ = [
    "constant",
    "step_decay",
    "polynomial_decay",
    "sigmoid_decay",
    "thm35_schedule",
    "quantize_theta",
    "make_schedule",
    "schedule_curve",
]

ThetaSchedule = Callable[[int], float]


def constant(theta: float) -> ThetaSchedule:
    return lambda step: theta


def step_decay(boundaries_and_values: Sequence[Tuple[int, float]]) -> ThetaSchedule:
    """Piecewise-constant: [(step_boundary, theta_after), ...].

    The paper's "mixed comp" is ``step_decay([(0, 0.99), (T, 0.0)])``."""
    table = sorted(boundaries_and_values)

    def schedule(step: int) -> float:
        theta = table[0][1]
        for boundary, value in table:
            if step >= boundary:
                theta = value
        return theta

    return schedule


def polynomial_decay(theta0: float, total_steps: int, power: float = 1.0,
                     theta_end: float = 0.0) -> ThetaSchedule:
    def schedule(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return theta_end + (theta0 - theta_end) * (1.0 - frac) ** power

    return schedule


def sigmoid_decay(theta0: float, midpoint: int, steepness: float = 0.01) -> ThetaSchedule:
    def schedule(step: int) -> float:
        return theta0 / (1.0 + math.exp(steepness * (step - midpoint)))

    return schedule


def thm35_schedule(lipschitz: float, eta_schedule: Callable[[int], float]) -> ThetaSchedule:
    """Theorem 3.5: theta_t = sqrt(L * eta_t), clipped to the lemma's
    admissible region theta^2 <= 1/4 (theta <= 0.5)."""

    def schedule(step: int) -> float:
        return min(0.5, math.sqrt(max(lipschitz * eta_schedule(step), 0.0)))

    return schedule


def quantize_theta(theta: float, granularity: float = 0.05) -> float:
    """Snap theta to a grid, so a smooth schedule builds a bounded number of
    step functions (the kept-k changes only at grid boundaries)."""
    return min(0.95, max(0.0, round(theta / granularity) * granularity))


def make_schedule(kind: Optional[str], **params) -> Optional[ThetaSchedule]:
    """A schedule from a JSON-serializable (kind, params) description::

        make_schedule("constant", theta=0.7)
        make_schedule("step_decay", points=[[0, 0.99], [30, 0.0]])
        make_schedule("polynomial_decay", theta0=0.9, total_steps=50)
        make_schedule("sigmoid_decay", theta0=0.9, midpoint=25)
        make_schedule("thm35", lipschitz=1.0, eta=0.3)   # fixed-eta variant
        make_schedule(None)                              # dense: no schedule
    """
    if kind is None:
        return None
    if kind == "constant":
        return constant(params["theta"])
    if kind == "step_decay":
        return step_decay([(int(s), float(v)) for s, v in params["points"]])
    if kind == "polynomial_decay":
        return polynomial_decay(params["theta0"], params["total_steps"],
                                params.get("power", 1.0), params.get("theta_end", 0.0))
    if kind == "sigmoid_decay":
        return sigmoid_decay(params["theta0"], params["midpoint"], params.get("steepness", 0.01))
    if kind == "thm35":
        eta = params["eta"]
        return thm35_schedule(params["lipschitz"], lambda s: eta)
    raise ValueError(f"unknown schedule kind {kind!r}")


def schedule_curve(schedule: Optional[ThetaSchedule], steps: int,
                   granularity: float = 0.05) -> Tuple[float, ...]:
    """The quantized theta the training loop realizes at each step (it snaps
    through :func:`quantize_theta`); ``schedule=None`` (dense) gives zeros."""
    if schedule is None:
        return tuple(0.0 for _ in range(steps))
    return tuple(quantize_theta(schedule(s), granularity) for s in range(steps))
