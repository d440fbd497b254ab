"""Convergence-theory helpers (port of ``repro.core.theory``; paper §III-C,
Lemma 3.3 / Thm 3.4 / Thm 3.5).

These make the paper's guarantees *executable*: tests and benchmarks call
:func:`assumption31_holds` on every sparsifier and evaluate the Thm 3.4 bound
against measured training curves.

Facts used by the tests (docs/DESIGN.md §6): dropping the theta-fraction of
*smallest-magnitude* coefficients of any orthonormal transform discards at
most a theta fraction of the energy, so ||v - v_hat|| <= sqrt(theta) * ||v||
always holds; on near-normal gradients the empirical constant is far below
theta itself, which is what Assumption 3.1 asks for.

:func:`assumption31_stats` computes in float32 on the vectors' device, as
the reference does without x64; the rest is host arithmetic on Python
floats, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

__all__ = [
    "assumption31_stats",
    "assumption31_holds",
    "assumption31_holds_stats",
    "thm34_bound",
    "Thm34Terms",
    "CurveConstants",
    "estimate_curve_constants",
    "Thm34Envelope",
    "thm34_envelope",
    "curves_close",
]


def _norm(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.sqrt(torch.sum(x * x))


def assumption31_stats(v: torch.Tensor, v_hat: torch.Tensor):
    """Returns (||v - v_hat|| / ||v||, ||v_hat|| / ||v||), float32 scalars."""
    nv = torch.clamp_min(_norm(v), 1e-30)
    return _norm(v.float() - v_hat.float()) / nv, _norm(v_hat) / nv


def assumption31_holds_stats(
    err_ratio: float,
    norm_ratio: float,
    theta: float,
    slack: float = 1.0,
    norm_tol: float = 1e-4,
) -> bool:
    """Assumption 3.1 on precomputed ratios (the lab records these per step).

    ``norm_tol`` loosens the ``||v_hat|| <= ||v||`` side for quantized
    pipelines: round-to-nearest encoding can push individual coefficients (and
    hence the reconstruction norm) up to one mantissa step above the input,
    so quantized runs pass ``norm_tol ~ quantization_rtol``.
    """
    return bool(
        (float(err_ratio) <= slack * theta + 1e-6)
        & (float(norm_ratio) <= 1.0 + norm_tol)
    )


def assumption31_holds(
    v: torch.Tensor, v_hat: torch.Tensor, theta: float, slack: float = 1.0,
    norm_tol: float = 1e-4,
) -> bool:
    """Check ||v-v_hat|| <= slack*theta*||v|| and ||v_hat|| <= (1+tol)*||v||.

    ``slack=1`` is the paper's literal assumption; quantization adds a small
    multiplicative wiggle so callers may pass ``slack`` slightly above 1 for
    the provable sqrt(theta) regime (see module docstring).
    """
    err_ratio, norm_ratio = assumption31_stats(v, v_hat)
    return assumption31_holds_stats(err_ratio, norm_ratio, theta, slack, norm_tol)


@dataclasses.dataclass
class Thm34Terms:
    """min_t E||grad f(x_t)||^2 <= opt_term + noise_term (Thm 3.4)."""

    opt_term: float  # 4 (f(x0) - f*) / (eta K)
    noise_term: float  # (L eta + theta^2) 2 sigma^2 / b
    bound: float


def thm34_bound(
    f0_minus_fstar: float,
    lipschitz: float,
    eta: float,
    theta: float,
    sigma_sq: float,
    batch: int,
    steps: int,
) -> Thm34Terms:
    """Evaluate the Theorem 3.4 bound for fixed eta/theta/b over K steps."""
    opt = 4.0 * f0_minus_fstar / (eta * max(steps, 1))
    noise = (lipschitz * eta + theta**2) * 2.0 * sigma_sq / max(batch, 1)
    return Thm34Terms(opt, noise, opt + noise)


# ---------------------------------------------------------------------------
# Measured-curve evaluation (convergence lab)
#
# Thm 3.4 bounds min_t E||grad f(x_t)||^2 in terms of constants (L, sigma^2,
# f0 - f*) a real run never knows a priori.  The lab therefore evaluates the
# bound with PLUG-IN estimates derived from the same measured curve, which
# keeps the check executable and honest about where each constant comes from:
#
# * L-hat — the smallest smoothness constant consistent with the descent
#   lemma  f(x_{t+1}) <= f(x_t) - eta(1 - L*eta/2)||g_t||^2  along the
#   recorded trajectory (rearranged per step, maximized over steps);
# * sigma^2-hat — near stationarity the minibatch gradient satisfies
#   E||g_b||^2 ~= sigma^2 / b, so sigma^2-hat = b * mean(tail of ||g||^2).
#
# The envelope check then asserts min-so-far measured grad-energy stays under
# the bound at every recorded prefix length K.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CurveConstants:
    """Plug-in constants estimated from one measured training curve."""

    f0_minus_fstar: float
    lipschitz: float
    sigma_sq: float


def estimate_curve_constants(
    loss_curve: Sequence[float],
    grad_sq_curve: Sequence[float],
    eta: float,
    batch: int,
    fstar: float = 0.0,
    tail_fraction: float = 0.25,
) -> CurveConstants:
    """Estimate (f0 - f*, L, sigma^2) from per-step loss and ||grad||^2."""
    if len(loss_curve) < 2 or len(loss_curve) != len(grad_sq_curve):
        raise ValueError("need >= 2 aligned (loss, grad_sq) samples")
    f0 = float(loss_curve[0])
    # descent lemma per step: L >= 2*(delta_f + eta*gsq) / (eta^2 * gsq)
    l_hat = 0.0
    for f_t, f_next, gsq in zip(loss_curve, loss_curve[1:], grad_sq_curve):
        if gsq <= 0.0:
            continue
        l_step = 2.0 * ((f_next - f_t) + eta * gsq) / (eta * eta * gsq)
        l_hat = max(l_hat, l_step)
    l_hat = max(l_hat, 1e-6)
    tail = max(1, int(len(grad_sq_curve) * tail_fraction))
    tail_mean = sum(grad_sq_curve[-tail:]) / tail
    return CurveConstants(
        f0_minus_fstar=max(f0 - fstar, 0.0),
        lipschitz=l_hat,
        sigma_sq=max(batch, 1) * tail_mean,
    )


@dataclasses.dataclass
class Thm34Envelope:
    """Per-prefix Thm 3.4 bound vs the measured min-so-far grad energy."""

    bounds: Tuple[float, ...]  # bound evaluated at K = 1..len(curve)
    min_so_far: Tuple[float, ...]  # running min of measured ||grad||^2
    holds: bool  # min_so_far[K] <= slack * bounds[K] at every K


def thm34_envelope(
    grad_sq_curve: Sequence[float],
    constants: CurveConstants,
    eta: float,
    theta: float,
    batch: int,
    slack: float = 1.0,
) -> Thm34Envelope:
    """Check a measured grad-energy curve against the Thm 3.4 envelope.

    ``theta`` should be the LARGEST theta the run used (the bound is monotone
    in theta, so the max is the valid envelope for a scheduled run).
    """
    bounds, mins = [], []
    running = float("inf")
    for k, gsq in enumerate(grad_sq_curve, start=1):
        running = min(running, float(gsq))
        terms = thm34_bound(
            constants.f0_minus_fstar, constants.lipschitz, eta, theta,
            constants.sigma_sq, batch, k,
        )
        bounds.append(terms.bound)
        mins.append(running)
    holds = all(m <= slack * b + 1e-9 for m, b in zip(mins, bounds))
    return Thm34Envelope(tuple(bounds), tuple(mins), holds)


def curves_close(
    a: Sequence[float], b: Sequence[float], atol: float = 1e-5
) -> Tuple[bool, float]:
    """Pointwise curve comparison -> (within_atol, max_abs_divergence).

    Used for the transport-equivalence claim: two runs that differ only in
    transport must trace identical loss curves (bitwise on the CPU backend —
    see transport.py's ordered worker fold — so atol=1e-5 has huge margin).
    """
    if len(a) != len(b):
        raise ValueError(f"curve lengths differ: {len(a)} vs {len(b)}")
    worst = max((abs(float(x) - float(y)) for x, y in zip(a, b)), default=0.0)
    return worst <= atol, worst
