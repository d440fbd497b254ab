"""Range-based N-bit floating point quantizer (port of ``repro.core.quantizer``;
paper §III-B.2, Algorithm 1).

Code ``0`` is zero, code ``1`` the smallest positive representable ``eps``;
successive codes walk upward with ``m`` mantissa bits, so the spacing
doubles every ``2**m`` codes.  Positive codes occupy ``1..P``, negative
codes ``P+1 .. 2**N - 1`` with the same pattern mirrored.  The value of
positive code ``c`` is ``eps * 2**q * (1 + r / 2**m)`` with ``idx = c - 1``,
``q = idx >> m`` and ``r = idx & (2**m - 1)``.

Two ways to fit ``eps``, picked by :func:`fit_quantizer`'s ``method``:

* ``solve`` (the default, beyond the paper) -- :func:`solve_eps`, the
  reference's closed form: ``P = (2**N - 1 + 2**m * log2(max / |min|)) / 2``
  and the top code pinned to ``max``;
* ``heuristic`` -- :func:`tune_eps_heuristic`, the paper's Algorithm 1: a
  ×2/÷2 search on ``eps`` from 0.002 until the most negative code straddles
  ``min``.  ``eps`` is only ever doubled, halved or clipped, so it carries
  no rounding; the reference's ``lax.while_loop`` is a plain loop of at
  most 64 iterations here, over every fit of a stack at once.  Its code
  count ``ceil(2**m * (log2(max) - log2(eps)))`` sits exactly on an integer
  whenever the search clipped eps to ``max`` and halved it, so its
  ``log2`` is spelled as XLA lowers ``jnp.log2`` today, ``log(x) *
  float32(1 / ln 2)`` (:func:`_log2_by_reciprocal`), which agrees with it
  on every value where :func:`log2` agrees on ~85%.

``exp2`` and ``log2`` are spelled the way the reference lowers them --
``exp(ln2 * x)`` and ``log(x) / ln2`` in float32 -- so the port reproduces
the rounding of those expressions and not that of a direct ``exp2``/``log2``.
The elementary functions themselves are the framework's own; on the CPU
they differ from XLA's by one ulp on a small share of inputs (ROADMAP queue
3), which the tests bound instead of hiding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import tracing

__all__ = [
    "LN2",
    "exp2",
    "log2",
    "RangeQuantConfig",
    "FittedQuantizer",
    "solve_eps",
    "tune_eps_heuristic",
    "fit_quantizer",
    "encode",
    "decode",
]

LN2 = float(np.float32(np.log(2.0)))  # the float32 constant of the lowering
INV_LN2 = float(np.float32(1.0 / np.float32(np.log(2.0))))


def exp2(x: torch.Tensor) -> torch.Tensor:
    """``2**x`` as the reference computes it: ``exp(float32(ln 2) * x)``."""
    return torch.exp(x * LN2)


def log2(x: torch.Tensor) -> torch.Tensor:
    """``log2(x)`` as the reference computes it: ``log(x) / float32(ln 2)``."""
    return torch.log(x) / LN2


def _log2_by_reciprocal(x: torch.Tensor) -> torch.Tensor:
    """``log2(x)`` as XLA lowers ``jnp.log2``: ``log(x) * float32(1/ln 2)``.
    Only the heuristic's code count uses it; :func:`log2` keeps the
    division, which the CUDA kernels' encode mirrors bit for bit."""
    return torch.log(x) * INV_LN2


@dataclasses.dataclass(frozen=True)
class RangeQuantConfig:
    """Static configuration of the N-bit range-based float."""

    n_bits: int = 8
    m_bits: int = 3

    def __post_init__(self):
        if not (1 < self.m_bits < self.n_bits):
            raise ValueError(f"need 1 < m_bits < n_bits, got {self}")
        if self.n_bits > 16:
            raise ValueError("n_bits > 16 not supported (codes stored u16)")

    @property
    def n_codes(self) -> int:
        return 1 << self.n_bits

    @property
    def mantissa_scale(self) -> int:
        return 1 << self.m_bits

    @property
    def code_dtype(self) -> torch.dtype:
        return torch.uint8 if self.n_bits <= 8 else torch.uint16


@dataclasses.dataclass
class FittedQuantizer:
    """A fitted range quantizer: static config + tensor (eps, P, vmax, vmin).

    The tensors are scalars for one fit, or share a leading shape for a
    stack of fits (``(n_buckets, 1, 1)`` in a ``StackedPayload``)."""

    config: RangeQuantConfig
    eps: torch.Tensor  # f32
    p_codes: torch.Tensor  # i32: number of positive codes
    vmax: torch.Tensor  # largest positive representable
    vmin: torch.Tensor  # most negative representable (<= 0)

    def map(self, fn) -> "FittedQuantizer":
        """Apply ``fn`` to every tensor leaf (reshape, index, move)."""
        return FittedQuantizer(self.config, fn(self.eps), fn(self.p_codes),
                               fn(self.vmax), fn(self.vmin))


def _value_of_index(idx: torch.Tensor, eps: torch.Tensor, m_bits: int) -> torch.Tensor:
    """value for 0-based positive index: eps * 2**q * (1 + r/2**m)."""
    m_scale = 1 << m_bits
    q = torch.div(idx, m_scale, rounding_mode="floor")
    r = torch.remainder(idx, m_scale)
    return eps * exp2(q.float()) * (1.0 + r.float() / m_scale)


def solve_eps(vmin: torch.Tensor, vmax: torch.Tensor,
              config: RangeQuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (eps, P) balancing positive/negative code budgets."""
    m_scale = config.mantissa_scale
    n_codes = config.n_codes
    vmax = torch.clamp_min(vmax, 1e-30)
    vmag = torch.clamp_min(-vmin, 1e-30)
    p_f = (n_codes - 1 + m_scale * (log2(vmax) - log2(vmag))) / 2.0
    p = torch.clamp(torch.round(p_f), 1, n_codes - 2).to(torch.int32)
    # pin the TOP code (idx = P-1) to vmax; the exponent is clamped so eps
    # never underflows f32
    exponent = torch.clamp_max((p.float() - 1.0) / m_scale, 96.0)
    eps = torch.clamp_min(vmax / exp2(exponent), 1e-30)
    return eps, p


def tune_eps_heuristic(vmin, vmax, config: RangeQuantConfig, eps_init: float = 0.002,
                       max_iters: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Algorithm 1: ×2/÷2 search on eps until the decoded "1...1" code
    (the most negative representable) straddles ``vmin``.

    As the paper's loop: when the most negative code lies below ``vmin``
    there are too many negative codes, so eps halves; else it doubles.  A
    fit stops when the sign of that error flips or after ``max_iters``.
    ``vmin``/``vmax`` are scalars or tensors of one shape (each element its
    own search).  Returns (eps, P).

    A finished element keeps its eps, so running every fit to ``max_iters``
    gives the same result: on fake tensors (``launch/dryrun.py``), where
    ``done`` cannot be read on the host, the loop runs to that cap."""
    m_scale = config.mantissa_scale
    n_codes = config.n_codes
    vmax = torch.clamp_min(torch.as_tensor(vmax, dtype=torch.float32), 1e-30)
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=vmax.device)

    def p_of_eps(eps):
        # codes needed to reach vmax from eps (ceil), >= 1
        steps = torch.ceil(m_scale * (_log2_by_reciprocal(vmax) - _log2_by_reciprocal(eps)))
        return torch.clamp(steps, 1, n_codes - 2).to(torch.int32)

    def actual_min_of_eps(eps):
        n_neg = n_codes - 1 - p_of_eps(eps)
        return -_value_of_index(torch.clamp_min(n_neg - 1, 0), eps, config.m_bits)

    eps = torch.full_like(vmax, eps_init)
    prev_sign = torch.zeros(vmax.shape, dtype=torch.int32, device=vmax.device)
    done = torch.zeros(vmax.shape, dtype=torch.bool, device=vmax.device)
    for _ in range(max_iters):
        if not is_fake(done):
            tracing.count("host_syncs")
            if bool(done.all()):
                break
        one = torch.ones_like(prev_sign)
        sign = torch.where(actual_min_of_eps(eps) < vmin, -one, one)
        flipped = (prev_sign != 0) & (sign != prev_sign)
        new_eps = torch.minimum(torch.clamp_min(torch.where(sign < 0, eps * 0.5, eps * 2.0),
                                                1e-30), vmax)
        done = done | flipped
        eps = torch.where(done, eps, new_eps)
        prev_sign = sign
    return eps, p_of_eps(eps)


def fit_quantizer(vmin, vmax, config: RangeQuantConfig = RangeQuantConfig(),
                  method: str = "solve", device=None) -> FittedQuantizer:
    """Fit the quantizer to an observed range (scalars or stacked tensors)
    with :func:`solve_eps` (``method="solve"``) or the paper's search
    :func:`tune_eps_heuristic` (``method="heuristic"``).

    A one-sided range still reserves one code on the empty side: the math
    needs vmin < 0 < vmax."""
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=device)
    vmax = torch.as_tensor(vmax, dtype=torch.float32, device=vmin.device)
    span = torch.clamp_min(vmax - vmin, 1e-30)
    vmax_eff = torch.maximum(vmax, span * 1e-6)
    vmin_eff = torch.minimum(vmin, -span * 1e-6)
    if method == "solve":
        eps, p = solve_eps(vmin_eff, vmax_eff, config)
    elif method == "heuristic":
        eps, p = tune_eps_heuristic(vmin_eff, vmax_eff, config)
    else:
        raise ValueError(f"unknown fit method {method!r}")
    n_neg = config.n_codes - 1 - p
    vmax_rep = _value_of_index(p - 1, eps, config.m_bits)
    vmin_rep = -_value_of_index(torch.clamp_min(n_neg - 1, 0), eps, config.m_bits)
    return FittedQuantizer(config, eps, p, vmax_rep, vmin_rep)


def _encode_magnitude(a, eps, m_bits: int, max_idx):
    """0-based index for magnitude ``a`` (>= 0); round-to-nearest; clipped."""
    m_scale = 1 << m_bits
    safe_a = torch.maximum(a, eps)
    # exponent segment: floor(log2(a/eps)); the nudge keeps 2.0 -> q=1
    q = torch.floor(log2(safe_a) - log2(eps) + 1e-6)
    seg_base = eps * exp2(q)
    r = torch.round((safe_a / seg_base - 1.0) * m_scale)
    # r may round up to 2**m: carry into the next exponent segment
    carry = r >= m_scale
    q = torch.where(carry, q + 1, q)
    r = torch.where(carry, torch.zeros_like(r), r)
    idx = (q * m_scale + r).to(torch.int32)
    # below-eps values: nearest of {0, eps} in linear space
    below = torch.where(a * 2.0 >= eps, 0, -1).to(torch.int32)
    idx = torch.where(a < eps, below, idx)
    return torch.minimum(torch.clamp_min(idx, -1), max_idx - 1)  # -1 = zero


def encode(x: torch.Tensor, quant: FittedQuantizer) -> torch.Tensor:
    """float32 -> N-bit codes (uint8, or uint16 above 8 bits)."""
    cfg = quant.config
    x = x.float()
    pos = x >= 0
    a = torch.abs(x)
    n_neg = cfg.n_codes - 1 - quant.p_codes
    idx_pos = _encode_magnitude(a, quant.eps, cfg.m_bits, quant.p_codes)
    idx_neg = _encode_magnitude(a, quant.eps, cfg.m_bits, torch.clamp_min(n_neg, 1))
    zero = torch.zeros_like(idx_pos)
    code = torch.where(
        pos,
        torch.where(idx_pos < 0, zero, idx_pos + 1),
        torch.where(idx_neg < 0, zero, quant.p_codes + idx_neg + 1),
    )
    return code.to(cfg.code_dtype)


def decode(codes: torch.Tensor, quant: FittedQuantizer) -> torch.Tensor:
    """N-bit codes -> float32."""
    cfg = quant.config
    c = codes.to(torch.int32)
    is_zero = c == 0
    is_pos = (c >= 1) & (c <= quant.p_codes)
    idx = torch.where(is_pos, c - 1, c - quant.p_codes - 1)
    idx = torch.clamp_min(idx, 0)
    mag = _value_of_index(idx, quant.eps, cfg.m_bits)
    val = torch.where(is_pos, mag, -mag)
    return torch.where(is_zero, torch.zeros_like(val), val).float()
