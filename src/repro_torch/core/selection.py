"""Selection engine: the shared math of every top-k selector (port of
``repro.core.selection``).

* ``sort``    -- exact ``torch.topk`` (magnitude-descending slot order).
* ``bisect``  -- value-axis bisection: 48 compare+count sweeps over
                 ``[0, nextafter(max)]``, then one count-and-compact pass.
* ``sampled`` -- bracket tau from a strided magnitude subsample, clamp the
                 bracket so the bisection invariant holds on the full rows,
                 refine with ``tau_refine_iters`` sweeps, then compact.
* ``auto``    -- ``sampled`` on rows at least ``AUTO_SAMPLED_MIN_COLS`` wide,
                 else ``sort``.

The invariant every bisection keeps::

    count(mag >= lo) >= k  >  count(mag >= hi)

The threshold kernels (``kernels/topk_threshold.py``,
``kernels/sampled_threshold.py``) run this arithmetic on the card and are
held bitwise against these functions: it is only compare, count and halve.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparsify import topk_select

__all__ = [
    "SELECTOR_NAMES",
    "BISECT_ITERS",
    "DEFAULT_SAMPLE_RATE",
    "DEFAULT_REFINE_ITERS",
    "AUTO_SAMPLED_MIN_COLS",
    "FLT_MAX",
    "resolve_selector",
    "upper_bracket",
    "bisect_bracket",
    "refine_bracket",
    "bisect_tau",
    "strided_sample",
    "sample_ranks",
    "sample_bracket",
    "mid_gap",
    "sampled_tau",
    "selector_tau",
    "count_compact",
    "select_indices",
]

SELECTOR_NAMES = ("sort", "sampled", "bisect", "auto")

# sweeps for lo/hi to reach adjacent f32 values from [0, max]
BISECT_ITERS = 48
DEFAULT_SAMPLE_RATE = 1.0 / 64.0
DEFAULT_REFINE_ITERS = 16
AUTO_SAMPLED_MIN_COLS = 512

FLT_MAX = float(np.finfo(np.float32).max)


def resolve_selector(selector: str, cols: int) -> str:
    """Concrete selector for rows of this width."""
    if selector not in SELECTOR_NAMES:
        raise ValueError(
            f"unknown selector {selector!r}; expected one of {SELECTOR_NAMES}")
    if selector == "auto":
        return "sampled" if cols >= AUTO_SAMPLED_MIN_COLS else "sort"
    return selector


def upper_bracket(x: torch.Tensor) -> torch.Tensor:
    """Smallest f32 strictly above ``x`` (bit pattern + 1), clamped to FLT_MAX.

    For non-negative finite f32, adding 1 to the bit pattern is nextafter
    toward +inf.  Unlike XLA's CPU backend, torch keeps denormals, so
    ``upper_bracket(0)`` is ``2**-149`` here and not 0."""
    bits = x.float().contiguous().view(torch.int32)
    nxt = (bits + 1).view(torch.float32)
    return torch.clamp_max(nxt, FLT_MAX)


def _count_ge(mag: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (mag >= t[:, None]).sum(dim=-1)


def bisect_bracket(mag: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   k: int, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` bisection sweeps on rows ``mag`` (rows, cols); keeps the
    invariant the caller established and returns the narrowed (lo, hi)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        feasible = _count_ge(mag, mid) >= k  # mid keeps at least the budget
        lo = torch.where(feasible, mid, lo)
        hi = torch.where(feasible, hi, mid)
    return lo, hi


def refine_bracket(mag: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   k: int, iters: int) -> torch.Tensor:
    """Clamp an estimated bracket so the invariant holds, then bisect;
    returns tau (rows,) with ``count(mag >= tau) >= k``.

    An edge the estimate got wrong falls back to the full range (0 below,
    one past the max above)."""
    lo = torch.where(_count_ge(mag, lo) >= k, lo, torch.zeros_like(lo))
    hi_fallback = upper_bracket(torch.amax(mag, dim=-1))
    hi = torch.where(_count_ge(mag, hi) < k, hi, hi_fallback)
    lo, _ = bisect_bracket(mag, lo, hi, k, iters)
    return lo


def bisect_tau(mag: torch.Tensor, k: int, iters: int = BISECT_ITERS) -> torch.Tensor:
    """Full-range bisection threshold: tau (rows,) with count(>= tau) >= k."""
    hi = upper_bracket(torch.amax(mag, dim=-1))
    lo, _ = bisect_bracket(mag, torch.zeros_like(hi), hi, k, iters)
    return lo


def _sample_layout(cols: int, sample_rate: float, seed: int) -> Tuple[int, int, int]:
    """Static (n_sample, stride, offset) of the strided subsample."""
    if not 0.0 < sample_rate <= 1.0:
        raise ValueError(f"sample_rate must be in (0, 1], got {sample_rate}")
    s = max(1, min(cols, int(round(cols * sample_rate))))
    stride = max(1, cols // s)
    offset = seed % stride
    return s, stride, offset


def strided_sample(mag: torch.Tensor, sample_rate: float = DEFAULT_SAMPLE_RATE,
                   seed: int = 0) -> torch.Tensor:
    """(rows, s) strided subsample of the magnitude rows (rfft magnitudes are
    ordered in frequency, so a contiguous window would sample one band)."""
    s, stride, offset = _sample_layout(mag.shape[-1], sample_rate, seed)
    return mag[..., offset:offset + (s - 1) * stride + 1:stride]


def sample_ranks(k: int, s: int, cols: int) -> Tuple[int, int]:
    """(hi_rank, lo_rank): the sample ranks whose values bracket the row's
    k-th largest.  It maps to rank ``k*s/cols`` in a sample of ``s``; a
    ``4*sqrt(k_s)+2`` rank margin each side covers the sampling noise."""
    k_s = k * s / cols
    margin = 4.0 * (max(k_s, 1.0) ** 0.5) + 2.0
    return max(1, int(k_s - margin)), min(s, int(k_s + margin) + 1)


def sample_bracket(sample: torch.Tensor, k: int, cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bracket the full-row tau from sample order statistics: (lo, hi), the
    values of :func:`sample_ranks`' ranks, each found by bisection on the
    sample, never a sort."""
    hi_rank, lo_rank = sample_ranks(k, sample.shape[-1], cols)
    hi0 = upper_bracket(torch.amax(sample, dim=-1))
    zero = torch.zeros_like(hi0)
    hi, _ = bisect_bracket(sample, zero, hi0, hi_rank, BISECT_ITERS)
    lo, _ = bisect_bracket(sample, zero, hi0, lo_rank, BISECT_ITERS)
    return lo, hi


def mid_gap(mag: torch.Tensor, tau_k: torch.Tensor) -> torch.Tensor:
    """The threshold moved from ``tau_k`` (rows, 1) to the middle of the gap
    to the largest dropped magnitude (0 where none is dropped; a NaN is not
    dropped), where an ulp of recompute noise cannot flip a comparison."""
    below = torch.where(mag < tau_k, mag, 0.0).amax(dim=-1, keepdim=True)
    return 0.5 * (tau_k + below)


def sampled_tau(mag: torch.Tensor, k: int, *, sample_rate: float = DEFAULT_SAMPLE_RATE,
                refine_iters: int = DEFAULT_REFINE_ITERS, seed: int = 0) -> torch.Tensor:
    """DGC-style sampled threshold: tau (rows,), count(>= tau) >= k."""
    sample = strided_sample(mag, sample_rate, seed)
    lo, hi = sample_bracket(sample, k, mag.shape[-1])
    return refine_bracket(mag, lo, hi, k, refine_iters)


def selector_tau(mag: torch.Tensor, k: int, selector: str, *,
                 sample_rate: float = DEFAULT_SAMPLE_RATE,
                 refine_iters: int = DEFAULT_REFINE_ITERS, seed: int = 0) -> torch.Tensor:
    """Threshold (..., 1) for a resolved threshold selector (bisect|sampled)."""
    lead = mag.shape[:-1]
    rows = mag.float().reshape(-1, mag.shape[-1])
    if selector == "bisect":
        tau = bisect_tau(rows, k)
    elif selector == "sampled":
        tau = sampled_tau(rows, k, sample_rate=sample_rate,
                          refine_iters=refine_iters, seed=seed)
    else:
        raise ValueError(
            f"selector_tau takes a resolved threshold selector "
            f"(bisect|sampled), got {selector!r}")
    return tau.reshape(lead + (1,))


def count_compact(mag: torch.Tensor, tau: torch.Tensor, k: int) -> torch.Tensor:
    """Exact-k compaction of the tau mask: (..., k) int32, index-ascending.

    Slot ``j`` holds the index of the ``(j+1)``-th kept coefficient, found by
    a lower-bound binary search on the running count of the mask.  Surplus
    kept entries (ties, or a tau a few ulps under the k-th order statistic)
    get no slot: the highest-index surplus truncates, as in the fused
    compress kernel.  Requires ``count(>= tau) >= k``."""
    lead = mag.shape[:-1]
    cols = mag.shape[-1]
    rows = mag.reshape(-1, cols)
    trows = tau.reshape(-1, 1).to(rows.dtype)
    n_rows = rows.shape[0]
    cum = torch.cumsum((rows >= trows).to(torch.int32), dim=-1)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=mag.device)[None, :]
    lo = torch.zeros((n_rows, k), dtype=torch.int64, device=mag.device)
    hi = torch.full((n_rows, k), cols - 1, dtype=torch.int64, device=mag.device)
    for _ in range(max(1, (cols - 1).bit_length())):
        mid = (lo + hi) >> 1
        found = torch.gather(cum, -1, mid) >= targets
        lo, hi = torch.where(found, lo, mid + 1), torch.where(found, mid, hi)
    return lo.to(torch.int32).reshape(lead + (k,))


def select_indices(mag: torch.Tensor, k: int, selector: str, *,
                   sample_rate: float = DEFAULT_SAMPLE_RATE,
                   refine_iters: int = DEFAULT_REFINE_ITERS,
                   seed: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One-call selection: indices (..., k) and tau (..., 1).

    ``sort`` gives magnitude-descending indices (the stable
    :func:`topk_select`) and ``tau=None``; the threshold selectors give the
    index-ascending compaction of ``mag >= tau`` and that tau."""
    resolved = resolve_selector(selector, mag.shape[-1])
    if resolved == "sort":
        return topk_select(mag, k), None
    tau = selector_tau(mag, k, resolved, sample_rate=sample_rate,
                       refine_iters=refine_iters, seed=seed)
    return count_compact(mag, tau, k), tau
