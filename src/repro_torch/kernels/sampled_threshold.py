"""B4: the sampled selector's threshold in one launch (port of
``repro.kernels.sampled_threshold`` and the plain jnp around it).

``sampled_select`` takes a row's strided sample and its rank bracket, the
full-row clamp and ``refine_iters`` bisection sweeps, and the engine's
mid-gap tau, all in the kernel ``csrc/sampled_threshold.cu``; the host
gives it the sample's layout and ranks alone.  The plain version is the
chain ``strided_sample`` -> ``sample_bracket`` -> ``refine_bracket`` -> one
count -> ``mid_gap`` (``core/selection.py``); the two are bitwise equal on
the same input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.core import selection
from repro_torch.kernels import _checks
from repro_torch.kernels.build import Kernel, kernel_op, ptr

__all__ = ["KERNEL", "FALLBACK_COUNTER", "sampled_select", "sampled_select_plain"]

# the rows whose sampled bracket broke the invariant on the full row and
# fell back to [0, nextafter(max)] on either side
FALLBACK_COUNTER = "exchange.bracket_fallback_rows"

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "sampled_threshold", "sampled_threshold.cu",
    replaces="src/repro/kernels/sampled_threshold.py:75",
    entry="sampled_select",
    argtypes=[_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
)


def sampled_select_plain(mag2d, *, k: int, sample_rate: float = selection.DEFAULT_SAMPLE_RATE,
                         refine_iters: int = selection.DEFAULT_REFINE_ITERS, seed: int = 0):
    """Plain PyTorch version: (tau_k (rows,1) f32, count (rows,1) i32, the
    mid-gap tau (rows,1) f32)."""
    mag = mag2d.float()
    lo, hi = selection.sample_bracket(selection.strided_sample(mag, sample_rate, seed), k,
                                      mag.shape[-1])
    fallback = tracing.device_counter(FALLBACK_COUNTER, mag.device)
    if fallback is not None:
        fallback += (((mag >= lo[:, None]).sum(dim=-1) < k)
                     | ((mag >= hi[:, None]).sum(dim=-1) >= k)).sum()
    tau_k = selection.refine_bracket(mag, lo, hi, k, refine_iters)[:, None]
    count = (mag >= tau_k).sum(dim=-1, dtype=torch.int32)
    return tau_k, count[:, None], selection.mid_gap(mag, tau_k)


def _sampled_select(mag2d, k: int, sample_rate: float, refine_iters: int, seed: int):
    if _checks.on_cpu(mag2d):
        return sampled_select_plain(mag2d, k=k, sample_rate=sample_rate,
                                    refine_iters=refine_iters, seed=seed)
    rows, cols = mag2d.shape
    _checks.require("mag", mag2d, torch.float32)
    s, stride, offset = selection._sample_layout(cols, sample_rate, seed)
    hi_rank, lo_rank = selection.sample_ranks(k, s, cols)
    tau_k, count, tau = _rows_tau_count_tau(mag2d)
    fallback = tracing.device_counter(FALLBACK_COUNTER, mag2d.device)
    if rows:
        KERNEL.launch(mag2d.device, ptr(mag2d), rows, cols, k, s, stride, offset, hi_rank,
                      lo_rank, selection.BISECT_ITERS, refine_iters, ptr(tau_k), ptr(count),
                      ptr(tau), None if fallback is None else ptr(fallback))
    return tau_k, count, tau


def _rows_tau_count_tau(mag2d, *args):
    rows = mag2d.shape[0]
    return (mag2d.new_empty((rows, 1), dtype=torch.float32),
            mag2d.new_empty((rows, 1), dtype=torch.int32),
            mag2d.new_empty((rows, 1), dtype=torch.float32))


_OP = kernel_op(KERNEL.name,
                "(Tensor mag, int k, float sample_rate, int refine_iters, int seed) "
                "-> (Tensor, Tensor, Tensor)",
                _sampled_select, _rows_tau_count_tau)


def sampled_select(mag2d, *, k: int, sample_rate: float = selection.DEFAULT_SAMPLE_RATE,
                   refine_iters: int = selection.DEFAULT_REFINE_ITERS, seed: int = 0):
    """(rows, cols) magnitudes -> (tau_k, count, tau), each (rows, 1): the
    sampled selector's threshold (count(>= tau_k) >= k), its count, and the
    mid-gap tau the fused compress keeps by.

    Rows whose sampled bracket breaks the bisection invariant fall back to
    the full ``[0, nextafter(max)]`` range; while tracing is on they add to
    the counter ``exchange.bracket_fallback_rows``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    return _OP(mag2d, k, sample_rate, refine_iters, seed)
