"""B4: sampled-bracket threshold refinement (port of
``repro.kernels.sampled_threshold``).

``sampled_select`` runs the strided sample and its rank bracket as plain
PyTorch (they touch about 1/64 of the data), then the full-row clamp and
``refine_iters`` bisection sweeps in the kernel ``csrc/sampled_threshold.cu``.
The plain version of the kernel is ``selection.refine_bracket`` plus one
count; the two are bitwise equal on the same input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import selection
from repro_torch.kernels import _checks
from repro_torch.kernels.topk_threshold import _rows_tau_count
from repro_torch.kernels.build import Kernel, kernel_op, ptr

__all__ = ["KERNEL", "sampled_threshold", "sampled_threshold_plain", "sampled_select"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "sampled_threshold", "sampled_threshold.cu",
    replaces="src/repro/kernels/sampled_threshold.py:75",
    entry="sampled_threshold",
    argtypes=[_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
)


def sampled_threshold_plain(mag2d, lo, hi, *, k: int,
                            refine_iters: int = selection.DEFAULT_REFINE_ITERS):
    """Plain PyTorch version: (tau (rows,1) f32, count (rows,1) i32)."""
    rows = mag2d.shape[0]
    tau = selection.refine_bracket(mag2d.float(), lo.reshape(rows).float(),
                                   hi.reshape(rows).float(), k, refine_iters)
    count = (mag2d >= tau[:, None]).sum(dim=-1, dtype=torch.int32)
    return tau[:, None], count[:, None]


def _sampled_threshold(mag2d, lo, hi, k: int, refine_iters: int):
    if _checks.on_cpu(mag2d):
        return sampled_threshold_plain(mag2d, lo, hi, k=k, refine_iters=refine_iters)
    rows, cols = mag2d.shape
    _checks.require("mag", mag2d, torch.float32)
    lo = lo.reshape(rows).float().contiguous()
    hi = hi.reshape(rows).float().contiguous()
    _checks.require("lo", lo, torch.float32, device=mag2d.device)
    _checks.require("hi", hi, torch.float32, device=mag2d.device)
    tau = torch.empty((rows, 1), dtype=torch.float32, device=mag2d.device)
    count = torch.empty((rows, 1), dtype=torch.int32, device=mag2d.device)
    if rows:
        KERNEL.launch(mag2d.device, ptr(mag2d), ptr(lo), ptr(hi), rows, cols, k, refine_iters,
                      ptr(tau), ptr(count))
    return tau, count


_OP = kernel_op(KERNEL.name,
                "(Tensor mag, Tensor lo, Tensor hi, int k, int refine_iters) -> (Tensor, Tensor)",
                _sampled_threshold, _rows_tau_count)


def sampled_threshold(mag2d, lo, hi, *, k: int,
                      refine_iters: int = selection.DEFAULT_REFINE_ITERS):
    """(rows, cols) magnitudes + estimated per-row bracket -> (tau, count).

    Rows whose estimate breaks the bisection invariant fall back to the full
    ``[0, nextafter(max)]`` range.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    return _OP(mag2d, lo, hi, k, refine_iters)


def sampled_select(mag2d, *, k: int, sample_rate: float = selection.DEFAULT_SAMPLE_RATE,
                   refine_iters: int = selection.DEFAULT_REFINE_ITERS, seed: int = 0):
    """Full sampled selection: (tau (rows,1) f32, count (rows,1) i32)."""
    sample = selection.strided_sample(mag2d, sample_rate, seed)
    lo, hi = selection.sample_bracket(sample, k, mag2d.shape[-1])
    return sampled_threshold(mag2d, lo, hi, k=k, refine_iters=refine_iters)
