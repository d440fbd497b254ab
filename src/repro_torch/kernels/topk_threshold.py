"""B1: per-row top-k threshold by value-axis bisection (port of
``repro.kernels.topk_threshold.threshold_pallas``).

Per row of ``(rows, cols)`` magnitudes: 48 bisection sweeps on
``[0, nextafter(max)]`` give ``tau`` with ``count(mag >= tau) >= k`` and
that count.  The CUDA kernel is ``csrc/topk_threshold.cu``; the plain
version is ``selection.bisect_tau`` plus one count, and the two are bitwise
equal on the same input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import selection
from repro_torch.kernels import _checks
from repro_torch.kernels.build import Kernel, kernel_op, ptr

__all__ = ["KERNEL", "threshold", "threshold_plain", "BISECT_ITERS"]

BISECT_ITERS = selection.BISECT_ITERS

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "topk_threshold", "topk_threshold.cu",
    replaces="src/repro/kernels/topk_threshold.py:63",
    entry="topk_threshold",
    argtypes=[_P, _I, _I, _I, _I, _P, _P, _P],
)


def threshold_plain(mag2d: torch.Tensor, k: int):
    """Plain PyTorch version: (tau (rows,1) f32, count (rows,1) i32)."""
    tau = selection.bisect_tau(mag2d.float(), k)
    count = (mag2d >= tau[:, None]).sum(dim=-1, dtype=torch.int32)
    return tau[:, None], count[:, None]


def _threshold(mag2d: torch.Tensor, k: int):
    if _checks.on_cpu(mag2d):
        return threshold_plain(mag2d, k)
    rows, cols = mag2d.shape
    _checks.require("mag", mag2d, torch.float32)
    tau = torch.empty((rows, 1), dtype=torch.float32, device=mag2d.device)
    count = torch.empty((rows, 1), dtype=torch.int32, device=mag2d.device)
    if rows:
        KERNEL.launch(mag2d.device, ptr(mag2d), rows, cols, k, BISECT_ITERS, ptr(tau), ptr(count))
    return tau, count


def _rows_tau_count(mag2d, *args):
    rows = mag2d.shape[0]
    return (mag2d.new_empty((rows, 1), dtype=torch.float32),
            mag2d.new_empty((rows, 1), dtype=torch.int32))


_OP = kernel_op(KERNEL.name, "(Tensor mag, int k) -> (Tensor, Tensor)", _threshold,
                _rows_tau_count)


def threshold(mag2d: torch.Tensor, *, k: int):
    """(rows, cols) magnitudes -> (tau (rows,1) f32, count (rows,1) i32).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    return _OP(mag2d, k)
