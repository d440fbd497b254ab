"""B6: sparse pack and unpack (port of ``repro.kernels.pack.pack_pallas``
and ``unpack_pallas``).

:func:`pack` compacts each row's elements with ``|x| >= tau`` into
``(vals f32, idx i32)`` of width ``k`` (a multiple of 128), index-ascending;
slots past the row's count hold ``(0.0, 0)`` and a count beyond ``k`` is
cut at ``k``, as the reference's one-hot contraction does.  :func:`unpack`
is the additive scatter of such a pair into a dense ``(rows, cols)`` plane
(``cols`` a multiple of 512).

The CUDA kernels are ``csrc/pack.cu``; their plain versions are a cumsum
and a ``scatter_add_`` (as ``repro.kernels.ref`` spells them), and kernel
and plain version are bitwise equal on the same input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _checks
from repro_torch.kernels.build import Kernel, kernel_op, ptr

__all__ = ["PACK_KERNEL", "UNPACK_KERNEL", "K_TILE", "F_TILE", "pack", "pack_plain",
           "unpack", "unpack_plain"]

K_TILE = 128  # pack widths are multiples of this (the reference's lane tile)
F_TILE = 512  # unpack widths are multiples of this

_P, _I = ctypes.c_void_p, ctypes.c_int
PACK_KERNEL = Kernel(
    "pack", "pack.cu",
    replaces="src/repro/kernels/pack.py:73",
    entry="pack",
    argtypes=[_P, _P, _I, _I, _I, _P, _P, _P],
)
UNPACK_KERNEL = Kernel(
    "unpack", "pack.cu",
    replaces="src/repro/kernels/pack.py:120",
    entry="unpack",
    argtypes=[_P, _P, _I, _I, _I, _P, _P],
)


def _check_k(k: int) -> None:
    if k % K_TILE:
        raise ValueError(f"pack width k={k} must be a multiple of {K_TILE} (see ops.pad_k)")


def _check_cols(cols: int) -> None:
    if cols % F_TILE:
        raise ValueError(f"unpack width cols={cols} must be a multiple of {F_TILE}")


def pack_plain(x2d, tau, *, k: int):
    """Plain PyTorch version of :func:`pack`."""
    _check_k(k)
    rows, _ = x2d.shape
    x = x2d.float()
    mask = x.abs() >= tau.reshape(rows, 1).float()
    pos = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    r_i, c_i = torch.nonzero(mask & (pos < k), as_tuple=True)
    slot = pos[r_i, c_i].long()
    vals = torch.zeros((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.zeros((rows, k), dtype=torch.int32, device=x.device)
    vals[r_i, slot] = x[r_i, c_i]
    idx[r_i, slot] = c_i.to(torch.int32)
    return vals, idx


def _pack(x2d, tau, k: int):
    if _checks.on_cpu(x2d):
        return pack_plain(x2d, tau, k=k)
    _check_k(k)
    rows, cols = x2d.shape
    dev = x2d.device
    _checks.require("x", x2d, torch.float32)
    tau = tau.reshape(rows).float().contiguous()
    _checks.require("tau", tau, torch.float32, device=dev)
    vals = torch.empty((rows, k), dtype=torch.float32, device=dev)
    idx = torch.empty((rows, k), dtype=torch.int32, device=dev)
    if vals.numel():
        PACK_KERNEL.launch(dev, ptr(x2d), ptr(tau), rows, cols, k, ptr(vals), ptr(idx))
    return vals, idx


_PACK_OP = kernel_op(PACK_KERNEL.name, "(Tensor x, Tensor tau, int k) -> (Tensor, Tensor)", _pack,
                     lambda x2d, tau, k: (x2d.new_empty((x2d.shape[0], k), dtype=torch.float32),
                                          x2d.new_empty((x2d.shape[0], k), dtype=torch.int32)))


def pack(x2d, tau, *, k: int):
    """f32 ``(rows, cols)`` and per-row ``tau`` ``(rows, 1)`` -> (vals f32,
    idx i32), each ``(rows, k)``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    return _PACK_OP(x2d, tau, k)


def unpack_plain(vals, idx, *, cols: int):
    """Plain PyTorch version of :func:`unpack`."""
    _check_cols(cols)
    i = idx.long()
    valid = (i >= 0) & (i < cols)
    dense = torch.zeros((vals.shape[0], cols), dtype=torch.float32, device=vals.device)
    dense.scatter_add_(-1, torch.where(valid, i, 0),
                       torch.where(valid, vals.float(), 0.0))
    return dense


def _unpack(vals, idx, cols: int):
    if _checks.on_cpu(vals):
        return unpack_plain(vals, idx, cols=cols)
    _check_cols(cols)
    rows, k = vals.shape
    dev = vals.device
    _checks.require("vals", vals, torch.float32)
    idx = idx.to(torch.int32).contiguous()
    _checks.require("idx", idx, torch.int32, shape=(rows, k), device=dev)
    dense = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    if dense.numel():
        UNPACK_KERNEL.launch(dev, ptr(vals), ptr(idx), rows, k, cols, ptr(dense))
    return dense


_UNPACK_OP = kernel_op(UNPACK_KERNEL.name, "(Tensor vals, Tensor idx, int cols) -> Tensor",
                       _unpack, lambda vals, idx, cols: vals.new_empty((vals.shape[0], cols),
                                                                       dtype=torch.float32))


def unpack(vals, idx, *, cols: int):
    """(vals f32, idx int) ``(rows, k)`` -> dense f32 ``(rows, cols)``; an
    index outside ``[0, cols)`` adds nothing.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    return _UNPACK_OP(vals, idx, cols)
