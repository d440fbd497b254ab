"""Argument checks shared by the kernel wrappers: the kernels take only
contiguous tensors of one dtype on one CUDA device."""

from __future__ import annotations

import torch

__all__ = ["on_cpu", "require", "row_params"]


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"kernels take CPU or CUDA tensors, got {t.device}")


def require(name: str, t: torch.Tensor, dtype, shape=None, device=None) -> None:
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def row_params(eps, p_codes, rows: int, device):
    """Quantizer (eps, P) as contiguous float32 ``(rows,)`` vectors, from one
    fit (scalars) or one fit per row (``(rows,)`` vectors)."""
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device).reshape(-1)
    p = torch.as_tensor(p_codes, device=device).reshape(-1).float()
    if eps.numel() == 1:
        eps, p = eps.expand(rows), p.expand(rows)
    return eps.contiguous(), p.contiguous()
