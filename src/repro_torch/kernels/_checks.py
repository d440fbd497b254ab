"""Argument checks shared by the kernel wrappers: the kernels take only
contiguous tensors of one dtype on one CUDA device."""

from __future__ import annotations

import torch

__all__ = ["on_cpu", "require", "row_params", "encode_row_params", "code_dtype", "as_tensors"]


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


def as_tensors(eps, p_codes, device):
    """(eps, P) as tensors on ``device`` for a kernel's custom op, which
    takes no Python numbers in their place (values and dtypes unchanged:
    :func:`row_params` casts them)."""
    return (torch.as_tensor(eps, device=device), torch.as_tensor(p_codes, device=device))


def row_params(eps, p_codes, rows: int, device):
    """Quantizer (eps, P) as contiguous float32 ``(rows,)`` vectors, from one
    fit (scalars) or one fit per row (``(rows,)`` vectors)."""
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device).reshape(-1)
    p = torch.as_tensor(p_codes, device=device).reshape(-1).float()
    if eps.numel() == 1:
        eps, p = eps.expand(rows), p.expand(rows)
    return eps.contiguous(), p.contiguous()


def encode_row_params(eps, p_codes, n_bits: int, rows: int, device):
    """(eps, P, n_neg) as float32 ``(rows,)`` vectors for the encoders;
    n_neg = 2**N - 1 - P (exact in float32, as the reference's integer
    difference)."""
    eps, p = row_params(eps, p_codes, rows, device)
    return eps, p, float((1 << n_bits) - 1) - p


def code_dtype(n_bits: int) -> torch.dtype:
    """Code plane type: uint8 up to 8 bits, else uint16."""
    return torch.uint8 if n_bits <= 8 else torch.uint16
