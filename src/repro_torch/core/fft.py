"""Chunked real FFT of the flat gradient (port of ``repro.core.fft``).

The flat signal is cut into fixed 4096-point chunks and each chunk is
transformed on its own; an rfft of C reals gives C/2+1 complex bins.  By
Parseval with Hermitian symmetry, DC and Nyquist carry energy weight 1 and
the interior bins weight 2 (:func:`hermitian_weights`), so ranking bins by
weighted magnitude keeps the dropped-energy accounting exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tracing

__all__ = [
    "DEFAULT_CHUNK",
    "pad_to_chunks",
    "chunked_rfft",
    "chunked_irfft",
    "irfft_rows",
    "hermitian_weights",
]

DEFAULT_CHUNK = 4096


def pad_to_chunks(x_flat: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> Tuple[torch.Tensor, int]:
    """Zero-pad a flat vector to a multiple of ``chunk`` -> ((c, chunk), n)."""
    n = x_flat.shape[0]
    n_chunks = max(1, -(-n // chunk))
    padded = x_flat.new_zeros((n_chunks * chunk,))
    padded[:n] = x_flat
    return padded.reshape(n_chunks, chunk), n


def chunked_rfft(x_flat: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> Tuple[torch.Tensor, int]:
    """Flat f32 -> (n_chunks, chunk//2+1) complex64, plus the original length."""
    x2d, n = pad_to_chunks(x_flat.float(), chunk)
    return torch.fft.rfft(x2d, dim=-1).to(torch.complex64), n


def chunked_irfft(freqs: torch.Tensor, orig_len: int, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(n_chunks, chunk//2+1) complex64 -> flat f32 of ``orig_len``."""
    x2d = torch.fft.irfft(freqs, n=chunk, dim=-1)
    return x2d.reshape(-1)[:orig_len].float()


def irfft_rows(spectrum: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(B, max_chunks, chunk//2+1) spectra -> (B, max_chunks * chunk) f32:
    one inverse transform per chunk row, rows laid end to end."""
    x = torch.fft.irfft(spectrum, n=chunk, dim=-1)
    return x.reshape(spectrum.shape[0], -1).float()


def hermitian_weights(chunk: int = DEFAULT_CHUNK, device=None) -> torch.Tensor:
    """Energy weights per rfft bin: [1, 2, 2, ..., 2, 1] (len chunk//2+1).
    Each bin set from a Python number is a copy to ``device``: on a card the
    host waits for it."""
    f = chunk // 2 + 1
    w = torch.full((f,), 2.0, dtype=torch.float32, device=device)
    tracing.count("host_syncs")
    w[0] = 1.0
    if chunk % 2 == 0:
        tracing.count("host_syncs")
        w[-1] = 1.0
    return w
