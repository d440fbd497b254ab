"""The card's peaks and the kernels' least times.

``HBM_BYTES_PER_S``, ``FP32_FLOPS_PER_S``, ``FP32_INSTR_PER_S``, ``bound``,
``b2_bound`` and ``b3_bound`` are frozen copies of chip_smoke.py at commit
9055aa7 (NVIDIA H100 SXM data sheet rates; bytes and operations from
shapes).  ``BF16_FLOPS_PER_S`` is the data sheet's dense bfloat16 tensor
rate, the peak of ``mfu``.  ``chunk_rows`` and ``KEEP``/``BINS`` count the
work a gradient's chunks need: ceil(parameters / 4096) rows, whatever
padding rows an implementation adds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, an FMA counted as 2
# compares, adds, counts and multiplies that are not fused issue one per lane
# per clock, at half the FMA-counted rate
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)

CHUNK = 4096
BINS = CHUNK // 2 + 1


def keep(theta: float, bins: int = BINS) -> int:
    return max(1, int(round((1.0 - theta) * bins)))


def chunk_rows(n_params: int, chunk: int = CHUNK) -> int:
    return -(-int(n_params) // chunk)


def bound(n_bytes: float, n_instr: float, n_flops: float = 0.0):
    """Least time (ms) and what sets it: ``n_bytes`` over the HBM rate, or
    ``n_instr`` unfused fp32/int operations plus ``n_flops`` FMA-countable
    flops over the card's rates for them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_instr / FP32_INSTR_PER_S + n_flops / FP32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b2_bound(rows: int, cols: int, k: int, k_pad: int):
    """B2 with a tau: re, im, the weights, tau and the fit read, 6 bytes a
    slot written; the magnitude and compare a value, the encode a kept one."""
    return bound(rows * cols * 8 + cols * 4 + rows * 16 + rows * k_pad * 6,
                 rows * cols * 6 + 2 * rows * k * 30)


def b3_bound(rows: int, k: int, chunk: int = 4096):
    """B3: 4 bytes a kept slot and the fit read, the chunk written; the
    decode a slot and the irfft's flops."""
    return bound(rows * k * 4 + rows * 8 + rows * chunk * 4,
                 rows * 2 * k * 30, rows * 5 * chunk * 12)
