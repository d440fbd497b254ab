"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each beside
a plain PyTorch version of the same function, plus the compressor engine
and the kernel-composed pipeline (``ops``).

Every wrapper picks by the device of its input: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (or the wrapper raises).
:func:`all_kernels` lists the kernels with their launch counts.
"""

from __future__ import annotations

__all__ = ["all_kernels"]


def all_kernels():
    """Every kernel, B1..B7, as ``build.Kernel`` records (one per TPU
    ``pallas_call``; B5 and B6 have two entries in one source each, and B2
    a second one for its ``tau=None`` mode, which selects each row's tau
    with the whole CTA before it compresses)."""
    from repro_torch.kernels import (fft4step, fused_compress, fused_decompress, pack,
                                     range_quant, sampled_threshold, topk_threshold)

    return [topk_threshold.KERNEL, fused_compress.KERNEL, fused_compress.BISECT_KERNEL,
            fused_decompress.KERNEL,
            sampled_threshold.KERNEL, range_quant.ENCODE_KERNEL, range_quant.DECODE_KERNEL,
            pack.PACK_KERNEL, pack.UNPACK_KERNEL, fft4step.KERNEL]
