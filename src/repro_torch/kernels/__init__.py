"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each beside
a plain PyTorch version of the same function, plus the compressor engine.

Every wrapper picks by the device of its input: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (or the wrapper raises).
:func:`all_kernels` lists the kernels with their launch counts.
"""

from __future__ import annotations

__all__ = ["all_kernels"]


def all_kernels():
    """The four hot-path kernels, B1..B4, as ``build.Kernel`` records."""
    from repro_torch.kernels import (fused_compress, fused_decompress,
                                     sampled_threshold, topk_threshold)

    return [topk_threshold.KERNEL, fused_compress.KERNEL,
            fused_decompress.KERNEL, sampled_threshold.KERNEL]
