"""B7: batched 4096-point complex FFT (port of
``repro.kernels.fft4step.fft4096_pallas``).

:func:`fft4096` maps ``(rows, 4096)`` re/im planes to the re/im planes of
their DFT, or with ``inverse=True`` of their inverse DFT scaled by 1/4096.

The CUDA kernel is ``csrc/fft4096.cu``: three radix-16 passes with the row
in registers and two exchanges through shared memory (the complex core of
``csrc/fft4096.cuh``, beside the real inverse core that B3 runs;
``tests/test_torch_fft4096_design.py`` walks both cores' index maps and
:func:`twiddles` in numpy).  The plain version is the reference's
four-step math (Bailey: 64-point DFT matmuls along the columns, a twiddle,
64-point DFT matmuls along the rows, a transposed read-out) as float32
``torch.matmul`` -- run it with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default), as
the reference runs ``Precision.HIGHEST``.  Tolerance between the two: max
abs error <= 2e-6 * max|X| per row and plane -- both are fp32 FFTs that
round at different places (the four-step sums 64-term dot products; the
radix-16 kernel rounds once per pass and twiddle).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import _checks
from repro_torch.kernels.build import Kernel, kernel_op, ptr

__all__ = ["KERNEL", "CHUNK", "N1", "RADIX", "fft4096", "fft4096_plain", "twiddles"]

CHUNK = 4096
N1 = 64  # the four-step's matrix side: 4096 = 64 x 64
RADIX = 16  # the kernel's passes: 4096 = 16 x 16 x 16, 256 threads x 16 points

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "fft4096", "fft4096.cu",
    replaces="src/repro/kernels/fft4step.py:138",
    entry="fft4096",
    argtypes=[_P, _P, _I, _I, _P, _P, _P],
)

_TWIDDLES: Dict[torch.device, torch.Tensor] = {}


def twiddles(device) -> torch.Tensor:
    """The kernels' twiddle table, ``(4096 + 256 + 2048, 2)`` float32 (re, im)
    pairs of exp(+2*pi*i*e/4096) computed in double, laid out in the order
    the CUDA cores read them (``csrc/fft4096.cuh``), so that each warp reads
    one contiguous span; the forward transform negates the imaginary part:

    * entry ``t + 256*k0`` (thread t < 256, output k0 < 16 of the complex
      core's first pass): e = t*k0;
    * entry ``4096 + n0 + 16*k1`` (n0, k1 < 16, its second pass): e = 16*n0*k1;
    * entry ``4352 + n`` (n < 2048, the real inverse core's input): e = n.
    """
    if device not in _TWIDDLES:
        t = np.arange(CHUNK // RADIX)
        r = np.arange(RADIX)
        e = np.concatenate([(r[:, None] * t[None, :]).reshape(-1),  # [k0, t]
                            (RADIX * r[:, None] * r[None, :]).reshape(-1),  # [k1, n0]
                            np.arange(CHUNK // 2)])
        ang = 2.0 * np.pi * (e % CHUNK) / CHUNK
        tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
        _TWIDDLES[device] = torch.from_numpy(tw).to(device)
    return _TWIDDLES[device]


@functools.lru_cache(maxsize=4)
def _dft_constants(inverse: bool):
    """(F64_re, F64_im, W_re, W_im) as float32 numpy arrays, as the
    reference computes them."""
    sign = 2.0 if inverse else -2.0
    k = np.arange(N1)[:, None]
    n = np.arange(N1)[None, :]
    f = np.exp(sign * 1j * np.pi * k * n / N1)
    w = np.exp(sign * 1j * np.pi * k * n / CHUNK)  # w^(k1*n2)
    return tuple(a.astype(np.float32) for a in (f.real, f.imag, w.real, w.imag))


def fft4096_plain(x_re, x_im, *, inverse: bool = False):
    """Plain PyTorch version: the reference's four-step math per row."""
    rows = x_re.shape[0]
    fre, fim, wre, wim = (torch.from_numpy(c).to(x_re.device)
                          for c in _dft_constants(bool(inverse)))
    # matrix view xm[n1, n2] = x[n1 * 64 + n2], one per row
    xre = x_re.float().reshape(rows, N1, N1)
    xim = x_im.float().reshape(rows, N1, N1)
    # stage 1: A = F64 @ xm
    are = torch.matmul(fre, xre) - torch.matmul(fim, xim)
    aim = torch.matmul(fre, xim) + torch.matmul(fim, xre)
    # stage 2: twiddle W[k1, n2]
    bre = are * wre - aim * wim
    bim = are * wim + aim * wre
    del are, aim
    # stage 3: Xm = B @ F64^T
    xmre = torch.matmul(bre, fre.T) - torch.matmul(bim, fim.T)
    xmim = torch.matmul(bre, fim.T) + torch.matmul(bim, fre.T)
    del bre, bim
    # stage 4: read-out X[k2 * 64 + k1] = Xm[k1, k2]
    out_re = xmre.transpose(1, 2).reshape(rows, CHUNK)
    out_im = xmim.transpose(1, 2).reshape(rows, CHUNK)
    if inverse:
        return out_re * (1.0 / CHUNK), out_im * (1.0 / CHUNK)
    return out_re, out_im


def _fft4096(x_re, x_im, inverse: bool):
    if _checks.on_cpu(x_re):
        return fft4096_plain(x_re, x_im, inverse=inverse)
    rows = x_re.shape[0]
    dev = x_re.device
    _checks.require("x_re", x_re, torch.float32, shape=(rows, CHUNK))
    _checks.require("x_im", x_im, torch.float32, shape=(rows, CHUNK), device=dev)
    y_re = torch.empty((rows, CHUNK), dtype=torch.float32, device=dev)
    y_im = torch.empty((rows, CHUNK), dtype=torch.float32, device=dev)
    if rows:
        KERNEL.launch(dev, ptr(x_re), ptr(x_im), rows, int(bool(inverse)), ptr(twiddles(dev)),
                      ptr(y_re), ptr(y_im))
    return y_re, y_im


_OP = kernel_op(KERNEL.name, "(Tensor x_re, Tensor x_im, bool inverse) -> (Tensor, Tensor)",
                _fft4096, lambda x_re, x_im, inverse: (
                    x_re.new_empty((x_re.shape[0], CHUNK), dtype=torch.float32),
                    x_re.new_empty((x_re.shape[0], CHUNK), dtype=torch.float32)))


def fft4096(x_re, x_im, *, inverse: bool = False):
    """(rows, 4096) re/im f32 -> (rows, 4096) re/im f32 of the DFT (or the
    inverse DFT / 4096).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    return _OP(x_re, x_im, bool(inverse))
