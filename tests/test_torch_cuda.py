"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes.  Marked ``cuda``: they skip without a GPU (as here on the
CPU) and run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: B1, B4, B2 bitwise; B3 max abs error <=
2e-6 * max|x| per row.
"""

import pytest
import torch

from repro_torch.core import fft as cfft
from repro_torch.core import selection
from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
from repro_torch.kernels import (fused_compress, fused_decompress, sampled_threshold,
                                 topk_threshold)

pytestmark = pytest.mark.cuda

K = 615


@pytest.fixture
def planes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((96, 4096), generator=gen, device="cuda") * 1e-2
    z = torch.fft.rfft(x, dim=-1)
    re, im = z.real.contiguous(), z.imag.contiguous()
    w = cfft.hermitian_weights(4096, "cuda")
    return re, im, w, torch.sqrt(re * re + im * im) * w


def test_threshold_kernels_bitwise(planes):
    *_, mag = planes
    for got, want in zip(topk_threshold.threshold(mag, k=K),
                         topk_threshold.threshold_plain(mag, K)):
        assert torch.equal(got, want)
    lo, hi = selection.sample_bracket(selection.strided_sample(mag), K, mag.shape[-1])
    for got, want in zip(sampled_threshold.sampled_threshold(mag, lo, hi, k=K),
                         sampled_threshold.sampled_threshold_plain(mag, lo, hi, k=K)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("tau_given", [True, False])
def test_fused_compress_bitwise_and_decompress(planes, tau_given):
    re, im, w, mag = planes
    tau = topk_threshold.threshold(mag, k=K)[0] if tau_given else None
    q = fit_quantizer(torch.minimum(re.amin(-1), im.amin(-1)),
                      torch.maximum(re.amax(-1), im.amax(-1)), RangeQuantConfig(8, 3))
    got = fused_compress.fused_compress(re, im, w, q.eps, q.p_codes, tau, k_keep=K)
    want = fused_compress.fused_compress_plain(re, im, w, q.eps, q.p_codes, tau, k_keep=K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rec, imc = got[0][:, :K].contiguous(), got[1][:, :K].contiguous()
    idx = got[2][:, :K].to(torch.int16).contiguous()
    y = fused_decompress.fused_decompress(rec, imc, idx, q.eps, q.p_codes)
    y_ref = fused_decompress.fused_decompress_plain(rec, imc, idx, q.eps, q.p_codes)
    err = (y - y_ref).abs().amax(-1)
    assert bool((err <= 2e-6 * y_ref.abs().amax(-1)).all())
