"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes.  Marked ``cuda``: they skip without a GPU (as here on the
CPU) and run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: B1, B4, B2, B5 and B6 bitwise; B3 and B7
max abs error <= 2e-6 * max|x| per row.
"""

import pytest
import torch

from repro_torch.core import fft as cfft
from repro_torch.core import selection
from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
from repro_torch.kernels import (fft4step, fused_compress, fused_decompress, pack,
                                 range_quant, sampled_threshold, topk_threshold)

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


@pytest.mark.parametrize("selector", ["bisect", "sampled"])
def test_fused_compress_bitwise_and_decompress(planes, selector):
    re, im, w, mag = planes
    if selector == "bisect":
        tau = topk_threshold.threshold(mag, k=K)[0]
    else:
        tau = sampled_threshold.sampled_select(mag, k=K)[0]
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


@pytest.mark.parametrize("n_bits,m_bits", [(8, 3), (12, 7)])
def test_range_quant_kernels_bitwise(planes, n_bits, m_bits):
    re, im, *_ = planes
    x = re[:, :640].contiguous()
    fits = fit_quantizer(x.amin(-1), x.amax(-1), RangeQuantConfig(n_bits, m_bits))
    one = fit_quantizer(x.amin(), x.amax(), RangeQuantConfig(n_bits, m_bits))
    for eps, p in ((fits.eps, fits.p_codes), (one.eps, one.p_codes)):
        codes = range_quant.encode(x, eps, p, n_bits=n_bits, m_bits=m_bits)
        want = range_quant.encode_plain(x, eps, p, n_bits=n_bits, m_bits=m_bits)
        assert codes.dtype == want.dtype and torch.equal(codes, want)
        got = range_quant.decode(codes, eps, p, n_bits=n_bits, m_bits=m_bits)
        assert torch.equal(got, range_quant.decode_plain(codes, eps, p, n_bits=n_bits,
                                                         m_bits=m_bits))


def test_pack_unpack_kernels_bitwise(planes):
    *_, mag = planes
    x = torch.where(torch.arange(mag.shape[1], device="cuda") % 3 == 0, -mag, mag)
    x[0] = 0.0  # an all-zero row: tau 0 keeps every column, cut at k
    tau = topk_threshold.threshold(x.abs(), k=K)[0]
    tau[1] = 0.0  # a count of 2049 > k
    k = 640
    got = pack.pack(x, tau, k=k)
    want = pack.pack_plain(x, tau, k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[1][1], torch.arange(k, dtype=torch.int32, device="cuda"))
    dense = pack.unpack(*got, cols=2560)
    assert torch.equal(dense, pack.unpack_plain(*got, cols=2560))


@pytest.mark.parametrize("inverse", [False, True])
def test_fft4096_kernel_within_tolerance(planes, inverse):
    re, im, *_ = planes
    x_re = torch.fft.irfft(torch.complex(re, im), n=4096, dim=-1).contiguous()
    x_im = torch.roll(x_re, 7, dims=0).contiguous()
    got = fft4step.fft4096(x_re, x_im, inverse=inverse)
    want = fft4step.fft4096_plain(x_re, x_im, inverse=inverse)
    scale = torch.maximum(want[0].abs().amax(-1), want[1].abs().amax(-1))
    for a, b in zip(got, want):
        assert bool(((a - b).abs().amax(-1) <= 2e-6 * scale).all())


@pytest.mark.parametrize("kw,kernel", [(dict(quantize=False), pack.PACK_KERNEL),
                                       (dict(chunk=2048), fused_compress.KERNEL)])
def test_auto_compress_on_the_card_runs_the_kernels(planes, kw, kernel):
    """auto sends a CUDA tensor to the cuda backend even where the config
    does not fuse end to end: the per-stage route launches its kernels."""
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig

    x = planes[0].reshape(-1)[: 40 * 4096 + 77].contiguous()
    auto = FFTCompressor(FFTCompressorConfig(backend="auto", selector="sampled", **kw))
    cuda = FFTCompressor(FFTCompressorConfig(backend="cuda", selector="sampled", **kw))
    before = kernel.launches
    got = auto.compress(x)
    assert kernel.launches > before
    want = cuda.compress(x)
    for a, b in ((got.re, want.re), (got.im, want.im), (got.idx, want.idx)):
        assert torch.equal(a, b)
