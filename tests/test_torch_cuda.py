"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes.  Marked ``cuda``: they skip without a GPU (as here on the
CPU) and run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The last test holds the weight-delta ring's publisher mirror and a
subscriber bitwise on the card.  Tolerances as in chip_smoke.py: B1, B4,
B2, B5 and B6 bitwise; B3 and B7 max abs error <= 2e-6 * max|x| per row.  Build the kernels first with
``repro_torch.kernels.build.build(...)`` so the nvcc runs go in parallel.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fft as cfft
from repro_torch.core import selection, sparsify
from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
from repro_torch.kernels import (fft4step, fused_compress, fused_decompress, pack,
                                 range_quant, sampled_threshold, topk_threshold)

pytestmark = pytest.mark.cuda

K = 615


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.fixture
def planes(card):
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
    for got, want in zip(sampled_threshold.sampled_select(mag, k=K),
                         sampled_threshold.sampled_select_plain(mag, k=K)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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


def _edge_values(eps, cols):
    """Row r: NaN, -NaN, +-inf, +-0, denormals, +-1e30, then +-eps, +-eps/2,
    every segment bound +-eps * 2^q (q < 40) and the float on each side of
    each, at row r's eps (the first ``cols`` of these 256 values)."""
    rows = eps.shape[0]
    fixed = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
                          1e-40, -1e-40, 1e30, -1e30], device="cuda").expand(rows, -1)
    bounds = eps[:, None] * torch.cat([torch.tensor([1.0, 0.5], device="cuda"),
                                       2.0 ** torch.arange(1, 40, device="cuda")])
    up = (bounds.view(torch.int32) + 1).view(torch.float32)
    down = (bounds.view(torch.int32) - 1).view(torch.float32)
    vals = torch.cat([fixed, bounds, -bounds, up, -up, down, -down], dim=1)
    return vals[:, :cols]


@pytest.mark.parametrize("n_bits,m_bits", [(8, 3), (12, 7)])
def test_range_quant_kernels_bitwise(planes, n_bits, m_bits):
    """B5a and B5b against their plain versions, bitwise, on spectrum values
    with edge values in their first columns (NaN and -NaN to code 0), at
    the widths chip_smoke.py runs (640, 384) and odd ones (130, 1, 2049:
    the one-value path), one fit per row and one fit."""
    re, im, *_ = planes
    for cols in (640, 384, 130, 1, 2049):
        x = re[:, :cols].contiguous()
        fits = fit_quantizer(x.amin(-1), x.amax(-1), RangeQuantConfig(n_bits, m_bits))
        one = fit_quantizer(x.amin(), x.amax(), RangeQuantConfig(n_bits, m_bits))
        for eps, p in ((fits.eps, fits.p_codes), (one.eps, one.p_codes)):
            e = torch.as_tensor(eps, device="cuda").reshape(-1).expand(x.shape[0])
            edge = _edge_values(e, cols)
            x_e = x.clone()
            x_e[:, :edge.shape[1]] = edge
            codes = range_quant.encode(x_e, eps, p, n_bits=n_bits, m_bits=m_bits)
            want = range_quant.encode_plain(x_e, eps, p, n_bits=n_bits, m_bits=m_bits)
            assert codes.dtype == want.dtype and torch.equal(codes, want), cols
            assert not codes[:, :min(2, cols)].int().any()  # NaN and -NaN: code 0
            got = range_quant.decode(codes, eps, p, n_bits=n_bits, m_bits=m_bits)
            want_y = range_quant.decode_plain(codes, eps, p, n_bits=n_bits, m_bits=m_bits)
            assert torch.equal(got.view(torch.int32), want_y.view(torch.int32)), cols


@pytest.mark.parametrize("n_bits,m_bits", [(8, 3), (4, 2), (12, 4)])
def test_range_quant_kernels_on_edge_rows_per_row_fits(card, n_bits, m_bits):
    """B5a on rows of edge values with fits of every kind of eps (tiny,
    large, the 12-bit fits' 1e-30 floor) and a fractional P (the exact path
    throughout), and B5b on the codes, bitwise."""
    lo = torch.tensor([-1.0, -1e-30, -3e5, -0.02, -1e-3], device="cuda")
    hi = torch.tensor([1.0, 1e-30, 2e5, 3.0, 1e-3], device="cuda")
    q = fit_quantizer(lo, hi, RangeQuantConfig(n_bits, m_bits))
    eps, p = q.eps, q.p_codes.float()
    p[-1] += 0.5
    x = _edge_values(eps, 512).contiguous()
    kw = dict(n_bits=n_bits, m_bits=m_bits)
    codes = range_quant.encode(x, eps, p, **kw)
    assert torch.equal(codes, range_quant.encode_plain(x, eps, p, **kw))
    got = range_quant.decode(codes, eps, p, **kw)
    assert torch.equal(got.view(torch.int32),
                       range_quant.decode_plain(codes, eps, p, **kw).view(torch.int32))


def test_range_quant_kernels_on_every_float(card):
    """B5a on all 2^32 float32 bit patterns (in chunks of 2^28, rows of 512)
    for one 8/3 fit, and B5b on their codes, against the plain versions:
    bitwise."""
    q = fit_quantizer(-0.3, 0.5, RangeQuantConfig(8, 3))
    chunk = 1 << 28
    for start in range(0, 1 << 32, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int64, device="cuda")
        x = bits.to(torch.int32).view(torch.float32).reshape(-1, 512)
        del bits
        codes = range_quant.encode(x, q.eps, q.p_codes)
        want = range_quant.encode_plain(x, q.eps, q.p_codes)
        bad = int((codes != want).sum())
        assert bad == 0, (start, bad)
        del x, want
        got = range_quant.decode(codes, q.eps, q.p_codes)
        want_y = range_quant.decode_plain(codes, q.eps, q.p_codes)
        assert torch.equal(got.view(torch.int32), want_y.view(torch.int32)), start
        del codes, got, want_y


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


@pytest.mark.parametrize("rows", [1, 3, 133])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft4096_kernel_row_counts(planes, rows, inverse):
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x_re, x_im = (torch.randn((rows, 4096), generator=gen, device="cuda") for _ in range(2))
    got = fft4step.fft4096(x_re, x_im, inverse=inverse)
    want = fft4step.fft4096_plain(x_re, x_im, inverse=inverse)
    scale = torch.maximum(want[0].abs().amax(-1), want[1].abs().amax(-1))
    for a, b in zip(got, want):
        assert a.shape == (rows, 4096)
        assert bool(((a - b).abs().amax(-1) <= 2e-6 * scale).all())


@pytest.mark.parametrize("inverse", [False, True])
def test_fft4096_kernel_known_answers(planes, inverse):
    """Unit impulses at n = p and single complex exponentials of frequency
    f, whose transforms are exact: W^(p k) and 4096 * delta(k - f) (inverse:
    W^(-p k) / 4096 and delta(k - f))."""
    shifts = [0, 1, 5, 255, 256, 2048, 4095]
    n = np.arange(4096)
    sign = 1.0 if inverse else -1.0
    x = np.zeros((2 * len(shifts), 4096), np.complex128)
    want = np.zeros_like(x)
    for r, p in enumerate(shifts):
        x[r, p] = 1.0
        want[r] = np.exp(sign * 2j * np.pi * p * n / 4096)
        x[len(shifts) + r] = np.exp(-sign * 2j * np.pi * p * n / 4096)
        want[len(shifts) + r, p] = 4096.0
    if inverse:
        want /= 4096.0
    x_re, x_im = (torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda()
                  for v in (x.real, x.imag))
    got_re, got_im = (v.cpu().numpy() for v in fft4step.fft4096(x_re, x_im, inverse=inverse))
    err = np.abs(got_re + 1j * got_im - want).max(-1)
    assert np.all(err <= 2e-6 * np.abs(want).max(-1)), err


def _payload(rows, k, code_dtype, idx_dtype, n_bits, seed):
    """Random codes at k distinct bins per row (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(2049, k, replace=False)) for _ in range(rows)])
    rec, imc = rng.integers(0, 1 << n_bits, (2, rows, k))
    return rec.astype(code_dtype), imc.astype(code_dtype), idx.astype(idx_dtype)


@pytest.mark.parametrize("case", ["dc_nyquist", "corrupt_index", "k1", "k2049", "u16_i32"])
def test_fused_decompress_kernel_edge_payloads(planes, case):
    """B3 against its plain version on payloads that set DC and Nyquist,
    carry indices outside [0, 2048] (the kernel adds nothing for them; the
    plain version, whose scatter would fault, gets code 0 at bin 0 there),
    keep 1 or all 2049 bins, or use uint16 codes with int32 indices.  The
    imaginary codes at DC and Nyquist are 0, as in a real signal's spectrum:
    cuFFT's C2R, which the plain version calls, does not ignore an imaginary
    part there, while the kernel, as the reference, keeps the real part of
    the full inverse, to which it adds nothing (checked on its own)."""
    n_bits, m_bits = (12, 7) if case == "u16_i32" else (8, 3)
    k = {"k1": 1, "k2049": 2049}.get(case, 615)
    code_dtype = np.uint16 if case == "u16_i32" else np.uint8
    idx_dtype = np.int32 if case == "u16_i32" else np.int16
    rec, imc, idx = _payload(5, k, code_dtype, idx_dtype, n_bits, seed=k + n_bits)
    if case == "dc_nyquist":
        idx[:, 0], idx[:, -1] = 0, 2048
        rec[:, 0], rec[:, -1] = 200, 77
    dc_nyquist = (idx == 0) | (idx == 2048)
    imc[dc_nyquist] = 0
    plain_rec, plain_imc, plain_idx = rec, imc, idx
    if case == "corrupt_index":
        idx[:, 3], idx[:, 10], idx[2, 100] = -1, 3000, 2049
        bad = (idx < 0) | (idx > 2048)
        plain_rec, plain_imc, plain_idx = (np.where(bad, 0, a).astype(a.dtype)
                                           for a in (rec, imc, idx))
    q = fit_quantizer(torch.full((5,), -0.3, device="cuda"),
                      torch.linspace(0.1, 0.5, 5, device="cuda"), RangeQuantConfig(n_bits, m_bits))

    def run(fn, *payload):
        return fn(*(torch.from_numpy(a).cuda() for a in payload), q.eps, q.p_codes,
                  m_bits=m_bits)

    got = run(fused_decompress.fused_decompress, rec, imc, idx)
    want = run(fused_decompress.fused_decompress_plain, plain_rec, plain_imc, plain_idx)
    assert got.shape == (5, 4096) and bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(-1)
    assert bool((err <= 2e-6 * want.abs().amax(-1)).all()), err
    if case == "dc_nyquist":
        imc_dc = np.where(dc_nyquist, 99, imc).astype(imc.dtype)
        assert torch.equal(got, run(fused_decompress.fused_decompress, rec, imc_dc, idx))


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


def _compress_rows(cols, k_keep, seed, rows=37):
    """(re, im, w, tau) in numpy: random spectrum rows at the k_keep-th
    magnitude, row 0 all zero (tau 0: every bin kept, cut at k_pad), row 1
    with tau 0 (all 'cols' bins kept), row 2 with tau above its maximum."""
    rng = np.random.default_rng(seed)
    re, im = (rng.standard_normal((2, rows, cols)) * 0.05).astype(np.float32)
    re[0], im[0] = 0.0, 0.0
    w = np.full(cols, 2.0, np.float32)
    w[0] = w[-1] = 1.0
    mag = (np.sqrt(re * re + im * im) * w).astype(np.float32)
    tau = -np.sort(-mag, axis=1)[:, k_keep - 1]
    tau[:2] = 0.0
    tau[2] = np.float32(2.0) * mag[2].max()
    return re, im, w, tau.astype(np.float32)


@pytest.mark.parametrize("quant", ["u8-scalar", "u16-per-row"])
@pytest.mark.parametrize("k_keep", [127, 128, 129, 0])
@pytest.mark.parametrize("cols", [2049, 1025, 513])
def test_fused_compress_kernel_edge_rows(card, cols, k_keep, quant):
    """B2 against its plain version, bitwise, around the 128-slot tile
    (k_keep 127, 128, 129, and 0 for the 70% drop's keep count), at the
    main path's widths and 513, with an all-zero row, a row keeping every
    bin and a row keeping none; 8-bit codes with one fit, 16-bit codes
    (n_bits 12, m_bits 7) with one fit per row."""
    k_keep = k_keep or sparsify.keep_count(cols, 0.7)
    n_bits, m_bits = (8, 3) if quant == "u8-scalar" else (12, 7)
    re, im, w, tau = (torch.from_numpy(a).cuda() for a in _compress_rows(cols, k_keep, cols))
    if quant == "u8-scalar":
        q = fit_quantizer(torch.minimum(re.min(), im.min()), torch.maximum(re.max(), im.max()),
                          RangeQuantConfig(n_bits, m_bits))
    else:
        q = fit_quantizer(torch.minimum(re.amin(-1), im.amin(-1)),
                          torch.maximum(re.amax(-1), im.amax(-1)), RangeQuantConfig(n_bits, m_bits))
    kw = dict(k_keep=k_keep, n_bits=n_bits, m_bits=m_bits)
    got = fused_compress.fused_compress(re, im, w, q.eps, q.p_codes, tau, **kw)
    want = fused_compress.fused_compress_plain(re, im, w, q.eps, q.p_codes, tau, **kw)
    assert got[0].shape == (re.shape[0], fused_compress.pad_k(k_keep))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    k_pad = fused_compress.pad_k(k_keep)
    expect = torch.arange(k_pad, dtype=torch.int32)
    expect[cols:] = 0
    assert torch.equal(got[2][0].cpu(), expect)  # the zero row: the first columns
    assert not got[2][2].any() and not got[0][2].int().any()  # nothing kept (no uint16 any)


@pytest.mark.parametrize("kind", ["spectrum", "nan", "inf", "nan_inf", "zero", "tied", "flt_max",
                                  "few_finite", "negative"])
@pytest.mark.parametrize("quant", ["u8-scalar", "u16-per-row"])
@pytest.mark.parametrize("cols,k_keep", [(2049, 615), (1025, 308), (513, 129), (4096, 1229),
                                         (300, 127), (100, 31)])
def test_fused_compress_bisect_kernel(card, cols, k_keep, quant, kind):
    """B2 with ``tau=None`` against its plain version (codes, indices, tau)
    and its tau against B1's on the same magnitudes, bitwise (tau by its
    bits): spectrum rows with an all-zero row, rows holding a NaN, a +inf
    (the rest scaled by 1e18) or both, all-zero rows, rows tied past B1's 64
    candidates, all-FLT_MAX rows (re = 1 under weights FLT_MAX), rows with
    k - 1 non-NaN values and rows of negative magnitudes (negated weights:
    the kernel's fmaxf maximum), at widths from all-tail rows to 4096; 37
    rows."""
    re, im, w, _ = (torch.from_numpy(a).cuda() for a in _compress_rows(cols, k_keep, cols))
    if kind in ("nan", "nan_inf"):
        re[:, cols // 3] = float("nan")
    if kind == "inf":
        re *= 1e18
        im *= 1e18
    if kind in ("inf", "nan_inf"):
        re[:, cols - 1] = float("inf")
    if kind == "zero":
        re[:], im[:] = 0.0, 0.0
    if kind in ("tied", "flt_max"):
        re[:], im[:] = 0.25 if kind == "tied" else 1.0, 0.0
    if kind == "flt_max":
        w[:] = torch.finfo(torch.float32).max
    if kind == "few_finite":
        re[:, k_keep - 1:] = float("nan")
    if kind == "negative":
        w = -w
    n_bits, m_bits = (8, 3) if quant == "u8-scalar" else (12, 7)
    fin = torch.isfinite(re) & torch.isfinite(im)
    lo = torch.minimum(torch.where(fin, re, 0.0).amin(-1), torch.where(fin, im, 0.0).amin(-1))
    hi = torch.maximum(torch.where(fin, re, 0.0).amax(-1), torch.where(fin, im, 0.0).amax(-1))
    if quant == "u8-scalar":
        lo, hi = lo.min(), hi.max()
    q = fit_quantizer(lo, hi, RangeQuantConfig(n_bits, m_bits))
    kw = dict(k_keep=k_keep, n_bits=n_bits, m_bits=m_bits)
    before = fused_compress.BISECT_KERNEL.launches
    got = fused_compress.fused_compress(re, im, w, q.eps, q.p_codes, **kw)
    assert fused_compress.BISECT_KERNEL.launches == before + 1
    want = fused_compress.fused_compress_plain(re, im, w, q.eps, q.p_codes, **kw)
    assert got[3].shape == (re.shape[0], 1)
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.dtype == b.dtype and torch.equal(a, b)
    mag = torch.sqrt(re * re + im * im) * w
    tau_b1 = topk_threshold.threshold(mag, k=k_keep)[0]
    assert torch.equal(got[3].view(torch.int32).cpu(), tau_b1.view(torch.int32).cpu())


def _bracket_rows(mag, kind, sample_rate, seed):
    """``mag`` (rows, cols) in numpy, in place, made ``kind`` rows: the
    sampled selector's own rows, a sample far above the row (count(>= lo)
    < k: lo falls back to 0) or all 0 (count(>= hi) >= k: hi falls back to
    nextafter(max)), all-zero rows (the denormal bracket [0, 2**-149]), tied
    magnitudes, rows holding a NaN or +inf, in the row and in the sample."""
    rows, cols = mag.shape
    s, stride, offset = selection._sample_layout(cols, sample_rate, seed)
    sample_cols = offset + stride * np.arange(s)
    if kind == "zero":
        mag[:] = 0.0
    elif kind == "ties":
        mag[:] = np.floor(mag * 3)
    elif kind == "nan":
        mag[:, 5] = np.nan
        mag[::3, sample_cols[s // 2]] = np.nan
    elif kind == "inf":
        mag[:, cols - 1] = np.inf
        mag[::3, sample_cols[0]] = np.inf
    elif kind == "lo_high":
        mag[:, sample_cols] = np.float32(1e30)
    elif kind == "hi_low":
        mag[::2, sample_cols] = 0.0  # and rows that keep their bracket
    return mag


def _select_both(mag, k, **kw):
    """B4 and its plain chain on the same CUDA magnitudes, each with the
    fallback counter it adds to: ((tau_k, count, tau), fallback rows) x 2."""
    from repro_torch import tracing

    out = []
    for fn in (sampled_threshold.sampled_select, sampled_threshold.sampled_select_plain):
        tracing.enable(True)
        tracing.reset()
        try:
            got = fn(mag, k=k, **kw)
            out.append((got, tracing.counters().get(sampled_threshold.FALLBACK_COUNTER)))
        finally:
            tracing.enable(False)
    return out


def _assert_select_bitwise(got, want):
    (g, g_fell), (w, w_fell) = got, want
    for a, b in zip(g, w):
        assert torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))
    assert g_fell == w_fell


@pytest.mark.parametrize("sample_rate", [1 / 64, 1 / 16])
@pytest.mark.parametrize("kind", ["sampled", "lo_high", "hi_low", "zero", "ties", "nan", "inf"])
@pytest.mark.parametrize("cols", [2049, 1025])
def test_sampled_threshold_kernel_edge_rows(card, cols, kind, sample_rate):
    """B4 (the sample's bracket, the clamp and sweeps, the mid-gap) against
    its plain chain, bitwise in tau_k, count and tau, with the same count of
    rows whose bracket fell back; 37 rows, not a multiple of the kernel's 4
    rows per CTA; rate 1/16 reads 4 sample values a lane at 2049 columns."""
    seed = cols + len(kind)
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((37, cols))).astype(np.float32)
    mag = torch.from_numpy(_bracket_rows(mag, kind, sample_rate, seed)).cuda()
    k = sparsify.keep_count(cols, 0.7)
    got, want = _select_both(mag, k, sample_rate=sample_rate, seed=seed)
    _assert_select_bitwise(got, want)
    if kind in ("lo_high", "zero"):
        assert got[1] == 37


CELL_ROWS, CELL_COLS = 329_929, 2049  # the phi3m-l3 cells' chunk rows and bins


def test_sampled_select_kernel_at_the_cell_shape(card):
    """B4 at the phi3m-l3 cells' 329,929 rows of 2049 bins, k = 615, the
    rfft magnitudes of random chunks with 6 x 96 edge rows first (the kinds
    of the edge-row test), against its plain chain bitwise, fallback rows
    counted alike."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    mag = torch.empty((CELL_ROWS, CELL_COLS), device="cuda")
    w = cfft.hermitian_weights(4096, "cuda")
    for r in range(0, CELL_ROWS, 65_536):
        z = torch.fft.rfft(torch.randn((min(65_536, CELL_ROWS - r), 4096), generator=gen,
                                       device="cuda") * 1e-3, dim=-1)
        mag[r:r + z.shape[0]] = torch.sqrt(z.real * z.real + z.imag * z.imag) * w
    kinds = ["lo_high", "hi_low", "zero", "ties", "nan", "inf"]
    for i, kind in enumerate(kinds):
        rows = mag[96 * i:96 * (i + 1)]
        rows.copy_(torch.from_numpy(_bracket_rows(rows.cpu().numpy(), kind, 1 / 64, 0)))
    got, want = _select_both(mag, K)
    _assert_select_bitwise(got, want)
    assert got[1] >= 2 * 96


def test_compress_stacked_payload_at_the_cell_shape_is_the_plain_chains(card, monkeypatch):
    """One ``compress_stacked`` payload at the phi3m-l3 cell's layout (81
    buckets of 64 MiB, 329,929 valid chunk rows) with B4 giving the mid-gap
    tau equals, bitwise, the payload with the plain chain in its place: the
    sampled bracket and the mid-gap as eager ops around the refinement, as
    the engine ran them before B4 took them in."""
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig

    bucket = 16 * 1024 * 1024
    sizes = (bucket,) * 80 + (1_351_388_160 - 80 * bucket,)
    gen = torch.Generator(device="cuda").manual_seed(2)
    stacked = torch.randn((81, bucket), generator=gen, device="cuda") * 1e-3
    stacked[-1, sizes[-1]:] = 0.0
    comp = FFTCompressor(FFTCompressorConfig(backend="cuda", selector="sampled"))
    before = sampled_threshold.KERNEL.launches
    got = comp.compress_stacked(stacked, sizes)
    assert sampled_threshold.KERNEL.launches == before + 1
    monkeypatch.setattr(sampled_threshold, "sampled_select",
                        sampled_threshold.sampled_select_plain)
    want = comp.compress_stacked(stacked, sizes)
    assert sampled_threshold.KERNEL.launches == before + 1
    for a, b in ((got.re, want.re), (got.im, want.im), (got.idx, want.idx),
                 (got.quant.eps, want.quant.eps), (got.quant.p_codes, want.quant.p_codes)):
        assert torch.equal(a, b)


def _threshold_rows(cols, kind, seed, rows=37):
    """(mag, k) in numpy for B1: ``rows`` rows of one kind (37: not a
    multiple of the kernel's 4 rows per CTA)."""
    rng = np.random.default_rng(seed)
    k = sparsify.keep_count(cols, 0.7)
    mag = np.abs(rng.standard_normal((rows, cols))).astype(np.float32)
    if kind == "spectrum" and cols > 1:
        z = np.fft.rfft(rng.standard_normal((rows, 2 * (cols - 1))) * 1e-3, axis=-1)
        mag = (np.abs(z) * 2.0).astype(np.float32)
        mag[::5] = 0.0  # the stacked layout's padding rows
    elif kind == "zero":
        mag[:] = 0.0
    elif kind == "ties":
        mag = np.floor(mag * 3).astype(np.float32)
    elif kind == "tiny":  # one huge value: 48 sweeps never reach the rest
        mag *= np.float32(1e-3)
        mag[:, cols // 2] = np.float32(1e30)
    elif kind == "nan":  # the plain version's bracket is NaN: tau 0
        mag[:, cols // 3] = np.nan
        mag[::3] *= np.float32(1e-3)  # some rows with a denormal-free small range
    elif kind == "inf":  # upper_bracket(+inf) is a NaN: tau 0, however large the rest
        mag *= np.float32(1e30)
        mag[:, cols - 1] = np.inf
    elif kind == "nan_inf":
        mag[:, 0] = np.inf
        mag[::2, cols // 2] = np.nan
    elif kind == "flt_max":
        mag[:, cols // 2] = np.finfo(np.float32).max
    elif kind == "all_flt_max":
        mag[:] = np.finfo(np.float32).max
    return mag, k


@pytest.mark.parametrize("kind", ["random", "spectrum", "zero", "ties", "tiny", "nan", "inf",
                                  "nan_inf", "flt_max", "all_flt_max"])
@pytest.mark.parametrize("cols", [1, 31, 33, 257, 511, 513, 1025, 2049, 4096])
def test_topk_threshold_kernel_edge_rows(card, cols, kind):
    """B1 against its plain version, bitwise (tau by its bits): rows holding
    a NaN or +inf (tau 0 with count(>= 0), as torch.amax and upper_bracket
    give it), all-zero rows, ties, a huge maximum over tiny values, FLT_MAX
    and all-FLT_MAX rows, at every width the lane dispatch serves."""
    mag, k = _threshold_rows(cols, kind, cols + len(kind))
    mag = torch.from_numpy(mag).cuda()
    got = topk_threshold.threshold(mag, k=k)
    want = topk_threshold.threshold_plain(mag, k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def _pack_rows(cols, kind, seed, rows=37):
    """(x, tau, k) in numpy for B6a: signed rows and per-row tau giving
    ``kind`` counts; k the 128-multiple above the 70% drop's keep count."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    k = pack.K_TILE * -(-sparsify.keep_count(cols, 0.7) // pack.K_TILE)
    ranked = -np.sort(-np.abs(x), axis=1)
    if kind == "none":
        tau = np.full(rows, np.inf, np.float32)
    elif kind == "exact":  # min(k, cols) kept
        tau = ranked[:, min(k, cols) - 1].copy()
    elif kind == "over":  # tau 0: every column kept, cut at k; an all-zero row
        tau = np.zeros(rows, np.float32)
        x[0] = 0.0
    elif kind == "nan":  # NaN values are never kept; a NaN tau keeps nothing
        x[:, ::7] = np.nan
        tau = ranked[:, cols // 3].copy()
        tau[1] = np.nan
    else:  # "random"
        tau = ranked[:, cols // 3].copy()
    return x, tau.astype(np.float32), k


@pytest.mark.parametrize("kind", ["none", "exact", "over", "nan", "random"])
@pytest.mark.parametrize("cols", [1, 100, 255, 256, 513, 1025, 2049, 4096, 5000])
def test_pack_kernel_edge_rows(card, cols, kind):
    """B6a against its plain version, bitwise: nothing kept, exactly k kept,
    every column kept with the count cut at k (tau 0, an all-zero row among
    them), NaN values and a NaN tau, at widths from all-tail rows (under 256
    columns) to 4096 and past it (warp 7's tail beyond the stretches)."""
    x, tau, k = _pack_rows(cols, kind, cols + len(kind))
    x, tau = torch.from_numpy(x).cuda(), torch.from_numpy(tau).cuda()[:, None]
    got = pack.pack(x, tau, k=k)
    want = pack.pack_plain(x, tau, k=k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def test_publish_mirror_and_subscriber_bitwise(card, tmp_path):
    """The weight-delta ring on the card: the publisher's mirror and a
    subscriber that caught up (a catch-up over two deltas, then the gap
    path after the ring wrapped past it) hold bitwise the same weights; the
    deltas go through B4 and B2."""
    from repro_torch.serve import PublishConfig, ReplicaSubscriber, WeightDeltaPublisher

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"w": torch.randn((300, 1000), generator=gen, device="cuda") * 0.02}
    pub = WeightDeltaPublisher(str(tmp_path), params, PublishConfig(
        theta=0.7, snapshot_every=2, capacity=2, backend="cuda", selector="auto"))
    sub = ReplicaSubscriber(str(tmp_path))
    for step in range(5):
        params = {"w": params["w"] + 1e-3 * torch.randn_like(params["w"])}
        pub.publish(step, params)
        if step == 1:
            assert sub.sync().applied == 2
            assert torch.equal(sub.weights(), pub.state.materialize())
    stats = sub.sync()
    assert stats.gap_detected and stats.version == 5
    assert torch.equal(sub.weights(), pub.state.materialize())
