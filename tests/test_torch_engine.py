"""Port parity of the compressor engine's stacked entry points.

The port's ``reference`` backend is held against the reference's
``reference`` backend, and the port's ``cuda`` backend -- on the CPU, so
through the kernels' plain versions -- against the reference's ``pallas``
backend in interpret mode, on ragged 3-bucket layouts.

Stage inputs are shared: ``torch.fft.rfft`` is patched to return XLA's rfft
of the same rows (the two FFT libraries agree bitwise on only ~17% of bins,
ROADMAP), so everything after the forward transform sees identical planes.

Tolerances:
* kept indices and P: bitwise;
* eps: within two ulps (XLA's and torch's exp differ by an ulp on some
  inputs; see test_torch_quantizer.py), so a code may move by one step on at
  most 0.5% of slots -- in practice none;
* reconstructions (``decompress_stacked``): max abs error <= 2e-6 * max|x|
  per chunk row (fp32 FFTs summed in different orders).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import bucketing as jb
from repro.core import compressor as jc
from repro_torch.comms import bucketing as tb
from repro_torch.core import compressor as tc
from repro_torch.core.quantizer import FittedQuantizer as TFQ, RangeQuantConfig as TRQ

N = 7 * 4096 + 100  # buckets of 3, 3 and 2 chunk rows (the last one padded)
BUCKET_BYTES = 3 * 4096 * 4


@pytest.fixture
def xla_rfft(monkeypatch):
    """torch.fft.rfft -> XLA's rfft of the same rows (shared stage input)."""
    def rfft(x, dim=-1):
        assert dim == -1
        z = np.asarray(jnp.fft.rfft(jnp.asarray(x.detach().numpy()), axis=-1))
        return torch.from_numpy(z.astype(np.complex64))

    monkeypatch.setattr(torch.fft, "rfft", rfft)


def _flat(seed):
    return (np.random.default_rng(seed).standard_normal(N) * 0.05).astype(np.float32)


def _payload_to_torch(p):
    q = None
    if p.quant is not None:
        q = TFQ(TRQ(p.quant.config.n_bits, p.quant.config.m_bits),
                *(torch.from_numpy(np.array(getattr(p.quant, f)))
                  for f in ("eps", "p_codes", "vmax", "vmin")))
    return tc.StackedPayload(*(torch.from_numpy(np.array(t)) for t in (p.re, p.im, p.idx)),
                             q, tuple(p.sizes), p.chunk)


def _compress_both(port_backend, ref_backend, selector, n_bits=8, seed=0, **kw):
    flat = _flat(seed)
    jl, tl = jb.build_layout(N, BUCKET_BYTES), tb.build_layout(N, BUCKET_BYTES)
    assert tl.n_buckets == 3 and not tl.uniform
    jcomp = jc.FFTCompressor(jc.FFTCompressorConfig(backend=ref_backend, selector=selector,
                                                    n_bits=n_bits, **kw))
    tcomp = tc.FFTCompressor(tc.FFTCompressorConfig(backend=port_backend, selector=selector,
                                                    n_bits=n_bits, **kw))
    jp = jcomp.compress_stacked(jb.stack_buckets(jnp.asarray(flat), jl), jl.sizes())
    tp = tcomp.compress_stacked(tb.stack_buckets(torch.from_numpy(flat), tl), tl.sizes())
    return jcomp, tcomp, jp, tp


def _assert_payload_parity(jp, tp):
    assert tp.re.shape == jp.re.shape and tp.idx.dtype == torch.int16
    assert tp.sizes == tuple(jp.sizes) and tp.chunk == jp.chunk
    np.testing.assert_array_equal(np.asarray(jp.idx), tp.idx.numpy())
    np.testing.assert_array_equal(np.asarray(jp.quant.p_codes), tp.quant.p_codes.numpy())
    ulps = np.abs(np.asarray(jp.quant.eps).view(np.int32).astype(np.int64)
                  - tp.quant.eps.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    for a, b in ((jp.re, tp.re), (jp.im, tp.im)):
        diff = np.abs(np.asarray(a).astype(np.int64) - b.numpy().astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005


@pytest.mark.parametrize("port,ref,selector", [
    ("reference", "reference", "sort"),
    ("reference", "reference", "sampled"),
    ("cuda", "pallas", "sampled"),
    ("cuda", "pallas", "bisect"),
    ("auto", "pallas", "auto"),
])
def test_compress_stacked_parity(xla_rfft, port, ref, selector):
    _, _, jp, tp = _compress_both(port, ref, selector)
    _assert_payload_parity(jp, tp)


@pytest.mark.parametrize("port,ref,selector", [
    ("reference", "reference", "sort"),
    ("reference", "reference", "sampled"),
    ("cuda", "pallas", "bisect"),
])
def test_compress_stacked_fixed_range_parity(xla_rfft, port, ref, selector):
    """range_mode="fixed": every bucket takes the one fixed fit, so eps and
    P repeat over the buckets and codes past the range saturate."""
    _, _, jp, tp = _compress_both(port, ref, selector, seed=5, range_mode="fixed",
                                  fixed_range=(-2.0, 2.0))
    _assert_payload_parity(jp, tp)
    eps = tp.quant.eps.reshape(-1)
    assert eps.shape == (3,) and bool((eps == eps[0]).all())


def test_compress_stacked_parity_4bit(xla_rfft):
    _, _, jp, tp = _compress_both("cuda", "pallas", "sampled", n_bits=4, seed=3)
    _assert_payload_parity(jp, tp)


def test_compress_stacked_parity_12bit(xla_rfft):
    """uint16 codes through the fused route (B2's plain version on the CPU)."""
    _, _, jp, tp = _compress_both("cuda", "pallas", "sampled", n_bits=12, seed=4, m_bits=7)
    assert tp.re.dtype == torch.uint16
    _assert_payload_parity(jp, tp)


@pytest.mark.parametrize("port,ref", [("reference", "reference"), ("cuda", "pallas")])
def test_decompress_stacked_parity(port, ref):
    """Both sides decompress the SAME (reference-made) payload."""
    jl = jb.build_layout(N, BUCKET_BYTES)
    jcomp = jc.FFTCompressor(jc.FFTCompressorConfig(backend=ref, selector="sampled"))
    tcomp = tc.FFTCompressor(tc.FFTCompressorConfig(backend=port, selector="sampled"))
    jp = jcomp.compress_stacked(jb.stack_buckets(jnp.asarray(_flat(1)), jl), jl.sizes())
    yj = np.asarray(jcomp.decompress_stacked(jp)).reshape(-1, 4096)
    yt = tcomp.decompress_stacked(_payload_to_torch(jp)).numpy().reshape(-1, 4096)
    assert yt.dtype == np.float32
    err = np.abs(yj - yt).max(axis=-1)
    assert np.all(err <= 2e-6 * np.abs(yj).max(axis=-1) + 1e-30), err
    # padding rows decode to exact zeros on both sides
    assert not np.any(yt[8:])


def test_decompress_spectrum_parity():
    jl = jb.build_layout(N, BUCKET_BYTES)
    jcomp = jc.FFTCompressor(jc.FFTCompressorConfig(selector="sampled"))
    tcomp = tc.FFTCompressor(tc.FFTCompressorConfig(selector="sampled"))
    jp = jcomp.compress_stacked(jb.stack_buckets(jnp.asarray(_flat(2)), jl), jl.sizes())
    tp = _payload_to_torch(jp)
    sj = np.asarray(jcomp.decompress_spectrum(jp))
    st = tcomp.decompress_spectrum(tp).numpy()
    np.testing.assert_array_equal(sj, st)
    # slicing back to per-bucket payloads drops exactly the padding rows
    for jb_, tb_ in zip(jp.bucket_payloads(), tp.bucket_payloads()):
        assert (tb_.orig_len, tb_.chunk) == (jb_.orig_len, jb_.chunk)
        np.testing.assert_array_equal(np.asarray(jb_.re), tb_.re.numpy())
        np.testing.assert_array_equal(np.asarray(jb_.idx), tb_.idx.numpy())
        assert float(jb_.quant.eps) == float(tb_.quant.eps)


def test_engine_eligibility_and_fallbacks():
    from repro.kernels import engine as je
    from repro_torch.kernels import engine as te

    for kw in ({}, {"chunk": 1024}, {"quantize": False}, {"chunk": 512, "quantize": False}):
        jcfg = jc.FFTCompressorConfig(**kw)
        tcfg = tc.FFTCompressorConfig(**kw)
        assert te.kernel_eligibility(tcfg)[0] == je.kernel_eligibility(jcfg)[0]
        assert te.wire_bits(tcfg, 10 ** 6) == je.wire_bits(jcfg, 10 ** 6)
    # on the CPU, auto compresses with the reference backend where the
    # kernels do not fuse; the cuda backend runs them stage by stage (B5
    # decode at chunk 1024) and gives the same payload
    cfg = tc.FFTCompressorConfig(backend="auto", chunk=1024, selector="sampled")
    flat = torch.from_numpy(_flat(4))
    layout = tb.build_layout(N, BUCKET_BYTES, chunk=1024)
    stacked = tb.stack_buckets(flat, layout)
    out = tc.FFTCompressor(cfg).compress_stacked(stacked, layout.sizes())
    assert out.re.shape[-1] == 154
    cuda = tc.FFTCompressor(dataclasses.replace(cfg, backend="cuda"))
    got = cuda.compress_stacked(stacked, layout.sizes())
    for a, b in ((got.re, out.re), (got.im, out.im), (got.idx, out.idx),
                 (got.quant.eps, out.quant.eps), (got.quant.p_codes, out.quant.p_codes)):
        assert torch.equal(a, b)
    y_ref = tc.FFTCompressor(cfg).decompress_stacked(out)
    y = cuda.decompress_stacked(got).reshape(-1, 1024)
    err = (y - y_ref.reshape(-1, 1024)).abs().amax(-1)
    assert bool((err <= 2e-6 * y_ref.reshape(-1, 1024).abs().amax(-1)).all())
