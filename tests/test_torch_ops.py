"""Port parity of the second slice's kernels and of the paths that run them:
B5 range-quant encode/decode, B6 pack/unpack and B7 fft4096 (each plain
PyTorch version, what a wrapper runs on a CPU tensor) against the
reference's Pallas kernels in interpret mode; the kernel-composed pipeline
``ops.compress_chunks``/``decompress_chunks`` against the reference's
``ops``; and the monolithic ``FFTCompressor.compress``/``decompress`` on the
port's ``reference`` and ``cuda`` backends against the reference's
``reference`` and ``pallas`` backends.

Tolerances:
* B5, B6: bitwise -- the same float32 expressions on the same inputs, and a
  copy or an exact scatter (rows whose count exceeds k and all-zero rows
  included);
* B7: max abs error <= 2e-6 * max|X| per row and plane -- two fp32 four-step
  FFTs whose 64-term matmuls sum in different orders (measured ~4e-7);
* the ops pipeline against the reference's: the spectra differ at fp32
  round-off, so a code may move by one step on at most 0.5% of slots and
  the kept set may differ on at most one chunk in eight; reconstructions
  within 1e-5 (the reference's own pipeline tolerance,
  ``tests/test_kernels.py``) on every chunk whose codes agree;
* monolithic payloads, given the same spectrum (``torch.fft.rfft`` patched
  to XLA's rfft, as in test_torch_engine.py): indices, P and unquantized
  values bitwise, eps within two ulps, codes within one step on <= 0.5% of
  slots; reconstructions of one payload: max abs error <= 2e-6 * max|x|
  per chunk row; end to end (each package's own FFT): relative L2 error
  <= 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jc
from repro.core.quantizer import RangeQuantConfig as JRQ, fit_quantizer as jfit
from repro.kernels import fft4step as jfft4, ops as jops, pack as jpack, range_quant as jrq
from repro_torch.core import compressor as tc
from repro_torch.core.quantizer import (FittedQuantizer as TFQ, RangeQuantConfig as TRQ,
                                        fit_quantizer as tfit)
from repro_torch.kernels import fft4step as tfft4, ops as tops, pack as tpack
from repro_torch.kernels import range_quant as trq


def _np(t):
    return np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rows,cols,n_bits,m_bits,per_row", [
    (4, 640, 8, 3, True), (3, 2049, 8, 3, False), (5, 256, 4, 2, True), (2, 130, 12, 7, False)])
def test_range_quant_plain_vs_pallas_bitwise(rows, cols, n_bits, m_bits, per_row):
    rng = np.random.default_rng(cols)
    x = (rng.standard_normal((rows, cols)) * rng.uniform(0.1, 2.0, (rows, 1))).astype(np.float32)
    x[0, :5] = [0.0, 1e-9, -1e-9, 50.0, -50.0]  # zero, below eps, beyond the range
    if per_row:
        fits = [jfit(float(r.min()) * 0.8, float(r.max()) * 0.8, JRQ(n_bits, m_bits)) for r in x]
        eps = np.array([np.float32(f.eps) for f in fits], np.float32)
        p = np.array([np.int32(f.p_codes) for f in fits], np.int32)
    else:
        f = jfit(-1.5, 2.0, JRQ(n_bits, m_bits))
        eps, p = np.float32(f.eps), np.int32(f.p_codes)
    jcodes = jrq.encode_pallas(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(p), n_bits=n_bits,
                               m_bits=m_bits, interpret=True)
    tcodes = trq.encode(_t(x), _t(np.asarray(eps)), _t(np.asarray(p)), n_bits=n_bits,
                        m_bits=m_bits)
    assert tcodes.dtype == (torch.uint8 if n_bits <= 8 else torch.uint16)
    np.testing.assert_array_equal(_np(jcodes).astype(np.int32), tcodes.numpy().astype(np.int32))
    jy = jrq.decode_pallas(jcodes, jnp.asarray(eps), jnp.asarray(p), n_bits=n_bits,
                           m_bits=m_bits, interpret=True)
    ty = trq.decode(tcodes, _t(np.asarray(eps)), _t(np.asarray(p)), n_bits=n_bits,
                    m_bits=m_bits)
    assert ty.dtype == torch.float32
    np.testing.assert_array_equal(_np(jy), ty.numpy())


def range_quant_edge_values(eps, n_bits, m_bits):
    """The values B5a must get right besides plain ones, at one fit's eps:
    NaN, -NaN, +-inf, +-0, a denormal, +-1e30, and +-eps, +-eps/2 and every
    finite segment bound +-eps * 2**q up to two segments past the codes."""
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e30, -1e30],
                    np.float32)
    bounds = float(eps) * 2.0 ** np.arange(-1, (1 << (n_bits - m_bits)) + 2)
    bounds = bounds[bounds <= np.finfo(np.float32).max].astype(np.float32)
    return np.concatenate([vals, bounds, -bounds])


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("n_bits,m_bits", [(8, 3), (4, 2), (12, 4)])
def test_range_quant_plain_vs_pallas_edge_values(n_bits, m_bits, per_row):
    """NaN and -NaN encode to code 0, as do +-inf, +-0 and denormals; +-1e30
    clamp to the end codes; eps, eps/2 and the segment bounds land where the
    reference puts them: codes bitwise, scalar and per-row fits, uint8 and
    (12 bits) uint16 codes.  Decoded values bitwise at 8 and 4 bits; at 12
    bits within 2 ulps, since XLA's and torch's CPU exp differ by up to 2
    ulps from 2**32 on (codes 513 and up at 12/4; ROADMAP, faults 2)."""
    fits = [jfit(-1.0, 1.0, JRQ(n_bits, m_bits)), jfit(-0.02, 3.0, JRQ(n_bits, m_bits))]
    rows = [range_quant_edge_values(np.float32(f.eps), n_bits, m_bits) for f in fits]
    cols = max(len(r) for r in rows)
    x = np.stack([np.pad(r, (0, cols - len(r))) for r in rows])
    if per_row:
        eps = np.array([np.float32(f.eps) for f in fits], np.float32)
        p = np.array([np.int32(f.p_codes) for f in fits], np.int32)
    else:
        x = x[:1]
        eps, p = np.float32(fits[0].eps), np.int32(fits[0].p_codes)
    jcodes = jrq.encode_pallas(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(p), n_bits=n_bits,
                               m_bits=m_bits, interpret=True)
    tcodes = trq.encode(_t(x), _t(np.asarray(eps)), _t(np.asarray(p)), n_bits=n_bits,
                        m_bits=m_bits)
    np.testing.assert_array_equal(_np(jcodes).astype(np.int32), tcodes.numpy().astype(np.int32))
    assert not tcodes[:, :2].numpy().any()  # NaN and -NaN: code 0
    jy = jrq.decode_pallas(jcodes, jnp.asarray(eps), jnp.asarray(p), n_bits=n_bits,
                           m_bits=m_bits, interpret=True)
    ty = trq.decode(tcodes, _t(np.asarray(eps)), _t(np.asarray(p)), n_bits=n_bits,
                    m_bits=m_bits)
    if n_bits <= 8:
        np.testing.assert_array_equal(_np(jy).view(np.int32), ty.numpy().view(np.int32))
    else:
        np.testing.assert_array_max_ulp(_np(jy), ty.numpy(), maxulp=2)


@pytest.mark.parametrize("rows,cols,k", [(4, 2049, 615), (3, 1024, 100), (4, 300, 128)])
def test_pack_unpack_plain_vs_pallas_bitwise(rows, cols, k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    tau = np.sort(np.abs(x), axis=-1)[:, -k][:, None].astype(np.float32)
    x[1] = 0.0  # an all-zero row: tau 0 keeps every column, cut at k
    tau[1] = 0.0
    tau[2] = np.float32(np.sort(np.abs(x[2]))[cols // 8])  # a count beyond k
    k_pad = tops.pad_k(k)
    jv, ji = jpack.pack_pallas(jnp.asarray(x), jnp.asarray(tau), k=k_pad, interpret=True)
    tv, ti = tpack.pack(_t(x), _t(tau), k=k_pad)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(_np(jv), tv.numpy())
    np.testing.assert_array_equal(_np(ji), ti.numpy())
    assert int((ti[2] != 0).sum()) >= k_pad - 1  # the surplus was cut at k_pad
    cols_pad = cols + (-cols) % tpack.F_TILE
    jd = jpack.unpack_pallas(jv, ji, cols=cols_pad, interpret=True)
    td = tpack.unpack(tv, ti, cols=cols_pad)
    np.testing.assert_array_equal(_np(jd), td.numpy())
    with pytest.raises(ValueError, match="multiple of 128"):
        tpack.pack(_t(x), _t(tau), k=k_pad + 1)
    with pytest.raises(ValueError, match="multiple of 512"):
        tpack.unpack(tv, ti, cols=cols_pad + 1)


@pytest.mark.parametrize("inverse", [False, True])
def test_fft4096_plain_vs_pallas(inverse):
    rng = np.random.default_rng(int(inverse))
    xr = rng.standard_normal((3, 4096)).astype(np.float32)
    xi = (rng.standard_normal((3, 4096)) * 1e-3).astype(np.float32)
    jr, ji = jfft4.fft4096_pallas(jnp.asarray(xr), jnp.asarray(xi), inverse=inverse,
                                  interpret=True)
    tr, ti = tfft4.fft4096(_t(xr), _t(xi), inverse=inverse)
    jr, ji = _np(jr), _np(ji)
    scale = np.maximum(np.abs(jr).max(-1), np.abs(ji).max(-1))
    for a, b in ((jr, tr.numpy()), (ji, ti.numpy())):
        assert np.all(np.abs(a - b).max(-1) <= 2e-6 * scale)


def _chunks(rows, seed):
    return (np.random.default_rng(seed).standard_normal((rows, 4096)) * 0.05).astype(np.float32)


def test_ops_pipeline_matches_reference_ops():
    x = _chunks(8, 3)
    jq = jfit(-3.0, 3.0, JRQ(8, 3))
    tq = tfit(-3.0, 3.0, TRQ(8, 3))
    np.testing.assert_array_equal(_np(jq.eps), tq.eps.numpy())
    jre, jim, jidx, jtau = jops.compress_chunks(jnp.asarray(x), 615, jq)
    tre, tim, tidx, ttau = tops.compress_chunks(_t(x), 615, tq)
    assert tre.shape == (8, 640) and tre.dtype == torch.uint8 and tidx.dtype == torch.int32
    np.testing.assert_allclose(ttau.numpy(), _np(jtau), rtol=1e-5)
    same_set = np.all(_np(jidx) == tidx.numpy(), axis=-1)
    assert same_set.mean() >= 7 / 8
    for a, b in ((jre, tre), (jim, tim)):
        diff = np.abs(_np(a).astype(np.int32) - b.numpy().astype(np.int32))[same_set]
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    n = x.size - 77
    jy = _np(jops.decompress_chunks(jre, jim, jidx, jq, n))
    ty = tops.decompress_chunks(tre, tim, tidx, tq, n).numpy()
    assert ty.shape == (n,) and ty.dtype == np.float32
    # the same payload through both decompress pipelines: the FFTs' tolerance
    ty_same = tops.decompress_chunks(_t(_np(jre)), _t(_np(jim)), _t(_np(jidx)), tq, n).numpy()
    np.testing.assert_allclose(ty_same, jy, atol=2e-6 * np.abs(jy).max())
    agree = same_set & np.all(_np(jre) == tre.numpy(), -1) & np.all(_np(jim) == tim.numpy(), -1)
    err = np.abs(np.pad(jy - ty, (0, 77))).reshape(8, 4096).max(-1)
    assert np.all(err[agree] <= 1e-5)


def test_ops_pipeline_matches_fixed_range_compressor():
    """As the reference's own check (tests/test_kernels.py): the kernel
    pipeline against FFTCompressor with the same fixed quantizer range."""
    g = _chunks(8, 5).reshape(-1)
    q = tfit(-3.0, 3.0, TRQ(8, 3))
    re_c, im_c, idx, _ = tops.compress_chunks(_t(g).reshape(8, 4096), 615, q)
    g_ops = tops.decompress_chunks(re_c, im_c, idx, q, g.size)
    comp = tc.FFTCompressor(tc.FFTCompressorConfig(theta=0.7, range_mode="fixed",
                                                   fixed_range=(-3.0, 3.0)))
    g_comp = comp.decompress(comp.compress(_t(g)))
    np.testing.assert_allclose(g_ops.numpy(), g_comp.numpy(), atol=1e-5)


# -- the monolithic entry points --------------------------------------------

N = 5 * 4096 + 321


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


MONO_CASES = [
    ("reference", "reference", dict(selector="sort")),
    ("reference", "reference", dict(selector="sort", range_mode="fixed", fixed_range=(-2., 2.))),
    ("reference", "reference", dict(selector="bisect", quantize=False)),
    ("reference", "reference", dict(selector="bisect", chunk=1024)),
    ("cuda", "pallas", dict(selector="sampled")),
    ("cuda", "pallas", dict(selector="bisect", range_mode="fixed", fixed_range=(-2., 2.))),
    ("cuda", "pallas", dict(selector="sampled", quantize=False)),
    ("cuda", "pallas", dict(selector="sampled", chunk=1024)),
    ("auto", "pallas", dict(selector="auto")),
]


def _comps(port, ref, kw):
    return (jc.FFTCompressor(jc.FFTCompressorConfig(backend=ref, **kw)),
            tc.FFTCompressor(tc.FFTCompressorConfig(backend=port, **kw)))


def _to_torch(p):
    q = None
    if p.quant is not None:
        q = TFQ(TRQ(p.quant.config.n_bits, p.quant.config.m_bits),
                *(_t(np.array(getattr(p.quant, f))) for f in ("eps", "p_codes", "vmax", "vmin")))
    return tc.FFTPayload(*(_t(np.array(t)) for t in (p.re, p.im, p.idx)), q, p.orig_len,
                         p.chunk)


@pytest.mark.parametrize("port,ref,kw", MONO_CASES)
def test_monolithic_compress_parity(xla_rfft, port, ref, kw):
    jcomp, tcomp = _comps(port, ref, kw)
    x = _flat(7)
    jp = jcomp.compress(jnp.asarray(x))
    tp = tcomp.compress(_t(x))
    assert (tp.orig_len, tp.chunk) == (jp.orig_len, jp.chunk) and tp.idx.dtype == torch.int16
    assert tp.re.shape == jp.re.shape
    np.testing.assert_array_equal(_np(jp.idx), tp.idx.numpy())
    if jp.quant is None:
        assert tp.quant is None and tp.re.dtype == torch.float32
        np.testing.assert_array_equal(_np(jp.re), tp.re.numpy())
        np.testing.assert_array_equal(_np(jp.im), tp.im.numpy())
        return
    assert int(tp.quant.p_codes) == int(jp.quant.p_codes)
    ulps = abs(int(np.float32(jp.quant.eps).view(np.int32))
               - int(tp.quant.eps.numpy().view(np.int32)))
    assert ulps <= 2
    for a, b in ((jp.re, tp.re), (jp.im, tp.im)):
        diff = np.abs(_np(a).astype(np.int64) - b.numpy().astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    assert tcomp.wire_bits(N) == jcomp.wire_bits(N)


@pytest.mark.parametrize("port,ref,kw", MONO_CASES)
def test_monolithic_decompress_parity(port, ref, kw):
    """Both sides decompress the SAME (reference-made) payload, then each
    package runs its own compress -> decompress end to end."""
    jcomp, tcomp = _comps(port, ref, kw)
    x = _flat(8)
    jp = jcomp.compress(jnp.asarray(x))
    yj = _np(jcomp.decompress(jp))
    yt = tcomp.decompress(_to_torch(jp)).numpy()
    assert yt.shape == (N,) and yt.dtype == np.float32
    chunk = kw.get("chunk", 4096)
    pad = (-N) % chunk
    rows_j = np.pad(yj, (0, pad)).reshape(-1, chunk)
    err = np.abs(rows_j - np.pad(yt, (0, pad)).reshape(-1, chunk)).max(-1)
    assert np.all(err <= 2e-6 * np.abs(rows_j).max(-1)), err
    end_to_end = tcomp.decompress(tcomp.compress(_t(x))).numpy()
    assert np.linalg.norm(end_to_end - yj) <= 1e-3 * np.linalg.norm(yj)
