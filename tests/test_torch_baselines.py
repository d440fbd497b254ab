"""Port parity of the paper's comparison compressors: ``core/baselines.py``
(TernGrad, QSGD, DGCTopK, AjiThreshold, OneBitSGD), ``TimeDomainCompressor``,
``QuantOnlyCompressor`` and ``NoCompression`` (``core/compressor.py``), and
the helpers they use (``selection.select_indices``,
``packing.unpack_by_indices``), against the reference on the same seeded
inputs, with deterministic rounding (no generator / no key).

Tolerances:
* codes, indices and ternary/sign patterns: bitwise, except QSGD's codes,
  which may differ only where the bucket norm's last bit (torch and XLA sum
  the squares in different orders) moves a value across a half step: at
  most 1e-4 of the entries;
* scales (max|g|, bucket norms, mean|g|): within 1e-6 relative;
* ``TimeDomainCompressor``: indices bitwise; codes bitwise given the
  reference's fitted quantizer (``fit_quantizer``'s eps can land 2 ulps
  apart, ROADMAP §3); reconstruction within relative L2 1e-3;
* ``wire_bits`` and ``ratio``: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import bucketing as jb
from repro.core import baselines as jbase
from repro.core import compressor as jc
from repro.core import packing as jpack
from repro.core import selection as jsel
from repro.core.quantizer import encode as j_encode
from repro_torch.comms import bucketing as tb
from repro_torch.core import baselines as tbase
from repro_torch.core import compressor as tc
from repro_torch.core import packing as tpack
from repro_torch.core import selection as tsel
from repro_torch.core.quantizer import FittedQuantizer, RangeQuantConfig, encode as t_encode

N = 3 * 4096 + 173


def _grad(seed=0, n=N, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scale_close(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["TernGrad", "OneBitSGD"])
def test_scaled_sign_baselines_match_reference(name):
    g = _grad(1)
    ref, port = getattr(jbase, name)(), getattr(tbase, name)()
    jp = ref.compress(jnp.asarray(g))
    tp = port.compress(torch.from_numpy(g))
    assert tp.codes.dtype == torch.int8 and tp.orig_len == jp.orig_len == N
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
    _scale_close(tp.scale, jp.scale)
    _scale_close(port.decompress(tp), ref.decompress(jp))
    assert port.wire_bits(N) == ref.wire_bits(N)
    assert port.ratio(N) == ref.ratio(N)


@pytest.mark.parametrize("levels,bucket", [(16, 4096), (4, 1024)])
def test_qsgd_matches_reference(levels, bucket):
    g = _grad(2)
    ref, port = jbase.QSGD(levels, bucket), tbase.QSGD(levels, bucket)
    jp = ref.compress(jnp.asarray(g))
    tp = port.compress(torch.from_numpy(g))
    assert tp.codes.shape == jp.codes.shape and tp.orig_len == jp.orig_len
    _scale_close(tp.scale, jp.scale)
    diff = np.count_nonzero(tp.codes.numpy() != np.asarray(jp.codes))
    assert diff <= 1e-4 * jp.codes.size, diff
    got, want = port.decompress(tp).numpy(), np.asarray(ref.decompress(jp))
    assert got.shape == (N,)
    assert _rel(got, want) <= 1e-3
    assert port.wire_bits(N) == ref.wire_bits(N) and port.ratio(N) == ref.ratio(N)
    assert port.bits_per_value == ref.bits_per_value


@pytest.mark.parametrize("name", ["DGCTopK", "AjiThreshold"])
@pytest.mark.parametrize("theta", [0.99, 0.7])
def test_time_domain_topk_baselines_match_reference(name, theta):
    g = _grad(3)
    ref, port = getattr(jbase, name)(theta=theta), getattr(tbase, name)(theta=theta)
    jv, ji, jn = ref.compress(jnp.asarray(g))
    tv, ti, tn = port.compress(torch.from_numpy(g))
    assert tn == jn == N and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(port.decompress((tv, ti, tn)).numpy(),
                                  np.asarray(ref.decompress((jv, ji, jn))))
    assert port.wire_bits(N) == ref.wire_bits(N) and port.ratio(N) == ref.ratio(N)


def test_stochastic_rounding_takes_a_generator():
    """With a generator the stochastic baselines draw their rounding from it:
    the same seed gives the same codes, and the codes stay in range."""
    x = torch.from_numpy(_grad(4))
    for comp in (tbase.TernGrad(), tbase.QSGD()):
        a = comp.compress(x, generator=torch.Generator().manual_seed(7))
        b = comp.compress(x, generator=torch.Generator().manual_seed(7))
        assert torch.equal(a.codes, b.codes)
        top = 1 if isinstance(comp, tbase.TernGrad) else comp.levels
        assert int(a.codes.abs().max()) <= top
        assert not torch.equal(a.codes, comp.compress(x).codes)


@pytest.mark.parametrize("selector", ["sort", "sampled", "bisect"])
def test_select_indices_matches_reference(selector):
    mag = np.abs(np.random.default_rng(5).standard_normal((2, 3, 1025))).astype(np.float32)
    mag += np.float32(1e-3)
    j_idx, j_tau = jsel.select_indices(jnp.asarray(mag), 300, selector)
    t_idx, t_tau = tsel.select_indices(torch.from_numpy(mag), 300, selector)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    if selector == "sort":
        assert j_tau is None and t_tau is None
    else:
        np.testing.assert_array_equal(t_tau.numpy(), np.asarray(j_tau))


def test_unpack_by_indices_matches_reference():
    rng = np.random.default_rng(6)
    vals = rng.standard_normal((4, 50)).astype(np.float32)
    idx = np.stack([rng.permutation(300)[:50] for _ in range(4)]).astype(np.int16)
    np.testing.assert_array_equal(
        tpack.unpack_by_indices(torch.from_numpy(vals), torch.from_numpy(idx), 300).numpy(),
        np.asarray(jpack.unpack_by_indices(jnp.asarray(vals), jnp.asarray(idx), 300)))


def _port_quant(jq):
    """The reference's fit as a port ``FittedQuantizer``."""
    return FittedQuantizer(RangeQuantConfig(jq.config.n_bits, jq.config.m_bits),
                           *(torch.from_numpy(np.array(getattr(jq, f)))
                             for f in ("eps", "p_codes", "vmax", "vmin")))


def _codes_given_reference_fit(t_payload, j_payload, x_rows):
    """The port's kept values (at its own indices) encoded with the
    reference's fit must equal the reference's codes."""
    vals = tpack.pack_by_indices(x_rows, t_payload.idx)
    np.testing.assert_array_equal(t_encode(vals, _port_quant(j_payload.quant)).numpy(),
                                  np.asarray(j_payload.re))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("selector", ["sort", "sampled", "bisect"])
def test_time_domain_compressor_matches_reference(selector, quantize):
    g = _grad(7)
    cfg = dict(theta=0.7, selector=selector, quantize=quantize)
    ref = jc.TimeDomainCompressor(jc.FFTCompressorConfig(**cfg))
    port = tc.TimeDomainCompressor(tc.FFTCompressorConfig(**cfg))
    x = torch.from_numpy(g)

    jp = ref.compress(jnp.asarray(g))
    tp = port.compress(x)
    assert tp.has_im is False and tp.im.shape == (4, 0) and tp.idx.dtype == torch.int16
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    x2d = torch.nn.functional.pad(x, (0, 4 * 4096 - N)).reshape(4, 4096)
    if quantize:
        _codes_given_reference_fit(tp, jp, x2d)
    else:
        np.testing.assert_array_equal(tp.re.numpy(), np.asarray(jp.re))
    got, want = port.decompress(tp).numpy(), np.asarray(ref.decompress(jp))
    assert got.shape == (N,) and _rel(got, want) <= 1e-3

    # stacked: 2 buckets of 2 chunks (the second ragged), one fit per bucket
    layout_t, layout_j = tb.build_layout(N, 2 * 4096 * 4), jb.build_layout(N, 2 * 4096 * 4)
    ts_ = tb.stack_buckets(x, layout_t)
    jsp = ref.compress_stacked(jb.stack_buckets(jnp.asarray(g), layout_j), layout_j.sizes())
    tsp = port.compress_stacked(ts_, layout_t.sizes())
    assert tsp.has_im is False and tsp.im.shape == (2, 2, 0)
    np.testing.assert_array_equal(tsp.idx.numpy(), np.asarray(jsp.idx))
    if quantize:
        _codes_given_reference_fit(tsp, jsp, ts_.reshape(2, 2, 4096))
    else:
        np.testing.assert_array_equal(tsp.re.numpy(), np.asarray(jsp.re))
    got = tb.unstack_buckets(port.decompress_stacked(tsp), layout_t).numpy()
    want = np.asarray(jb.unstack_buckets(ref.decompress_stacked(jsp), layout_j))
    assert _rel(got, want) <= 1e-3
    for n in (N, 1, 10 ** 6):
        assert port.wire_bits(n) == ref.wire_bits(n) and port.ratio(n) == ref.ratio(n)


def test_quant_only_and_no_compression_match_reference():
    g = _grad(8)
    ref, port = jc.QuantOnlyCompressor(), tc.QuantOnlyCompressor()
    j_codes, jq = ref.compress(jnp.asarray(g))
    t_codes, tq = port.compress(torch.from_numpy(g))
    assert t_codes.shape == (N,)
    np.testing.assert_array_equal(t_encode(torch.from_numpy(g), _port_quant(jq)).numpy(),
                                  np.asarray(j_codes))
    assert _rel(port.decompress((t_codes, tq)).numpy(),
                np.asarray(ref.decompress((j_codes, jq)))) <= 1e-3
    assert np.array_equal(np.asarray(j_encode(jnp.asarray(g), jq)), np.asarray(j_codes))
    ident, j_ident = tc.NoCompression(), jc.NoCompression()
    x = torch.from_numpy(g)
    assert ident.decompress(ident.compress(x)) is x
    for comp, jcomp in ((port, ref), (ident, j_ident)):
        assert comp.wire_bits(N) == jcomp.wire_bits(N) and comp.ratio(N) == jcomp.ratio(N)
