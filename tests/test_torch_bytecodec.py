"""Port parity of the payload byte codec (``core/bytecodec.py``).

Exact throughout: for the same planes the port's blob is byte for byte the
reference's; each package reads the other's blobs back to bitwise the same
planes; the header of a payload each package compresses itself from the
same gradient names the same planes, dtypes and shapes; a bad magic, an
unknown version or kind and a truncated blob are refused.
"""

import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import bucketing as jb
from repro.core import bytecodec as jbc
from repro.core import compressor as jc
from repro.core.quantizer import FittedQuantizer as JFQ, RangeQuantConfig as JRQ
from repro_torch.comms import bucketing as tb
from repro_torch.core import bytecodec as tbc
from repro_torch.core import compressor as tc

N = 3 * 4096 + 173
SIZES = (4096, 4096, 4096 + 173)
# (compressor, quantize, stacked)
CASES = [("fft", True, False), ("fft", False, False), ("fft", True, True),
         ("fft", False, True), ("timedomain", True, True), ("timedomain", False, False)]


def _flat():
    return (np.random.default_rng(0).standard_normal(N) * 0.05).astype(np.float32)


def _compressors(kind, quantize):
    cfg = dict(theta=0.7, quantize=quantize)
    if kind == "fft":
        return (tc.FFTCompressor(tc.FFTCompressorConfig(backend="cuda", **cfg)),
                jc.FFTCompressor(jc.FFTCompressorConfig(backend="reference", **cfg)))
    return (tc.TimeDomainCompressor(tc.FFTCompressorConfig(**cfg)),
            jc.TimeDomainCompressor(jc.FFTCompressorConfig(**cfg)))


def _compress(comp, flat, stacked, stack):
    return comp.compress_stacked(stack(flat), SIZES) if stacked else comp.compress(flat)


def _port_payload(kind, quantize, stacked):
    comp, _ = _compressors(kind, quantize)
    layout = tb.build_layout(N, 4096 * 4)
    assert layout.sizes() == SIZES
    return _compress(comp, torch.from_numpy(_flat()), stacked,
                     lambda x: tb.stack_buckets(x, layout))


def _as_reference(p):
    """The reference payload holding the port payload's planes."""
    def j(t):
        return jnp.asarray(t.numpy())

    quant = None if p.quant is None else JFQ(JRQ(p.quant.config.n_bits, p.quant.config.m_bits),
                                            j(p.quant.eps), j(p.quant.p_codes),
                                            j(p.quant.vmax), j(p.quant.vmin))
    if isinstance(p, tc.StackedPayload):
        return jc.StackedPayload(j(p.re), j(p.im), j(p.idx), quant, p.sizes, p.chunk,
                                 has_im=p.has_im)
    return jc.FFTPayload(j(p.re), j(p.im), j(p.idx), quant, p.orig_len, p.chunk,
                         has_im=p.has_im)


def _planes(p):
    out = [np.asarray(p.re), np.asarray(p.im), np.asarray(p.idx)]
    if p.quant is not None:
        out += [np.asarray(getattr(p.quant, leaf)) for leaf in ("eps", "p_codes", "vmax", "vmin")]
    return out


def _header(blob):
    (n,) = struct.unpack("<I", blob[4:8])
    return json.loads(blob[8:8 + n])


@pytest.mark.parametrize("kind,quantize,stacked", CASES)
def test_blob_byte_equal_to_reference(kind, quantize, stacked):
    port = _port_payload(kind, quantize, stacked)
    blob = port.to_bytes()
    assert blob == jbc.to_bytes(_as_reference(port))
    # a payload the reference compresses itself names the same planes
    _, jcomp = _compressors(kind, quantize)
    jlayout = jb.build_layout(N, 4096 * 4)
    ref = _compress(jcomp, jnp.asarray(_flat()), stacked, lambda x: jb.stack_buckets(x, jlayout))
    assert _header(blob) == _header(jbc.to_bytes(ref))


@pytest.mark.parametrize("kind,quantize,stacked", CASES)
def test_each_package_reads_the_others_blobs(kind, quantize, stacked):
    port = _port_payload(kind, quantize, stacked)
    cls = tc.StackedPayload if stacked else tc.FFTPayload
    back = jbc.from_bytes(port.to_bytes())
    assert type(back).__name__ == cls.__name__
    for a, b in zip(_planes(port), _planes(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = cls.from_bytes(jbc.to_bytes(back), "cpu")
    assert isinstance(again, cls) and again.has_im == port.has_im and again.chunk == port.chunk
    assert (again.sizes == port.sizes) if stacked else (again.orig_len == port.orig_len)
    for a, b in zip(_planes(port), _planes(again)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    other = tc.FFTPayload if stacked else tc.StackedPayload
    with pytest.raises(ValueError, match="not a"):
        other.from_bytes(port.to_bytes(), "cpu")


def test_bad_blobs_are_refused():
    blob = _port_payload("fft", True, True).to_bytes()
    with pytest.raises(ValueError, match="magic"):
        tbc.from_bytes(b"XPAY" + blob[4:], "cpu")
    header = _header(blob)
    for key, value, match in (("format_version", 2, "version"), ("kind", "dense", "kind")):
        bad = json.dumps(dict(header, **{key: value}), sort_keys=True).encode()
        with pytest.raises(ValueError, match=match):
            tbc.from_bytes(blob[:4] + struct.pack("<I", len(bad)) + bad
                           + blob[8 + len(_header_bytes(blob)):], "cpu")
    with pytest.raises(ValueError, match="truncated"):
        tbc.from_bytes(blob[:-1], "cpu")
    with pytest.raises(ValueError, match="truncated"):
        tbc.from_bytes(blob[:12], "cpu")
    with pytest.raises(TypeError):
        tbc.to_bytes(object())


def _header_bytes(blob):
    (n,) = struct.unpack("<I", blob[4:8])
    return blob[8:8 + n]
