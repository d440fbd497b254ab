"""The per-value arithmetic of kernel B5 (``csrc/range_quant.cu``),
transcribed into numpy and walked on the CPU, where no CUDA kernel runs,
against the plain PyTorch version that the kernel's wrapper runs on a CPU
tensor and that the kernel is held to on the card.

B5a's shortcut, for a = |x| > eps on a row it serves (eps a normal float
>= 2^-100, P and n_neg integers, every code <= the code type's maximum):

* g = lg2(a) - (log2_eps - 1e-6), with lg2 any value within 2^-20 of
  log2(a) (the card's ``lg2.approx``; walked here as float64 log2 rounded
  to float32, and that moved 2^-20 down and up); q = floor(g), from
  rint(g) (the low bits of g + 1.5 * 2^23) and the sign of g - rint(g);
* accepted where g lies more than 2^-12 from an integer;
* t = (a * rcp[q]) * m_scale - m_scale (one rounding: an FMA), with
  rcp[q] = 1 / (eps * exp2(q)) in float32 for q < 32 (a per-row table)
  and NaN for any other q (so the check on t fails there); r = rint(t);
  accepted where |t - r| < 0.5 - m_scale * 2^-18;
* then the carry, idx = q * m_scale + r, the rounding below eps (a < eps/2:
  -1, else 0, a == eps: 0) and the clamps, as integers.

Where every check passes, the code must be the plain version's; elsewhere
(NaN included, which the kernel then gives code 0) the kernel runs the
plain version's arithmetic (encode_value).  The walk takes a strided
sample of 2^20 float32 bit patterns and every pattern within 4 ulps of
+-eps, +-eps/2, each segment bound +-eps * 2^q and each rounding edge of
t.  B5b's 8-bit table (decode_math of every code, per row) and the packing
of codes into words are walked too.

``csrc/range_quant.cu`` names this file: they change together.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.quantizer import LN2, RangeQuantConfig, fit_quantizer
from repro_torch.kernels import _checks
from repro_torch.kernels import range_quant as trq

SEGS = 32
Q_MARGIN = np.float32(2.0 ** -12)
R_MARGIN = np.float32(2.0 ** -18)
ROUND = np.float32(12582912.0)  # 1.5 * 2^23
MIN_FAST_EPS = np.float32(2.0 ** -100)
LG2_ERR = 2.0 ** -20
F32 = np.float32


def row_tables(eps, p, n_neg, n_bits):
    """The kernel's per-row constants: (usable, log2_eps - 1e-6, rcp[33]),
    with the plain version's log2 and exp2 (torch on the CPU)."""
    code_max = F32((1 << 16) - 1 if n_bits > 8 else 255)
    usable = bool(MIN_FAST_EPS <= eps <= np.finfo(F32).max and p == np.rint(p)
                  and n_neg == np.rint(n_neg) and p >= 0
                  and F32(p + max(n_neg, F32(1))) <= code_max)
    log2_eps = (torch.log(torch.tensor(eps)) / LN2).numpy()
    q = torch.arange(SEGS, dtype=torch.float32)
    seg = (torch.tensor(eps) * torch.exp(q * LN2)).numpy()
    ok = usable & (seg >= np.finfo(F32).tiny) & (seg <= F32(2.0 ** 125))
    with np.errstate(divide="ignore"):
        rcp = np.where(ok, F32(1.0) / seg, F32(np.nan)).astype(F32)
    return usable, F32(log2_eps - F32(1e-6)), np.append(rcp, F32(np.nan))


def shortcut(x, eps, p, n_neg, n_bits, m_bits, lg2_err):
    """(code, accepted) of the kernel's shortcut on a row of x."""
    usable, log2_eps_1e6, rcp = row_tables(eps, p, n_neg, n_bits)
    m = F32(1 << m_bits)
    r_limit = F32(F32(0.5) - m * R_MARGIN)
    with np.errstate(all="ignore"):
        a = np.abs(x)
        lg2 = (np.log2(a.astype(np.float64)) + lg2_err).astype(F32)
        g = lg2 - log2_eps_1e6
        g_round = g + ROUND
        n = g_round - ROUND
        d = g - n
        up = d > 0
        q = np.where(up, n, n - F32(1))
        slot = (g_round.view(np.int32) - ROUND.view(np.int32) - np.where(up, 0, 1))
        slot = np.minimum(slot.astype(np.uint32), np.uint32(SEGS))
        y = a * rcp[slot]
        t = (y.astype(np.float64) * m - m).astype(F32)  # one rounding
        r = (t + ROUND) - ROUND
        carry = r >= m
        idx = q * m + np.where(carry, m, r)
        ok = (np.abs(d) > Q_MARGIN) & (np.abs(t - r) < r_limit)
        below = a <= (eps if usable else F32(-1))
        idx = np.where(below, np.where(a < eps * F32(0.5), F32(-1), F32(0)), idx)
        ok |= below
        code_pos = np.minimum(np.maximum(idx, F32(-1)), p - F32(1)) + F32(1)
        idx_neg = np.minimum(np.maximum(idx, F32(-1)), max(n_neg, F32(1)) - F32(1))
        code_neg = np.where(idx_neg < 0, F32(0), (p + F32(1)) + idx_neg)
        code = np.where(ok, np.where(x >= 0, code_pos, code_neg), F32(-1))
    return code, ok


def walk_inputs(eps, m_bits):
    """A strided sample of 2^20 float32 bit patterns, then every pattern
    within 4 ulps of +-eps, +-eps/2, +-eps * 2^q and each rounding edge
    +-eps * 2^q * (1 + (j + 0.5) / m_scale) of the segments the table has;
    and how many of those there are."""
    bits = (np.arange(1 << 20, dtype=np.uint64) * 4096 + 1237).astype(np.uint32)
    m = 1 << m_bits
    edges = (2.0 ** np.arange(SEGS + 1)[:, None] * (1 + (np.arange(m) + 0.5) / m)).ravel()
    centers = float(eps) * np.concatenate([2.0 ** np.arange(-1, 132), edges])
    centers = centers[centers <= np.finfo(F32).max].astype(F32).view(np.uint32)
    near = (centers[:, None].astype(np.int64) + np.arange(-4, 5)).astype(np.uint32).reshape(-1)
    near = np.concatenate([near, near | np.uint32(0x80000000)])
    return np.concatenate([bits, near]).view(F32), len(near)


FITS = [(8, 3, -1.0, 1.0), (8, 3, -2e-4, 3e-3), (4, 2, -0.5, 2.0), (12, 4, -1.0, 1.0)]


@pytest.mark.parametrize("lg2_err", [-LG2_ERR, 0.0, LG2_ERR])
@pytest.mark.parametrize("n_bits,m_bits,lo,hi", FITS)
def test_b5a_shortcut_codes_are_the_plain_versions(n_bits, m_bits, lo, hi, lg2_err):
    q = fit_quantizer(lo, hi, RangeQuantConfig(n_bits, m_bits))
    eps, p, n_neg = (v.numpy()[0] for v in _checks.encode_row_params(
        q.eps, q.p_codes, n_bits, 1, "cpu"))
    x, n_near = walk_inputs(eps, m_bits)
    want = trq.encode_plain(torch.from_numpy(x)[None], q.eps, q.p_codes, n_bits=n_bits,
                            m_bits=m_bits)[0].numpy().astype(np.int64)
    code, ok = shortcut(x, eps, p, n_neg, n_bits, m_bits, lg2_err)
    bad = ok & (code.astype(np.int64) != want)
    assert not bad.any(), (x[bad][:8], code[bad][:8], want[bad][:8])
    assert not ok[np.isnan(x)].any() and not want[np.isnan(x)].any()  # NaN: exact path, code 0
    # the shortcut serves values above eps, and its margins decline some of
    # those next to the segment bounds
    assert (ok & (np.abs(x) > eps)).any()
    assert not ok[-n_near:].all()


@pytest.mark.parametrize("n_bits,m_bits,lo,hi", FITS[:3])
def test_b5a_shortcut_serves_almost_every_gradient_value(n_bits, m_bits, lo, hi):
    """On N(0, 1e-6) values in the fitted range the shortcut declines about
    1 in 1,400 at 8/3 bits (within 2^-12 of a segment bound in log2, or of
    a rounding edge): the kernel's exact path stays rare."""
    x = (np.random.default_rng(n_bits).standard_normal(1 << 18) * 1e-3).astype(F32)
    q = fit_quantizer(float(x.min()), float(x.max()), RangeQuantConfig(n_bits, m_bits))
    eps, p, n_neg = (v.numpy()[0] for v in _checks.encode_row_params(
        q.eps, q.p_codes, n_bits, 1, "cpu"))
    code, ok = shortcut(x, eps, p, n_neg, n_bits, m_bits, 0.0)
    want = trq.encode_plain(torch.from_numpy(x)[None], q.eps, q.p_codes, n_bits=n_bits,
                            m_bits=m_bits)[0].numpy()
    assert np.array_equal(code[ok].astype(np.int64), want[ok].astype(np.int64))
    assert 1.0 - ok.mean() < 2e-3


def test_b5a_rows_the_shortcut_cannot_serve_take_the_exact_path():
    """eps below 2^-100, not finite, a fractional P or n_neg, or codes past
    the code type: no value takes the shortcut but those at or below eps on
    a served row, so the kernel's encode_value (and its NaN rule) decides."""
    x, _ = walk_inputs(F32(1e-3), 3)
    for eps, p, n_neg in [(F32(1e-31), F32(128), F32(127)), (F32(np.inf), F32(128), F32(127)),
                          (F32(1e-3), F32(127.5), F32(127.5)), (F32(1e-3), F32(255), F32(0)),
                          (F32(0), F32(128), F32(127))]:
        _, ok = shortcut(x, eps, p, n_neg, 8, 3, 0.0)
        assert not ok.any()


def test_b5a_nan_is_code_zero_in_the_plain_version():
    """The kernel maps NaN to code 0 before the shortcut; the plain version
    and the reference give NaN code 0 as well (tests/test_torch_ops.py)."""
    q = fit_quantizer(-1.0, 1.0, RangeQuantConfig(8, 3))
    x = torch.tensor([[float("nan"), -float("nan")]])
    assert not trq.encode_plain(x, q.eps, q.p_codes).any()


def byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes of (y << 32 | x)."""
    b = np.array([(int(x) >> (8 * i)) & 255 for i in range(4)]
                 + [(int(y) >> (8 * i)) & 255 for i in range(4)])
    return sum(int(b[(sel >> (4 * i)) & 7]) << (8 * i) for i in range(4))


@pytest.mark.parametrize("code_bytes", [1, 2])
def test_b5_code_words_hold_codes_in_column_order(code_bytes):
    """The encode's 16-byte store (CodeVec) and the decode's unpacking of a
    16-byte load give the codes in column order on the little-endian card."""
    rng = np.random.default_rng(code_bytes)
    codes = rng.integers(0, 256 ** code_bytes, 16)
    if code_bytes == 1:
        words = [byte_perm(byte_perm(codes[4 * i], codes[4 * i + 1], 0x0040),
                           byte_perm(codes[4 * i + 2], codes[4 * i + 3], 0x0040), 0x5410)
                 for i in range(4)]
    else:
        words = [byte_perm(codes[2 * i], codes[2 * i + 1], 0x5410) for i in range(8)]
    stored = np.array(words, np.uint32).view(np.uint8 if code_bytes == 1 else np.uint16)
    assert np.array_equal(stored, codes)
    per_word, bits = 4 // code_bytes, 8 * code_bytes
    unpacked = [(words[v // per_word] >> (bits * (v % per_word))) & ((1 << bits) - 1)
                for v in range(16)]
    assert np.array_equal(unpacked, codes)


def test_b5b_table_lookup_is_the_plain_decode():
    """B5b's 8-bit path: per row a table of decode_math over codes 0..255,
    indexed by the code -- the plain version's values, row by row."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((3, 640)) * 1e-3).astype(F32))
    q = fit_quantizer(x.amin(-1), x.amax(-1), RangeQuantConfig(8, 3))
    codes = trq.encode_plain(x, q.eps, q.p_codes)
    table = trq.decode_plain(torch.arange(256, dtype=torch.uint8)[None].expand(3, 256).contiguous(),
                             q.eps, q.p_codes)
    got = torch.gather(table, 1, codes.long())
    want = trq.decode_plain(codes, q.eps, q.p_codes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
