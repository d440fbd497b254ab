"""Port parity: ``repro_torch.core.quantizer`` and the float-carried
``kernels.range_quant`` math against the reference.

Tolerances:
* ``encode`` / ``decode`` / ``encode_math`` / ``decode_math``: bitwise,
  given the same fitted parameters.
* ``fit_quantizer``: P bitwise; eps within two float32 ulps.  The port
  spells exp2 as the reference lowers it (exp(ln2 * x)), but XLA's CPU exp
  and torch's differ by one ulp on some inputs (ROADMAP queue 3), and the
  division ``vmax / exp2(...)`` can round that to two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro.kernels import range_quant as jrq
from repro_torch.core import quantizer as tq
from repro_torch.kernels import range_quant as trq

CONFIGS = [(8, 3), (4, 2), (6, 3), (12, 3)]


def _ranges(n, seed):
    rng = np.random.default_rng(seed)
    return [(-float(np.exp(rng.uniform(-8, 2))), float(np.exp(rng.uniform(-8, 2))))
            for _ in range(n)]


@pytest.mark.parametrize("n_bits,m_bits", CONFIGS)
def test_fit_quantizer_parity(n_bits, m_bits):
    jc, tc = jq.RangeQuantConfig(n_bits, m_bits), tq.RangeQuantConfig(n_bits, m_bits)
    lo, hi = map(np.float32, zip(*_ranges(64, n_bits)))
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    jfit = jq.fit_quantizer(jnp.asarray(lo), jnp.asarray(hi), jc)
    tfit = tq.fit_quantizer(torch.from_numpy(lo), torch.from_numpy(hi), tc)
    np.testing.assert_array_equal(np.asarray(jfit.p_codes), tfit.p_codes.numpy())
    ulps = np.abs(np.asarray(jfit.eps).view(np.int32).astype(np.int64)
                  - tfit.eps.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


@pytest.mark.parametrize("n_bits,m_bits", CONFIGS)
def test_encode_decode_bitwise(n_bits, m_bits):
    jc, tc = jq.RangeQuantConfig(n_bits, m_bits), tq.RangeQuantConfig(n_bits, m_bits)
    rng = np.random.default_rng(n_bits * 10 + m_bits)
    for lo, hi in _ranges(8, n_bits + 100):
        jfit = jq.fit_quantizer(lo, hi, jc)
        tfit = tq.FittedQuantizer(tc, torch.tensor(np.float32(jfit.eps)),
                                  torch.tensor(np.int32(jfit.p_codes)), None, None)
        x = (rng.standard_normal(4096) * max(hi, -lo) / 2).astype(np.float32)
        jcodes = np.asarray(jq.encode(jnp.asarray(x), jfit))
        tcodes = tq.encode(torch.from_numpy(x), tfit)
        assert tcodes.dtype == (torch.uint8 if n_bits <= 8 else torch.uint16)
        np.testing.assert_array_equal(jcodes.astype(np.int64), tcodes.numpy().astype(np.int64))
        jdec = np.asarray(jq.decode(jnp.asarray(jcodes), jfit))
        tdec = tq.decode(torch.from_numpy(jcodes.astype(np.int64)), tfit)
        np.testing.assert_array_equal(jdec, tdec.numpy())


@pytest.mark.parametrize("n_bits,m_bits", [(8, 3), (4, 2)])
def test_range_quant_math_bitwise_per_row(n_bits, m_bits):
    rng = np.random.default_rng(5)
    rows = 6
    fits = [jq.fit_quantizer(lo, hi, jq.RangeQuantConfig(n_bits, m_bits))
            for lo, hi in _ranges(rows, 9)]
    eps = np.array([np.float32(f.eps) for f in fits], np.float32)[:, None]
    p = np.array([float(f.p_codes) for f in fits], np.float32)[:, None]
    n_neg = np.float32((1 << n_bits) - 1) - p
    x = (rng.standard_normal((rows, 700)) * 0.3).astype(np.float32)
    m = float(1 << m_bits)
    jc = np.asarray(jrq.encode_math(jnp.asarray(x), eps, p, n_neg, m))
    tc = trq.encode_math(torch.from_numpy(x), *map(torch.from_numpy, (eps, p, n_neg)), m)
    np.testing.assert_array_equal(jc, tc.numpy())
    jd = np.asarray(jrq.decode_math(jnp.asarray(jc), eps, p, m))
    td = trq.decode_math(torch.from_numpy(jc.copy()), torch.from_numpy(eps),
                         torch.from_numpy(p), m)
    np.testing.assert_array_equal(jd, td.numpy())
