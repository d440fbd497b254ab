"""Port parity: ``repro_torch.core.selection`` against ``repro.core.selection``.

Tolerance: bitwise.  Every function here is compare, count, halve and
bit-pattern arithmetic on float32, which both frameworks round the same way
on normal-range inputs.  (XLA's CPU backend flushes denormals to zero and
torch keeps them, so the inputs stay in the normal range.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro_torch.core import selection as tsel


def _mag(rows, cols, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal((rows, cols))).astype(np.float32) + np.float32(1e-3)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_upper_bracket_bitwise():
    x = np.concatenate([_mag(1, 500, 0)[0], [1.0, 2.0 ** -126, 3.4e38,
                                             np.finfo(np.float32).max]]).astype(np.float32)
    _eq(jsel.upper_bracket(jnp.asarray(x)), tsel.upper_bracket(torch.from_numpy(x)))


@pytest.mark.parametrize("rows,cols,k", [(4, 2049, 615), (3, 513, 129), (2, 64, 1)])
def test_bisect_tau_bitwise(rows, cols, k):
    mag = _mag(rows, cols, k)
    _eq(jsel.bisect_tau(jnp.asarray(mag), k), tsel.bisect_tau(torch.from_numpy(mag), k))


@pytest.mark.parametrize("k", [100, 615])
def test_sample_and_refine_bracket_bitwise(k):
    mag = _mag(6, 2049, k)
    js = jsel.strided_sample(jnp.asarray(mag), 1 / 64, seed=3)
    ts = tsel.strided_sample(torch.from_numpy(mag), 1 / 64, seed=3)
    _eq(js, ts)
    jlo, jhi = jsel.sample_bracket(js, k, 2049)
    tlo, thi = tsel.sample_bracket(ts, k, 2049)
    _eq(jlo, tlo)
    _eq(jhi, thi)
    # one bracket too narrow on purpose: the clamp falls back to the full range
    tlo2, jlo2 = tlo.clone(), np.array(jlo)
    tlo2[0], jlo2[0] = 1e9, 1e9
    _eq(jsel.refine_bracket(jnp.asarray(mag), jnp.asarray(jlo2), jhi, k, 16),
        tsel.refine_bracket(torch.from_numpy(mag), tlo2, thi, k, 16))


@pytest.mark.parametrize("selector", ["bisect", "sampled"])
def test_selector_tau_and_count_compact_bitwise(selector):
    mag = _mag(5, 2049, 7).reshape(5, 1, 2049)
    jt = jsel.selector_tau(jnp.asarray(mag), 615, selector)
    tt = tsel.selector_tau(torch.from_numpy(mag), 615, selector)
    _eq(jt, tt)
    _eq(jsel.count_compact(jnp.asarray(mag), jt, 615),
        tsel.count_compact(torch.from_numpy(mag), tt, 615))


def test_resolve_selector_matches():
    for sel in jsel.SELECTOR_NAMES:
        for cols in (64, 511, 512, 2049):
            assert jsel.resolve_selector(sel, cols) == tsel.resolve_selector(sel, cols)
    with pytest.raises(ValueError):
        tsel.resolve_selector("nope", 10)


@pytest.mark.parametrize("kind", ["plain", "nan", "zero", "ties"])
def test_mid_gap_bitwise(kind):
    """The mid-gap tau the engine keeps by, from the sampled selector's
    tau_k, against the reference engine's expression: a NaN is not below
    tau_k, a row with nothing below it keeps 0 as the gap's floor."""
    mag = _mag(5, 2049, 11)
    if kind == "nan":
        mag[:, 7] = np.nan
    elif kind == "zero":
        mag[1:3] = 0.0
    elif kind == "ties":
        mag = np.floor(mag * 3).astype(np.float32)
    jt = jsel.selector_tau(jnp.asarray(mag), 615, "sampled")
    tt = tsel.selector_tau(torch.from_numpy(mag), 615, "sampled")
    _eq(jt, tt)
    jmag = jnp.asarray(mag)
    want = 0.5 * (jt + jnp.max(jnp.where(jmag < jt, jmag, 0.0), axis=-1, keepdims=True))
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  tsel.mid_gap(torch.from_numpy(mag), tt).numpy().view(np.uint32))
