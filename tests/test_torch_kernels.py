"""Port parity of the four hot-path kernels: each plain PyTorch version (what
a kernel wrapper runs on a CPU tensor) against the reference's Pallas kernel
in interpret mode, on the same inputs, at <= 16 rows.

Tolerances:
* B1 ``topk_threshold``, B4 ``sampled_threshold``: bitwise tau and count
  (and B4's mid-gap tau) -- compare, count and halve only.
* B2 ``fused_compress``: bitwise codes, indices and tau, given the same
  spectrum planes, weights, tau and quantizer params.  With ``tau=None``
  (its own bisection): codes and indices bitwise; tau bitwise against the
  reference's ``bisect_tau`` on the same magnitudes, and within 2 ulps of
  the reference kernel's own tau, because XLA's CPU backend contracts
  ``re*re + im*im`` into an FMA there, so its magnitudes differ from the
  IEEE ones (the port's, on the card too) in the last bit on ~8% of bins.
* B3 ``fused_decompress``: max abs error <= 2e-6 * max|x| per row -- the
  reference's 4-step matmul FFT and ``torch.fft.irfft`` are both fp32 FFTs
  that sum in different orders (the reference module's stated tolerance).

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft as jfft
from repro.core import selection as jsel
from repro.core.quantizer import RangeQuantConfig as JRQ, fit_quantizer as jfit
from repro.kernels import (fused_compress as jfc, fused_decompress as jfd,
                           sampled_threshold as jst, topk_threshold as jtt)
from repro_torch.core import fft as tfft
from repro_torch.core import selection as tsel
from repro_torch.kernels import (fused_compress as tfc, fused_decompress as tfd,
                                 sampled_threshold as tst, topk_threshold as ttt)


def _spectrum(rows, chunk, seed, scale=0.05):
    """rfft planes of gaussian chunks (tie-free magnitudes), as numpy."""
    x = np.random.default_rng(seed).standard_normal((rows, chunk)).astype(np.float32) * scale
    z = np.fft.rfft(x.astype(np.float64), axis=-1)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _mag(re, im, w):
    return (np.sqrt(re * re + im * im) * w).astype(np.float32)


def _np(t):
    return np.asarray(t)


def _edge_rows(mag, kind):
    """Rows the kernel must match on besides plain ones (normal-range data:
    XLA's CPU flushes denormals)."""
    mag = mag.copy()
    cols = mag.shape[1]
    if kind == "nan":  # torch.amax and jnp.max keep the NaN: tau 0
        mag[:, cols // 3] = np.nan
    elif kind == "inf":  # upper_bracket(+inf) is a NaN: tau 0, however large the rest
        mag *= np.float32(1e30)
        mag[:, cols - 1] = np.inf
    elif kind == "nan_inf":
        mag[:, 0] = np.inf
        mag[:, cols // 2] = np.nan
    elif kind == "zero":
        mag[:] = 0.0
    elif kind == "all_flt_max":  # lo + hi overflows: tau FLT_MAX / 2
        mag[:] = np.finfo(np.float32).max
    elif kind == "tiny":  # one huge value: 48 sweeps never reach the rest, tau 0
        mag *= np.float32(1e-3)
        mag[:, cols // 2] = np.float32(1e30)
    return mag


_EDGE = ["nan", "inf", "nan_inf", "zero", "all_flt_max", "tiny"]


@pytest.mark.parametrize("rows,cols,k,kind", [
    pytest.param(4, 2049, 615, "plain", id="4-2049-615"),
    pytest.param(8, 512, 100, "plain", id="8-512-100"),
    pytest.param(3, 513, 129, "plain", id="3-513-129"),
    *(pytest.param(4, 2049, 615, kind, id=f"4-2049-615-{kind}") for kind in _EDGE),
    *(pytest.param(3, 513, 129, kind, id=f"3-513-129-{kind}") for kind in _EDGE)])
def test_topk_threshold_plain_vs_pallas_bitwise(rows, cols, k, kind):
    """Tau and count bitwise, on plain rows and on the edge rows the CUDA
    kernel is held to on the card (tests/test_torch_cuda.py)."""
    mag = np.abs(np.random.default_rng(k).standard_normal((rows, cols))).astype(np.float32)
    mag = _edge_rows(mag, kind)
    jt, jc = jtt.threshold_pallas(jnp.asarray(mag), k=k, interpret=True)
    tt, tc = ttt.threshold(torch.from_numpy(mag), k=k)
    np.testing.assert_array_equal(_np(jt).view(np.uint32), tt.numpy().view(np.uint32))
    np.testing.assert_array_equal(_np(jc), tc.numpy())


def _jax_mid_gap(mag, tau_k):
    """The reference engine's mid-gap tau (``PallasBackend.compress``)."""
    below = jnp.max(jnp.where(mag < tau_k, mag, 0.0), axis=-1, keepdims=True)
    return 0.5 * (tau_k + below)


@pytest.mark.parametrize("k", [615, 200])
def test_sampled_threshold_plain_vs_pallas_bitwise(k):
    """The port's sampled select (tau_k, count, the mid-gap tau) against the
    reference's ``sampled_select`` and its engine's mid-gap, bitwise; then
    rows whose sample sits far above the row, so lo falls back to 0, and
    rows whose sample is all zero, so hi falls back to nextafter(max)."""
    re, im = _spectrum(6, 4096, k)
    mag = _mag(re, im, _np(jfft.hermitian_weights(4096)))
    cols = mag.shape[1]
    s, stride, offset = tsel._sample_layout(cols, 1 / 64, 0)
    sample_cols = offset + stride * np.arange(s)
    lo_high = mag.copy()
    lo_high[:, sample_cols] += np.float32(100.0)
    hi_low = mag.copy()
    hi_low[0::2, sample_cols] = 0.0
    for m, side, rows in ((mag, None, []), (lo_high, "lo", range(6)), (hi_low, "hi", [0, 2, 4])):
        t = torch.from_numpy(m)
        lo, hi = tsel.sample_bracket(tsel.strided_sample(t), k, cols)
        lo_broken = ((t >= lo[:, None]).sum(dim=-1) < k).nonzero().flatten().tolist()
        hi_broken = ((t >= hi[:, None]).sum(dim=-1) >= k).nonzero().flatten().tolist()
        assert (lo_broken, hi_broken) == ((list(rows), []) if side == "lo" else
                                          ([], list(rows)))
        jt, jc = jst.sampled_select(jnp.asarray(m), k=k, interpret=True)
        jtau = _jax_mid_gap(jnp.asarray(m), jt)
        tt, tc, ttau = tst.sampled_select(t, k=k)
        np.testing.assert_array_equal(_np(jt).view(np.uint32), tt.numpy().view(np.uint32))
        np.testing.assert_array_equal(_np(jc), tc.numpy())
        np.testing.assert_array_equal(_np(jtau).view(np.uint32), ttau.numpy().view(np.uint32))


def _fused_compress_both(re, im, w, eps, p, tau, k_keep, n_bits=8, m_bits=3):
    j = jfc.fused_compress_pallas(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(w), jnp.asarray(eps), jnp.asarray(p),
        jnp.asarray(tau), k_keep=k_keep, n_bits=n_bits, m_bits=m_bits, interpret=True)
    t = tfc.fused_compress(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(w),
        torch.from_numpy(np.asarray(eps)), torch.from_numpy(np.asarray(p)),
        torch.from_numpy(tau), k_keep=k_keep, n_bits=n_bits, m_bits=m_bits)
    return j, t


@pytest.mark.parametrize("k_keep", [127, 128, 129])
def test_fused_compress_plain_vs_pallas_at_tile_boundary(k_keep):
    """The bisection threshold's tau, scalar params, a 1024-chunk plane."""
    re, im = _spectrum(3, 1024, k_keep)
    w = _np(jfft.hermitian_weights(1024))
    q = jfit(-2.0, 2.0, JRQ(8, 3))
    eps, p = np.float32(q.eps), np.int32(q.p_codes)
    tau = ttt.threshold(torch.from_numpy(_mag(re, im, w)), k=k_keep)[0].numpy()
    j, t = _fused_compress_both(re, im, w, eps, p, tau, k_keep)
    assert t[0].shape == (3, tfc.pad_k(k_keep)) and t[0].dtype == torch.uint8
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(a), b.numpy())
    assert not np.any(t[0].numpy()[:, k_keep:]) and not np.any(t[2].numpy()[:, k_keep:])


@pytest.mark.parametrize("n_bits,m_bits", [(8, 3), (4, 2), (12, 7)])
def test_fused_compress_plain_vs_pallas_per_row_params(n_bits, m_bits):
    """The engine's call: given mid-gap tau, one fit per row, 2049 bins;
    12 bits give uint16 codes."""
    rows, k = 8, 615
    re, im = _spectrum(rows, 4096, n_bits)
    w = _np(jfft.hermitian_weights(4096))
    mag = _mag(re, im, w)
    tau_k, _ = ttt.threshold(torch.from_numpy(mag), k=k)
    tau_k = tau_k.numpy()
    below = np.where(mag < tau_k, mag, 0.0).max(axis=-1, keepdims=True)
    tau = (np.float32(0.5) * (tau_k + below)).astype(np.float32)
    fits = [jfit(float(min(re[r].min(), im[r].min())), float(max(re[r].max(), im[r].max())),
                 JRQ(n_bits, m_bits)) for r in range(rows)]
    eps = np.array([np.float32(f.eps) for f in fits], np.float32)
    p = np.array([np.int32(f.p_codes) for f in fits], np.int32)
    j, t = _fused_compress_both(re, im, w, eps, p, tau, k, n_bits, m_bits)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(a), b.numpy())


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("cols,k_keep", [(513, 127), (513, 128), (513, 129), (2049, 615)])
def test_fused_compress_bisect_plain_vs_pallas_bitwise(cols, k_keep, per_row):
    """``tau=None``: the kernel bisects each row for k_keep itself (the
    reference tests' cases, tests/test_kernels.py: 513 bins at the 128-slot
    tile, 2049 at the 70% drop's 615), one fit or one fit per row -- codes
    and indices bitwise; tau bitwise against the reference's bisection on
    the same magnitudes and B1's, within 2 ulps of the reference kernel's
    (see the module docstring)."""
    rows = 3
    re, im = _spectrum(rows, 2 * (cols - 1), k_keep + cols)
    w = _np(jfft.hermitian_weights(2 * (cols - 1)))
    if per_row:
        fits = [jfit(float(min(re[r].min(), im[r].min())), float(max(re[r].max(), im[r].max())),
                     JRQ(8, 3)) for r in range(rows)]
        eps = np.array([np.float32(f.eps) for f in fits], np.float32)
        p = np.array([np.int32(f.p_codes) for f in fits], np.int32)
    else:
        q = jfit(-2.0, 2.0, JRQ(8, 3))
        eps, p = np.float32(q.eps), np.int32(q.p_codes)
    j = jfc.fused_compress_pallas(jnp.asarray(re), jnp.asarray(im), jnp.asarray(w),
                                  jnp.asarray(eps), jnp.asarray(p), k_keep=k_keep,
                                  interpret=True)
    t = tfc.fused_compress(torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(w),
                           torch.from_numpy(np.asarray(eps)), torch.from_numpy(np.asarray(p)),
                           k_keep=k_keep)
    assert t[3].shape == (rows, 1) and t[3].dtype == torch.float32
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(_np(a), b.numpy())
    mag = _mag(re, im, w)
    tau = t[3].numpy().view(np.int32)
    np.testing.assert_array_equal(tau, _np(jsel.bisect_tau(jnp.asarray(mag), k_keep))[:, None]
                                  .view(np.int32))
    np.testing.assert_array_equal(tau, ttt.threshold(torch.from_numpy(mag), k=k_keep)[0].numpy()
                                  .view(np.int32))
    np.testing.assert_array_max_ulp(_np(j[3]), t[3].numpy(), maxulp=2)


def test_fused_decompress_plain_vs_pallas():
    rows, k = 8, 615
    re, im = _spectrum(rows, 4096, 11)
    w = _np(jfft.hermitian_weights(4096))
    fits = [jfit(float(min(re[r].min(), im[r].min())), float(max(re[r].max(), im[r].max())),
                 JRQ(8, 3)) for r in range(rows)]
    eps = np.array([np.float32(f.eps) for f in fits], np.float32)
    p = np.array([np.int32(f.p_codes) for f in fits], np.int32)
    tau = ttt.threshold(torch.from_numpy(_mag(re, im, w)), k=k)[0]
    rec, imc, idx, _ = (x.numpy() for x in tfc.fused_compress(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(w),
        torch.from_numpy(eps), torch.from_numpy(p), tau, k_keep=k))
    rec, imc, idx16 = rec[:, :k], imc[:, :k], idx[:, :k].astype(np.int16)
    y_j = _np(jfd.fused_decompress_pallas(jnp.asarray(rec), jnp.asarray(imc),
                                          jnp.asarray(idx16), jnp.asarray(eps),
                                          jnp.asarray(p), m_bits=3, interpret=True))
    y_t = tfd.fused_decompress(torch.from_numpy(rec), torch.from_numpy(imc),
                               torch.from_numpy(idx16), torch.from_numpy(eps),
                               torch.from_numpy(p), m_bits=3).numpy()
    assert y_t.shape == (rows, 4096) and y_t.dtype == np.float32
    err = np.abs(y_j - y_t).max(axis=-1)
    assert np.all(err <= 2e-6 * np.abs(y_j).max(axis=-1)), err
    # scalar params and uint16 codes (a 12-bit fit) take the same path
    q = jfit(-2.0, 2.0, JRQ(12, 7))
    codes = np.random.default_rng(1).integers(0, 4096, (2, 130)).astype(np.uint16)
    bins = np.random.default_rng(2).permutation(2049)[:260].reshape(2, 130).astype(np.int32)
    y_j = _np(jfd.fused_decompress_pallas(jnp.asarray(codes), jnp.asarray(codes[::-1].copy()),
                                          jnp.asarray(bins), q.eps, q.p_codes, m_bits=7,
                                          interpret=True))
    y_t = tfd.fused_decompress(torch.from_numpy(codes.astype(np.int32)).to(torch.uint16),
                               torch.from_numpy(codes[::-1].astype(np.int32)).to(torch.uint16),
                               torch.from_numpy(bins), torch.tensor(np.float32(q.eps)),
                               torch.tensor(np.int32(q.p_codes)), m_bits=7).numpy()
    err = np.abs(y_j - y_t).max(axis=-1)
    assert np.all(err <= 2e-6 * np.abs(y_j).max(axis=-1)), err


def test_kernel_wrappers_count_only_launches():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    mag = torch.rand((2, 300))
    before = ttt.KERNEL.launches
    ttt.threshold(mag, k=10)
    assert ttt.KERNEL.launches == before
    before = tfc.BISECT_KERNEL.launches, tfc.KERNEL.launches
    tfc.fused_compress(mag, mag, torch.ones(300), 0.01, 100, k_keep=10)
    assert (tfc.BISECT_KERNEL.launches, tfc.KERNEL.launches) == before


def test_fft_helpers_match():
    """Weights exactly; the chunked transforms within fp32 FFT tolerance
    (XLA's and torch's FFTs agree to ~1e-6 relative, not bitwise)."""
    np.testing.assert_array_equal(_np(jfft.hermitian_weights(4096)),
                                  tfft.hermitian_weights(4096).numpy())
    x = np.random.default_rng(0).standard_normal(3 * 1024 + 100).astype(np.float32)
    jz, jn = jfft.chunked_rfft(jnp.asarray(x), 1024)
    tz, tn = tfft.chunked_rfft(torch.from_numpy(x), 1024)
    assert tn == jn == x.size and tz.dtype == torch.complex64
    np.testing.assert_allclose(tz.numpy(), _np(jz), atol=1e-4)
    y = tfft.chunked_irfft(tz, tn, 1024).numpy()
    np.testing.assert_allclose(y, _np(jfft.chunked_irfft(jz, jn, 1024)), atol=1e-5)
    np.testing.assert_allclose(y, x, atol=1e-5)
