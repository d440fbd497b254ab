"""Port parity of the convergence theory (``core/theory.py``), error
feedback (``core/error_feedback.py``) and the paper's Algorithm 1
(``quantizer.tune_eps_heuristic``, ``fit_quantizer(method="heuristic")``)
against the reference, on seeded numpy inputs.

Tolerances.  The plug-in estimates, Thm 3.4's bound and envelope and
``curves_close`` are host arithmetic on Python floats in both packages:
equal.  ``assumption31_stats`` is a float32 norm whose sum order differs:
within 1e-6 relative.  One EF step through the same ``FFTCompressor`` (the
reference backend): the same kept indices and codes, the new residual
within 1e-5 relative L2 (the two rffts differ by ~2e-7 relative).

Algorithm 1: eps is only ever 0.002 doubled or halved, or clipped to the
range, so it is bitwise.  P, ``ceil(2**m * (log2(max) - log2(eps)))``,
is equal too, with one named exception: where the search clipped eps to
``max`` and halved it, ``max / eps`` is a power of two, the ceil's argument
is an integer in exact arithmetic, and an ulp of ``log`` (torch's against
XLA's) moves P by one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error_feedback as jef
from repro.core import quantizer as jq
from repro.core import theory as jt
from repro.core.compressor import FFTCompressor as JComp, FFTCompressorConfig as JCfg
from repro_torch.core import error_feedback as tef
from repro_torch.core import quantizer as tq
from repro_torch.core import theory as tt
from repro_torch.core.compressor import FFTCompressor as TComp, FFTCompressorConfig as TCfg

QUANT_CONFIGS = ((8, 3), (4, 2), (12, 4))
_jencode = jax.jit(jq.encode)


def _curves(seed, n=40):
    rng = np.random.default_rng(seed)
    loss = list(4.0 * np.exp(-np.arange(n) / 15.0) + 1.0 + 0.05 * rng.standard_normal(n))
    gsq = list(np.abs(rng.standard_normal(n)) * np.exp(-np.arange(n) / 20.0) + 0.01)
    return [float(x) for x in loss], [float(x) for x in gsq]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assumption31_stats_and_verdicts_match(seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(10_000).astype(np.float32)
    for v_hat in (v * 0.9, v + 0.3 * rng.standard_normal(v.shape).astype(np.float32),
                  np.zeros_like(v), v * 1.00005):
        v_hat = v_hat.astype(np.float32)
        je, jn = jt.assumption31_stats(jnp.asarray(v), jnp.asarray(v_hat))
        te, tn = tt.assumption31_stats(torch.from_numpy(v), torch.from_numpy(v_hat))
        assert te.dtype == tn.dtype == torch.float32
        assert float(te) == pytest.approx(float(je), rel=1e-6, abs=1e-7)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6, abs=1e-7)
        for theta in (0.3, 0.7, 0.9):
            for slack, tol in ((1.0, 1e-4), (1.5, 0.08)):
                assert tt.assumption31_holds(torch.from_numpy(v), torch.from_numpy(v_hat),
                                             theta, slack, tol) == jt.assumption31_holds(
                    jnp.asarray(v), jnp.asarray(v_hat), theta, slack, tol)
    for err, norm in ((0.5, 0.9), (0.71, 1.0), (0.7, 1.0001), (0.9, 1.2)):
        for theta in (0.5, 0.7):
            assert (tt.assumption31_holds_stats(err, norm, theta)
                    == jt.assumption31_holds_stats(err, norm, theta))
    zero = torch.zeros(8)
    assert [float(x) for x in tt.assumption31_stats(zero, zero)] == [0.0, 0.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_thm34_constants_envelope_and_curves_match(seed):
    loss, gsq = _curves(seed)
    for args in ((2.0, 1.5, 0.01, 0.7, 0.3, 16, 50), (0.0, 10.0, 0.1, 0.0, 2.0, 1, 0)):
        assert dataclasses_equal(tt.thm34_bound(*args), jt.thm34_bound(*args))
    for kwargs in (dict(eta=3e-3, batch=16), dict(eta=0.1, batch=16, fstar=1.0,
                                                  tail_fraction=0.5)):
        tc = tt.estimate_curve_constants(loss, gsq, **kwargs)
        jc = jt.estimate_curve_constants(loss, gsq, **kwargs)
        assert dataclasses_equal(tc, jc)
        for theta, slack in ((0.7, 1.0), (0.99, 0.5), (0.0, 1e-3)):
            te = tt.thm34_envelope(gsq, tc, eta=kwargs["eta"], theta=theta, batch=16,
                                   slack=slack)
            je = jt.thm34_envelope(gsq, jc, eta=kwargs["eta"], theta=theta, batch=16,
                                   slack=slack)
            assert (te.bounds, te.min_so_far, te.holds) == (je.bounds, je.min_so_far, je.holds)
    for other, atol in ((loss, 0.0), ([x + 1e-6 for x in loss], 1e-5),
                        ([x + 1e-3 for x in loss], 1e-5)):
        assert tt.curves_close(loss, other, atol) == jt.curves_close(loss, other, atol)
    for bad in (([1.0], [1.0]), ([1.0, 2.0], [1.0])):
        for mod in (tt, jt):
            with pytest.raises(ValueError):
                mod.estimate_curve_constants(*bad, eta=0.1, batch=1)
    with pytest.raises(ValueError):
        tt.curves_close([1.0], [1.0, 2.0])


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_theory_names():
    assert sorted(tt.__all__) == sorted(jt.__all__)


def test_compress_with_feedback_matches_reference():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(3 * 4096 + 100) * 0.05).astype(np.float32)
    r = (rng.standard_normal(g.shape) * 0.01).astype(np.float32)
    jc, tc = JComp(JCfg(theta=0.7)), TComp(TCfg(theta=0.7))
    jp, jres = jef.compress_with_feedback(jc.compress, jc.decompress, jnp.asarray(g),
                                          jnp.asarray(r))
    tp, tres = tef.compress_with_feedback(tc.compress, tc.decompress, torch.from_numpy(g),
                                          torch.from_numpy(r))
    np.testing.assert_array_equal(np.sort(tp.idx.numpy(), -1), np.sort(np.asarray(jp.idx), -1))
    np.testing.assert_array_equal(tp.re.numpy(), np.asarray(jp.re))
    np.testing.assert_array_equal(tp.im.numpy(), np.asarray(jp.im))
    jres = np.asarray(jres)
    assert np.linalg.norm(tres.numpy() - jres) <= 1e-5 * np.linalg.norm(jres)
    # residual = corrected - decompress(payload), exactly
    corrected = torch.from_numpy(g) + torch.from_numpy(r)
    assert torch.equal(tres, corrected - tc.decompress(tp))


def test_init_residual_zeros_like_the_gradient():
    grads = {"a.w": torch.ones(3, 2), "b": torch.full((4,), 2.0)}
    res = tef.init_residual(grads)
    assert set(res) == set(grads)
    for k in grads:
        assert res[k].shape == grads[k].shape and not res[k].any()
    assert torch.equal(tef.init_residual(torch.ones(5)), torch.zeros(5))


def _ranges():
    """Two-sided, one-sided and degenerate ranges over many magnitudes."""
    rng = np.random.default_rng(7)
    fixed = [(-1.0, 1.0), (-0.003, 2.5), (-5e-4, 3e-7), (0.0, 1.0), (-1.0, 0.0),
             (0.0, 0.0), (1e-3, 5.0), (-7.0, -1e-3), (-1e-20, 1e-20), (-3e4, 1e-2),
             (-2.0, 2.0), (-1e-30, 1e-30), (5.0, 5.0)]
    drawn = [tuple(sorted(rng.standard_normal(2) * 10.0 ** rng.integers(-8, 5, 2)))
             for _ in range(30)]
    return fixed + [(float(a), float(b)) for a, b in drawn]


def _vmax_eff(lo, hi):
    vmin = torch.tensor(lo, dtype=torch.float32)
    vmax = torch.tensor(hi, dtype=torch.float32)
    return float(torch.maximum(vmax, torch.clamp_min(vmax - vmin, 1e-30) * 1e-6))


@pytest.mark.parametrize("bits", QUANT_CONFIGS, ids=lambda b: f"{b[0]}-{b[1]}")
def test_heuristic_fit_matches_reference(bits):
    jcfg, tcfg = jq.RangeQuantConfig(*bits), tq.RangeQuantConfig(*bits)
    exceptions = []
    for lo, hi in _ranges():
        jfit = jq.fit_quantizer(lo, hi, jcfg, method="heuristic")
        tfit = tq.fit_quantizer(lo, hi, tcfg, method="heuristic")
        assert tfit.eps.dtype == torch.float32 and tfit.p_codes.dtype == torch.int32
        assert np.float32(jfit.eps) == tfit.eps.numpy(), (lo, hi)
        jp, tp_ = int(jfit.p_codes), int(tfit.p_codes)
        if jp != tp_:
            # the named exception: max / eps a power of two, P off by one
            ratio = math.log2(_vmax_eff(lo, hi) / float(tfit.eps))
            assert ratio == int(ratio) and abs(jp - tp_) == 1, (lo, hi, jp, tp_)
            exceptions.append((lo, hi))
            continue
        for leaf in ("vmax", "vmin"):
            want, got = float(getattr(jfit, leaf)), float(getattr(tfit, leaf))
            assert got == pytest.approx(want, rel=1e-6, abs=0.0), (lo, hi, leaf)
        # the same eps and P encode and decode the same codes
        x = np.linspace(lo - 0.1 * abs(lo), hi + 0.1 * abs(hi), 257).astype(np.float32)
        jcodes = np.asarray(_jencode(jnp.asarray(x), jfit))
        tcodes = tq.encode(torch.from_numpy(x), tfit).numpy()
        assert (jcodes != tcodes).mean() <= 0.01, (lo, hi)
    assert len(exceptions) <= 2, exceptions


@pytest.mark.parametrize("bits", QUANT_CONFIGS, ids=lambda b: f"{b[0]}-{b[1]}")
def test_tune_eps_heuristic_direct_and_stacked(bits):
    jcfg, tcfg = jq.RangeQuantConfig(*bits), tq.RangeQuantConfig(*bits)
    los = np.array([-1.0, -0.02, -3e-5, -1e-3], np.float32)
    his = np.array([1.0, 5.0, 2e-5, 1e-3], np.float32)
    for init, iters in ((0.002, 64), (1.0, 3)):
        want = [jq.tune_eps_heuristic(jnp.float32(a), jnp.float32(b), jcfg, init, iters)
                for a, b in zip(los, his)]
        eps, p = tq.tune_eps_heuristic(torch.from_numpy(los), torch.from_numpy(his), tcfg,
                                       init, iters)
        assert eps.shape == p.shape == (4,)
        np.testing.assert_array_equal(eps.numpy(), np.array([float(w[0]) for w in want],
                                                            np.float32))
        np.testing.assert_array_equal(p.numpy(), [int(w[1]) for w in want])
        # a stack of fits is each fit alone
        for i in range(4):
            e1, p1 = tq.tune_eps_heuristic(torch.tensor(los[i]), torch.tensor(his[i]), tcfg,
                                           init, iters)
            assert float(e1) == float(eps[i]) and int(p1) == int(p[i])


def test_fit_quantizer_methods():
    cfg = tq.RangeQuantConfig()
    solve = tq.fit_quantizer(-0.5, 0.8, cfg)
    assert torch.equal(solve.eps, tq.fit_quantizer(-0.5, 0.8, cfg, method="solve").eps)
    heur = tq.fit_quantizer(-0.5, 0.8, cfg, method="heuristic")
    # Algorithm 1 lands within a factor of 2 of the balanced fit's range
    assert float(heur.vmin) <= -0.5 / 2 and float(heur.vmax) >= 0.8 / 2
    assert "tune_eps_heuristic" in tq.__all__
    with pytest.raises(ValueError, match="unknown fit method"):
        tq.fit_quantizer(-1.0, 1.0, cfg, method="bisect")
    with pytest.raises(ValueError):
        jq.fit_quantizer(-1.0, 1.0, jq.RangeQuantConfig(), method="bisect")
