"""Port parity of the SSM mixer and of hymba (``models/ssm.py``, the
``hybrid`` layer kind), against the reference at ``reduced()`` size.

Tolerances, each with its reason:

* ``associative_scan``: bitwise against ``jax.lax.associative_scan`` run
  eagerly (op by op, the same combines in the same order).  Under ``jit``
  XLA's CPU contracts ``b1 * a2 + b2`` into an FMA (ROADMAP.md §3, fault
  1's mechanism), one rounding fewer a combine: there within
  ``SCAN_ATOL`` = 1e-5 of the running magnitude (f32 over 65 steps).
* The mixer in f32 (``ssm_apply`` at S = 70, not a multiple of the 64-step
  chunk, fresh and from a prefix state; ``ssm_decode_step``): outputs and
  states within ``F32_REL`` = 1e-5 relative L2 of the jitted reference
  (the FMA above, summed over the chunks and the state axis); the bf16
  conv tail within one bf16 ulp (``bf16_close``: its f32 input
  projection rounds its last bit otherwise than XLA's, which can cross a
  bf16 rounding edge).
* hymba's loss within 1e-2 relative and every gradient leaf within 5e-2
  relative L2 (measured: 3e-6 and at most 1.2e-2), prefill and decode
  logits within ``LOGITS_ATOL`` = 5e-2 absolute (measured 4e-3, max
  |logit| ~0.5) and every float cache leaf within ``REL_L2`` = 1e-2
  (measured at most 6.3e-3, the f32 SSM state): the reasons and bounds of
  ``tests/test_torch_model.py`` and ``tests/test_torch_serve.py`` -- both
  frameworks compute in bf16 but round its matmuls and reductions at
  different places.  Cache positions exactly.

One module fixture computes every reference output (~12 s of compiling).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.models import ssm as JS
from repro_torch import configs, convert
from repro_torch.models import LM, layers as TL, ssm as TS

ARCH = "hymba_1_5b"
SEQ, PROMPT, MAX_SEQ, DECODE = 70, 70, 96, 5
SCAN_ATOL = 1e-5
F32_REL = 1e-5
LOGITS_ATOL = 5e-2
REL_L2 = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models are tiny: one intra-op thread runs them as fast as a pool
    and keeps the parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def _ssm_params(cfg, rng):
    """Random mixer parameters, the decays and biases off their init values."""
    shapes = {k: s.shape for k, s in TS.ssm_shapes(cfg).items()}
    p = {k: (rng.normal(size=s) * 0.2).astype(np.float32) for k, s in shapes.items()}
    p["a_log"] = rng.uniform(-1.0, 1.0, shapes["a_log"]).astype(np.float32)
    p["d_skip"] = np.ones(shapes["d_skip"], np.float32)
    return p


@pytest.fixture(scope="module")
def ref():
    jcfg = jreg.get_config(ARCH).reduced()
    cfg = configs.get_config(ARCH).reduced()
    rng = np.random.default_rng(0)
    out = {"cfg": cfg, "jcfg": jcfg}

    # the mixer alone, f32
    p = _ssm_params(cfg, rng)
    x = rng.normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    apply = jax.jit(lambda p, x, s: JS.ssm_apply(p, x, jcfg, s))
    y0, s0 = jax.jit(lambda p, x: JS.ssm_apply(p, x, jcfg))(jp, x)
    y1, s1 = apply(jp, x[:, :31], JS.SSMState(s0.conv, s0.h))
    steps, state = [], s1
    decode = jax.jit(lambda p, x, s: JS.ssm_decode_step(p, x, jcfg, s))
    for t in range(3):
        y, state = decode(jp, x[:, t:t + 1], state)
        steps.append((np.asarray(y), state))
    out["mixer"] = dict(p=p, x=x, y0=y0, s0=s0, y1=y1, s1=s1, steps=steps)

    # the model
    jmodel = jreg.build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    toks = rng.integers(0, 256, (2, SEQ + DECODE + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :SEQ]), "targets": jnp.asarray(toks[:, 1:SEQ + 1])}
    out["loss"], out["grads"] = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, batch)[0]))(params)
    logits, caches = jax.jit(lambda p, t: jmodel.prefill(p, t, max_seq=MAX_SEQ,
                                                         last_only=True))(
        params, jnp.asarray(toks[:, :PROMPT]))
    out["prefill"] = (np.asarray(logits), _np(caches))
    jdecode = jax.jit(jmodel.decode_step)
    decoded = []
    for i in range(DECODE):
        logits, caches = jdecode(params, caches, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
                                 jnp.int32(PROMPT + i))
        decoded.append(np.asarray(logits))
    out["decode"] = (decoded, _np(caches))
    out["toks"] = toks
    tmodel = LM(cfg, device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_np(params)))
    out["model"] = tmodel
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cache_leaves(cache, prefix=""):
    if isinstance(cache, tuple):
        for i, c in enumerate(cache):
            yield from _cache_leaves(c, f"{prefix}[{i}]")
        return
    for f in dataclasses.fields(cache):
        value = getattr(cache, f.name)
        if isinstance(value, torch.Tensor):
            yield f"{prefix}.{f.name}", value


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """bf16 tensors equal within one bf16 ulp of ``want``, elementwise."""
    got, want = got.float(), want.float()
    return bool(torch.all((got - want).abs() <= want.abs() * 2.0 ** -7))


def check_caches(got, want_jax):
    """Every leaf of the port's caches against the reference's: the same
    structure, shapes and dtypes, positions exactly, floats within REL_L2."""
    want = convert.caches_from_jax(want_jax)
    assert set(got) == set(want)
    n = 0
    for key in got:
        pairs = list(zip(_cache_leaves(got[key]), _cache_leaves(want[key])))
        assert len(pairs) == len(list(_cache_leaves(want[key])))
        for (name, a), (wname, b) in pairs:
            assert name == wname and a.shape == b.shape and a.dtype == b.dtype, (key, name)
            if a.dtype.is_floating_point:
                assert _rel(a.float(), b.float()) <= REL_L2, (key, name, _rel(a.float(),
                                                                            b.float()))
            else:
                assert torch.equal(a, b), (key, name)
            n += 1
    return n


@pytest.mark.parametrize("length", [1, 2, 3, 7, 64, 65])
def test_associative_scan_matches_jax(length):
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, (3, length, 5, 4)).astype(np.float32)
    b = rng.normal(size=(3, length, 5, 4)).astype(np.float32)
    ta, tb = TL.associative_scan(_combine, (torch.from_numpy(a), torch.from_numpy(b)), dim=1)
    with jax.disable_jit():
        ea, eb = jax.lax.associative_scan(_combine, (a, b), axis=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ea))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(eb))
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(_combine, (a, b), axis=1))(a, b)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))  # products alone: no FMA
    scale = np.maximum.accumulate(np.abs(b), axis=1).max()
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=SCAN_ATOL * scale)


def test_softplus_has_no_linear_branch():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 25.0, 80.0])
    np.testing.assert_array_equal(TS.softplus(x).numpy(), np.asarray(jax.nn.softplus(x.numpy())))


def test_ssm_apply_matches(ref):
    m, cfg = ref["mixer"], ref["cfg"]
    p = {k: torch.from_numpy(v) for k, v in m["p"].items()}
    x = torch.from_numpy(m["x"])
    y0, s0 = TS.ssm_apply(p, x, cfg)
    assert y0.shape == (2, SEQ, cfg.d_model) and s0.h.dtype == torch.float32
    assert s0.conv.dtype == torch.bfloat16 and s0.conv.shape == (2, 3, 128)
    assert _rel(y0, m["y0"]) <= F32_REL
    assert _rel(s0.h, m["s0"].h) <= F32_REL
    assert bf16_close(s0.conv, convert._tensor(np.asarray(m["s0"].conv)))
    # from a prefix state: the conv tail prefixes the sequence, h carries on
    y1, s1 = TS.ssm_apply(p, x[:, :31], cfg, TS.SSMState(s0.conv, s0.h))
    assert _rel(y1, m["y1"]) <= F32_REL
    assert _rel(s1.h, m["s1"].h) <= F32_REL
    assert bf16_close(s1.conv, convert._tensor(np.asarray(m["s1"].conv)))


def test_ssm_decode_step_matches(ref):
    m, cfg = ref["mixer"], ref["cfg"]
    p = {k: torch.from_numpy(v) for k, v in m["p"].items()}
    x = torch.from_numpy(m["x"])
    _, state = TS.ssm_apply(p, x[:, :31], cfg, TS.SSMState(*(
        convert._tensor(np.asarray(t)) for t in (m["s0"].conv, m["s0"].h))))
    for t, (want_y, want_state) in enumerate(m["steps"]):
        y, state = TS.ssm_decode_step(p, x[:, t:t + 1], cfg, state)
        assert y.shape == (2, 1, cfg.d_model)
        assert _rel(y, want_y) <= F32_REL, t
        assert _rel(state.h, want_state.h) <= F32_REL, t
        assert bf16_close(state.conv, convert._tensor(np.asarray(want_state.conv))), t


def test_hymba_loss_and_gradients_match(ref):
    tmodel, toks = ref["model"], ref["toks"]
    tmodel.zero_grad()
    batch = {"tokens": torch.from_numpy(toks[:, :SEQ]).long(),
             "targets": torch.from_numpy(toks[:, 1:SEQ + 1]).long()}
    loss, metrics = tmodel.loss(batch)
    loss.backward()
    want = float(ref["loss"])
    assert abs(float(loss) - want) <= 1e-2 * abs(want)
    assert float(metrics["aux"]) == 0.0
    grads = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(grads) == len(list(tmodel.parameters())) == 19
    for path, jg in grads:
        name = ".".join(k.key for k in path)
        tg = tmodel.get_parameter(name).grad
        assert _rel(tg, jg) <= 5e-2, (name, _rel(tg, jg))


def test_hymba_prefill_logits_and_caches_match(ref):
    tmodel, toks = ref["model"], ref["toks"]
    logits, caches = tmodel.prefill(torch.from_numpy(toks[:, :PROMPT]).long(),
                                    max_seq=MAX_SEQ, last_only=True)
    want_logits, want_caches = ref["prefill"]
    assert logits.shape == (2, 1, 256)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=LOGITS_ATOL)
    # one hybrid layer kind: a (KVCache, SSMState) pair, every leaf stacked
    kv, state = caches["l0_hybrid"]
    assert kv.k.shape == (2, 2, MAX_SEQ, 2, 16) and state.h.shape == (2, 2, 128, 8)
    assert check_caches(caches, want_caches) == 5


def test_hymba_decode_teacher_forced_matches(ref):
    tmodel, toks = ref["model"], ref["toks"]
    _, caches = tmodel.prefill(torch.from_numpy(toks[:, :PROMPT]).long(), max_seq=MAX_SEQ,
                               last_only=True)
    want_logits, want_caches = ref["decode"]
    for i in range(DECODE):
        logits, caches = tmodel.decode_step(
            caches, torch.from_numpy(toks[:, PROMPT + i:PROMPT + i + 1]).long(), PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), want_logits[i], rtol=0, atol=LOGITS_ATOL,
                                   err_msg=f"decode step {i}")
    check_caches(caches, want_caches)
    assert caches["l0_hybrid"][0].pos[0, PROMPT:PROMPT + DECODE].tolist() == list(
        range(PROMPT, PROMPT + DECODE))
