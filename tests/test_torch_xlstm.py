"""Port parity of the xLSTM cells and of xlstm (``models/xlstm.py``, the
``mlstm`` and ``slstm`` layer kinds), against the reference at
``reduced()`` size (16 layers: two groups of 7 mLSTM + 1 sLSTM).

Tolerances, each with its reason:

* The cells in f32: the mLSTM at S = 300 (two 256-step chunks, the second
  padded with inert steps) fresh and from a prefix state, the sLSTM over
  40 steps, and both decode steps: outputs within ``F32_REL`` = 1e-4
  relative L2 of the jitted reference and states within ``STATE_REL`` =
  1e-4 (the bf16 conv tail within one bf16 ulp: its f32 input projection
  rounds its last bit otherwise than XLA's, which can cross a bf16
  rounding edge).  The chunkwise form sums its
  (L, L) decay-weighted products in another order than XLA's CPU dots,
  and ``exp`` of large stabilized exponents amplifies the last ulp.
* xlstm's loss within 1e-2 relative and every gradient leaf within 5e-2
  relative L2 (measured: 8e-6 and at most 1.6e-2) -- except the mLSTM's
  input-gate bias ``b_i``, whose gradient is zero in exact arithmetic: a
  constant added to every ``log i`` of a head moves the stabilizer ``m``
  by that constant and leaves C, n and h unchanged (the state starts
  empty), so both packages return rounding noise (~1e-14, against ~1e-5
  for the other leaves, and the reference's jitted and eager runs differ
  from each other by more than 100% on it).  It is held to
  ``B_I_ABS`` = 1e-9 absolute in both.
* Prefill and decode logits within ``LOGITS_ATOL`` = 5e-2 absolute and
  every float cache leaf within ``REL_L2`` = 1e-2 (measured at most
  6.3e-3), the reasons of ``tests/test_torch_serve.py``: bf16 rounded at
  other places.

* The decode-vs-forward gap at ``chip_smoke.XLSTM_GROUP`` (one group,
  d_model 1024): the reference's own within 10% of
  ``chip_smoke.XLSTM_GROUP_REF_GAP`` (XLA's CPU is deterministic), the
  port's within twice the reference's (its own moves with the thread
  count).

One module fixture computes every reference output (~25 s of compiling);
the one-group gap compiles its own (~20 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.models import xlstm as JX
from repro_torch import configs, convert
from repro_torch.models import LM, xlstm as TX

from test_torch_ssm import bf16_close, check_caches

ARCH = "xlstm_1_3b"
CELL_SEQ, PREFIX = 300, 17
SEQ, PROMPT, MAX_SEQ, DECODE = 40, 40, 64, 4
F32_REL = 1e-4
STATE_REL = 1e-4
B_I_ABS = 1e-9
LOGITS_ATOL = 5e-2


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(shapes, rng):
    p = {k: (rng.normal(size=s.shape) * 0.2).astype(np.float32) for k, s in shapes.items()}
    for k, s in shapes.items():
        if s.init == "ones":
            p[k] = (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def ref():
    jcfg = jreg.get_config(ARCH).reduced()
    cfg = configs.get_config(ARCH).reduced()
    rng = np.random.default_rng(0)
    out = {"cfg": cfg}

    # the cells alone, f32
    for kind, shapes, apply, step in (
            ("mlstm", TX.mlstm_shapes(cfg), JX.mlstm_apply, JX.mlstm_decode_step),
            ("slstm", TX.slstm_shapes(cfg), JX.slstm_apply, JX.slstm_decode_step)):
        p = _params(shapes, rng)
        seq = CELL_SEQ if kind == "mlstm" else SEQ
        x = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        fresh = jax.jit(lambda p, x, apply=apply: apply(p, x, jcfg))
        on = jax.jit(lambda p, x, s, apply=apply: apply(p, x, jcfg, s))
        y0, s0 = fresh(jp, x)
        y1, s1 = on(jp, x[:, :PREFIX], s0)
        jstep = jax.jit(lambda p, x, s, step=step: step(p, x, jcfg, s))
        steps, state = [], s1
        for t in range(3):
            y, state = jstep(jp, x[:, t:t + 1], state)
            steps.append((np.asarray(y), _np(state)))
        out[kind] = dict(p=p, x=x, y0=np.asarray(y0), s0=_np(s0), y1=np.asarray(y1),
                         s1=_np(s1), steps=steps)

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


def _check_state(got, want, label):
    for name, value in vars(got).items():
        ref = convert._tensor(getattr(want, name))
        assert value.shape == ref.shape and value.dtype == ref.dtype, (label, name)
        if name == "conv":
            assert bf16_close(value, ref), (label, name)
        else:
            assert _rel(value, ref) <= STATE_REL, (label, name, _rel(value, ref))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_matches(ref, kind):
    m, cfg = ref[kind], ref["cfg"]
    apply = TX.mlstm_apply if kind == "mlstm" else TX.slstm_apply
    p = {k: torch.from_numpy(v) for k, v in m["p"].items()}
    x = torch.from_numpy(m["x"])
    with torch.no_grad():
        y0, s0 = apply(p, x, cfg)
        assert _rel(y0, m["y0"]) <= F32_REL
        _check_state(s0, m["s0"], "fresh")
        y1, s1 = apply(p, x[:, :PREFIX], cfg, s0)
        assert _rel(y1, m["y1"]) <= F32_REL
        _check_state(s1, m["s1"], "from a prefix")
    if kind == "mlstm":
        assert x.shape[1] == CELL_SEQ > 256 and CELL_SEQ % 256  # two chunks, one padded
        assert s0.c.shape == (2, 4, 32, 32) and s0.conv.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_matches(ref, kind):
    m, cfg = ref[kind], ref["cfg"]
    step = TX.mlstm_decode_step if kind == "mlstm" else TX.slstm_decode_step
    cls = TX.MLSTMState if kind == "mlstm" else TX.SLSTMState
    p = {k: torch.from_numpy(v) for k, v in m["p"].items()}
    x = torch.from_numpy(m["x"])
    state = cls(**{k: convert._tensor(v) for k, v in vars(m["s1"]).items()})
    with torch.no_grad():
        for t, (want_y, want_state) in enumerate(m["steps"]):
            y, state = step(p, x[:, t:t + 1], cfg, state)
            assert y.shape == (2, 1, cfg.d_model)
            assert _rel(y, want_y) <= F32_REL, t
            _check_state(state, want_state, f"step {t}")


def test_mlstm_gradients_are_finite_through_padding():
    """Backward through a padded, checkpointed chunk: finite everywhere."""
    cfg = configs.get_config(ARCH).reduced()
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _params(TX.mlstm_shapes(cfg), rng).items()}
    x = torch.from_numpy(rng.normal(size=(1, 260, cfg.d_model)).astype(np.float32))
    y, _ = TX.mlstm_apply(p, x, cfg)
    y.square().mean().backward()
    for name, leaf in p.items():
        assert torch.isfinite(leaf.grad).all(), name


def test_xlstm_loss_and_gradients_match(ref):
    tmodel, toks = ref["model"], ref["toks"]
    assert tmodel.cfg.n_layers == 16 and tmodel.n_groups == 2
    tmodel.zero_grad()
    batch = {"tokens": torch.from_numpy(toks[:, :SEQ]).long(),
             "targets": torch.from_numpy(toks[:, 1:SEQ + 1]).long()}
    loss, _ = tmodel.loss(batch)
    loss.backward()
    want = float(ref["loss"])
    assert abs(float(loss.detach()) - want) <= 1e-2 * abs(want)
    grads = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(grads) == len(list(tmodel.parameters()))
    for path, jg in grads:
        name = ".".join(k.key for k in path)
        tg = tmodel.get_parameter(name).grad
        if name.endswith(".b_i"):
            assert float(tg.norm()) <= B_I_ABS and np.linalg.norm(jg) <= B_I_ABS, name
        else:
            assert _rel(tg, jg) <= 5e-2, (name, _rel(tg, jg))


def test_xlstm_prefill_logits_and_caches_match(ref):
    tmodel, toks = ref["model"], ref["toks"]
    logits, caches = tmodel.prefill(torch.from_numpy(toks[:, :PROMPT]).long(),
                                    max_seq=MAX_SEQ, last_only=True)
    want_logits, want_caches = ref["prefill"]
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=LOGITS_ATOL)
    assert isinstance(caches["l0_mlstm"], TX.MLSTMState)
    assert isinstance(caches["l7_slstm"], TX.SLSTMState)
    assert caches["l7_slstm"].c.shape == (2, 2, 64)
    assert check_caches(caches, want_caches) == 7 * 4 + 4


def test_xlstm_decode_teacher_forced_matches(ref):
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


def test_one_group_decode_gap_is_the_references():
    """xlstm's own decode-vs-forward gap at ``chip_smoke.XLSTM_GROUP`` (one
    group, d_model 1024, reduced otherwise, prompt 20 + 6 teacher-forced
    tokens): the reference's jitted reading is
    ``chip_smoke.XLSTM_GROUP_REF_GAP`` within 10% (XLA's CPU is
    deterministic), the port's (2.09e-2 on one thread; its matmuls round
    by thread count) is within twice the reference's, and
    both are under ``chip_smoke.SERVE_LOGITS_REL``, the limit the card
    holds the same config to.  The gap is bf16 rounding that decode and
    forward place otherwise, amplified through the cells."""
    import dataclasses
    import importlib.util
    import os

    from helpers import REPO

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, prompt, new = smoke.XLSTM_GROUP["shape"]
    change = smoke.XLSTM_GROUP["changes"]
    jcfg = dataclasses.replace(jreg.get_config(ARCH).reduced(), **change)
    cfg = dataclasses.replace(configs.get_config(ARCH).reduced(), **change)
    jmodel = jreg.build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tokens = smoke.xlstm_group_tokens(cfg)
    toks = tokens.numpy().astype(np.int32)
    max_seq = prompt + new + 8
    logits, caches = jax.jit(lambda p, t: jmodel.prefill(p, t, max_seq=max_seq,
                                                         last_only=True))(
        params, jnp.asarray(toks[:, :prompt]))
    stepped = [np.asarray(logits)[:, 0]]
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(new - 1):
        logits, caches = jdecode(params, caches, jnp.asarray(toks[:, prompt + i:prompt + i + 1]),
                                 jnp.int32(prompt + i))
        stepped.append(np.asarray(logits)[:, 0])
    full, _ = jax.jit(jmodel.forward)(params, jnp.asarray(toks[:, :prompt + new - 1]))
    ref_gap = _rel(np.stack(stepped, axis=1), np.asarray(full)[:, prompt - 1:])
    tmodel = LM(cfg, device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_np(params)))
    with torch.no_grad():
        got = smoke.logits_gap(*smoke.decode_and_forward(tmodel, tokens, prompt, max_seq))
    want = smoke.XLSTM_GROUP_REF_GAP
    assert abs(ref_gap - want) <= 0.1 * want, ref_gap
    assert got["rel"] <= 2 * ref_gap and ref_gap < smoke.SERVE_LOGITS_REL, (got, ref_gap)
