"""Port parity of the model zoo: the ten configs, the registry, the
parameter layout of all ten archs at full size, the MoE block, the QKV
bias, and the CLIs on the new archs (the cross-attention archs' parity:
``tests/test_torch_encdec.py``).

Tolerances, each with its reason:

* Configs, layer patterns, group counts, ``reduced()``, full-size leaf
  shapes, the flat gradient order and ``cell_is_supported``: exact.
* ``moe_apply`` against the reference's on the same inputs: in f32 within
  ``MOE_F32_REL`` = 1e-5 relative L2 (output, aux and every gradient; the
  routing is the same, sums run in other orders), in bf16 within
  ``MOE_BF16_REL`` = 2e-2 (measured 5e-3).  The reference's MoE property
  tests (``tests/test_moe_data.py``) run on the port with their own bounds.
* qwen1.5 (QKV bias): loss within 1e-2 relative and every gradient leaf
  within 5e-2 relative L2 of the jitted reference (measured 1.2e-5 and at
  most 1.8e-2).
* mixtral: the same bounds, against the reference compiled with
  ``xla_allow_excess_precision`` off, which rounds every bf16 intermediate
  as an eager run does (bitwise the reference run under
  ``jax.disable_jit``, in 2 s instead of 25).  By default XLA's CPU keeps
  bf16 intermediates in f32 inside a fusion, and those values move a
  token across a top-2 or capacity edge of the near-uniform router at
  init: that jitted gradient differs from the eager one by up to 17%
  relative L2 on the MoE leaves (and the port's by as much), while the
  port is within 1% of the eager run on every leaf.  Its serving (ring
  caches, the prompt past the window) against the same compilation:
  prefill and teacher-forced decode logits within ``SERVE_LOGITS_ATOL`` =
  5e-2 absolute (measured at most 3.9e-3, max |logit| 0.54) and every
  cache leaf within ``test_torch_ssm.check_caches``'s bounds, as
  ``tests/test_torch_serve.py`` holds gemma2.
* ``chip_smoke.moe_decode_vs_forward`` (the card's MoE serving check) on
  the reduced mixtral at one layer: its counts add up, and where the
  experts agree its gap is within ``chip_smoke.SERVE_LOGITS_REL``.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO
from repro.comms import reducers as jred
from repro.configs import base as jbase
from repro.models import moe as JM
from repro.models import registry as jreg
from repro.models.sharding import ParamSpec, init_params
from repro_torch import configs, convert
from repro_torch.comms import reducers as tred
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, layers as TL, moe as TM, registry as treg
from repro_torch.models.transformer import param_shapes

PORTED = tuple(jreg.ARCH_NAMES)
MOE_F32_REL = 1e-5
MOE_BF16_REL = 2e-2
SERVE_MAX_SEQ = 64
SERVE_LOGITS_ATOL = 5e-2


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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registry_names_and_ported_archs():
    """The reference's names in its order, and the port builds every one of
    them at full size (on the meta device: nothing is allocated)."""
    assert configs.ARCH_NAMES == tuple(jreg.ARCH_NAMES)
    assert treg.ARCH_NAMES == configs.ARCH_NAMES == PORTED
    for arch in PORTED:
        model = treg.build(arch, device="meta")
        assert sum(p.numel() for p in model.parameters()) == model.cfg.param_count()
    assert treg.LONG_CONTEXT_OK == jreg.LONG_CONTEXT_OK
    assert set(tbase.SHAPES) == set(jbase.SHAPES)
    for name, shape in tbase.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jbase.SHAPES[name])
        assert shape.tokens == jbase.SHAPES[name].tokens


@pytest.mark.parametrize("arch", jreg.ARCH_NAMES)
def test_config_matches_reference(arch):
    cfg, jcfg = configs.get_config(arch), jreg.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_pattern() == jcfg.layer_pattern()
    assert cfg.n_groups() == jcfg.n_groups()
    red, jred_ = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(jred_)
    assert red.layer_pattern() == jred_.layer_pattern() and red.n_groups() == jred_.n_groups()


@pytest.mark.parametrize("arch", PORTED)
def test_full_size_parameter_shapes_match_reference_spec(arch):
    """Every leaf's path and shape at full size against the reference's
    ``ParamSpec`` tree (nothing is allocated)."""
    cfg = configs.get_config(arch)
    spec = jreg.build(jreg.get_config(arch)).spec()
    want = {".".join(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                spec, is_leaf=lambda x: isinstance(x, ParamSpec))[0]}
    assert {k: tuple(v) for k, v in param_shapes(cfg).items()} == want
    assert cfg.param_count() == sum(int(np.prod(s)) for s in want.values())


def test_param_counts_follow_the_spec():
    """The port counts the parameters it builds; the reference's analytic
    ``param_count`` counts an MLP a hybrid layer does not have, and a self
    attention a ``cross_attn_*`` layer does not have (ROADMAP.md §3), so
    hymba's, xlstm's, seamless's and llama-vision's differ from it."""
    counts = {a: configs.get_config(a).param_count() for a in PORTED}
    assert counts["hymba_1_5b"] == 800_001_600
    assert jreg.get_config("hymba_1_5b").param_count() == 1_641_528_000
    assert counts["xlstm_1_3b"] == 4_386_117_968
    assert jreg.get_config("xlstm_1_3b").param_count() == 3_679_692_800
    assert counts["seamless_m4t_large_v2"] == 1_632_233_472
    assert jreg.get_config("seamless_m4t_large_v2").param_count() == 1_632_130_048
    assert counts["llama3_2_vision_11b"] == 9_775_157_256
    assert jreg.get_config("llama3_2_vision_11b").param_count() == 10_110_734_336
    assert counts["gemma2_2b"] == jreg.get_config("gemma2_2b").param_count()


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b", "mixtral_8x22b", "qwen1_5_110b"])
def test_flat_gradient_order_matches(arch):
    """The new layer kinds' leaves (the dense kinds: tests/test_torch_model.py)."""
    jcfg = jreg.get_config(arch).reduced()
    params = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    tmodel = LM(configs.get_config(arch).reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_np(params)))
    jflat, _, _ = jred.flatten_tree(params)
    tflat, specs = tred.flatten_tree(tmodel.leaves())
    np.testing.assert_array_equal(np.asarray(jflat), tflat.detach().numpy())
    back = tred.unflatten_tree(tflat, specs)
    for name, p in tmodel.leaves().items():
        assert torch.equal(back[name], p.detach())


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b", "mixtral_8x22b", "qwen1_5_110b"])
def test_init_by_kind_and_scale(arch):
    """zeros, ones (whatever the scale: xLSTM's b_f is 1, not 3) and
    normal x scale (0.02; 0.02/sqrt(d) for the router), drawn from the
    caller's generator."""
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), d_model=256)
    spec = jreg.build(dataclasses.replace(jreg.get_config(arch).reduced(), d_model=256)).spec()
    leaves = {".".join(k.key for k in path): s for path, s in
              jax.tree_util.tree_flatten_with_path(
                  spec, is_leaf=lambda x: isinstance(x, ParamSpec))[0]}
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    again = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for name, p in model.leaves().items():
        s = leaves[name]
        assert torch.equal(p, again.get_parameter(name)), name
        if s.init == "zeros":
            assert not p.any(), name
        elif s.init == "ones":
            assert torch.all(p == 1.0), name
        else:
            want = s.scale if s.scale is not None else 0.02
            assert abs(float(p.detach().std()) / want - 1) < 0.15, (name, want)
    if arch == "xlstm_1_3b":
        assert torch.all(model.get_parameter("layers.l0_mlstm.cell.b_f") == 1.0)


@pytest.mark.parametrize("shape", sorted(jbase.SHAPES))
def test_cell_is_supported_matches(shape):
    for arch in jreg.ARCH_NAMES:
        assert treg.cell_is_supported(arch, tbase.SHAPES[shape]) == jreg.cell_is_supported(
            arch, jbase.SHAPES[shape])


def test_make_batch_contract():
    """The reference's keys and shapes for every arch: seamless's audio
    frames as long as the sequence, llama-vision's patches; the frontend
    N(0, 1) x 0.02 in f32, as the reference's."""
    gen = torch.Generator().manual_seed(0)
    for arch in PORTED:
        cfg = configs.get_config(arch).reduced()
        batch = treg.make_batch(cfg, 2, 24, generator=gen)
        want = jreg.make_batch(jax.random.PRNGKey(0), jreg.get_config(arch).reduced(), 2, 24)
        assert set(batch) == set(want)
        for key, value in batch.items():
            assert tuple(value.shape) == want[key].shape, (arch, key)
        assert int(batch["tokens"].max()) < cfg.vocab_size and int(batch["tokens"].min()) >= 0
        if "frontend" in batch:
            assert batch["frontend"].dtype == torch.float32
            assert 0.015 < float(batch["frontend"].std()) < 0.025
    assert {a for a in PORTED if "frontend" in treg.make_batch(
        configs.get_config(a).reduced(), 1, 4)} == {"seamless_m4t_large_v2",
                                                     "llama3_2_vision_11b"}


def test_cli_refuses_n_layers_off_the_pattern(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "xlstm_1_3b", "--n-layers", "4", "--device", "cpu"])
    assert "multiple" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

MOE_CFG = dict(name="moe_test", family="moe", n_layers=2, d_model=32, n_heads=2,
               n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, n_experts=4,
               experts_per_token=2, moe_group_size=16, moe_capacity_factor=2.0, remat="none")


def _moe_params(seed=0, **changes):
    jcfg = jbase.ArchConfig(**{**MOE_CFG, **changes})
    return jcfg, tbase.ArchConfig(**{**MOE_CFG, **changes}), _np(
        init_params(jax.random.PRNGKey(seed), JM.moe_spec(jcfg)))


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def test_moe_identity_when_experts_equal():
    _, cfg, params = _moe_params()
    for k in ("up", "down", "gate"):
        params[k] = np.broadcast_to(params[k][:1], params[k].shape).copy()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 32)).astype(np.float32))
    out, _ = TM.moe_apply(_t(params), x, cfg)
    dense = TL.mlp({k: torch.from_numpy(params[k][0]) for k in ("up", "down", "gate")}, x,
                   "swiglu")
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-3)


def test_moe_capacity_drops_are_bounded():
    _, cfg, params = _moe_params()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 16, 32)).astype(np.float32))
    out, _ = TM.moe_apply(_t(params), x, cfg)
    assert bool(torch.all(torch.linalg.vector_norm(out.reshape(-1, 32), dim=-1) > 0))


def test_moe_aux_loss_balanced_at_uniform_routing():
    _, cfg, params = _moe_params()
    params["router"] = np.zeros_like(params["router"])
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 16, 32)).astype(np.float32))
    _, aux = TM.moe_apply(_t(params), x, cfg)
    assert abs(float(aux) - 1.0) < 0.05


def test_top_k_breaks_ties_like_lax():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]])
    vals, idx = TM.top_k(probs, 2)
    jv, ji = jax.lax.top_k(probs.numpy(), 2)
    assert idx.tolist() == np.asarray(ji).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 2.0])
def test_moe_apply_matches_reference(dtype, capacity_factor):
    """40 tokens in groups of 16 (the last padded): with factor 1.25 some
    (token, choice) pairs overflow their expert and drop."""
    jcfg, cfg, params = _moe_params(seed=4, moe_capacity_factor=capacity_factor)
    x = np.random.default_rng(5).normal(size=(2, 20, 32)).astype(np.float32)
    w = np.cos(np.arange(32.0)).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe_apply(p, x.astype(dtype), jcfg)
        return jnp.sum(out.astype(jnp.float32) * w) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    out, aux = TM.moe_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    (torch.sum(out.float() * torch.from_numpy(w)) + aux).backward()
    bound = MOE_F32_REL if dtype == "float32" else MOE_BF16_REL
    assert out.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    assert _rel(out.detach().float(), np.asarray(jout, np.float32)) <= bound
    assert abs(float(aux) - float(jaux)) <= bound * abs(float(jaux))
    for k in params:
        assert _rel(tp[k].grad, jgrads[k]) <= bound, (k, _rel(tp[k].grad, jgrads[k]))


# ---------------------------------------------------------------------------
# whole models: mixtral (MoE) and qwen1.5 (QKV bias)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen1_5_110b"])
def test_loss_and_gradients_match(arch):
    jcfg = jreg.get_config(arch).reduced()
    jmodel = jreg.build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, 256, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def loss_fn(p):
        return jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})

    options = {"xla_allow_excess_precision": arch != "mixtral_8x22b"}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        params).compile(compiler_options=options)(params)
    tmodel = LM(configs.get_config(arch).reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_np(params)))
    tloss, metrics = tmodel.loss({k: torch.from_numpy(v).long() for k, v in batch.items()})
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-2 * abs(float(jloss))
    assert abs(float(metrics["aux"]) - float(jmetrics["aux"])) <= 1e-2 * max(
        abs(float(jmetrics["aux"])), 1e-6)
    if arch == "mixtral_8x22b":
        assert float(metrics["aux"]) > 0.5  # the MoE layers' mean Switch loss (~1)
    else:
        assert "bq" in tmodel.layers["l0_attn_mlp"]["attn"]
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = ".".join(k.key for k in path)
        tg = tmodel.get_parameter(name).grad
        assert _rel(tg, jg) <= 5e-2, (name, _rel(tg, jg))


def _mixtral_serving(prompt, decode):
    """The reference's reduced mixtral (ring caches: the prompt passes its
    window of 32), its prefill logits and caches, and its teacher-forced
    decode logits and caches, each compiled with excess precision off; and
    the port's model on the same weights."""
    jcfg = jreg.get_config("mixtral_8x22b").reduced()
    jmodel = jreg.build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(1).integers(0, 256, (2, prompt + decode)).astype(np.int32)
    options = {"xla_allow_excess_precision": False}
    head = jnp.asarray(toks[:, :prompt])
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, t, max_seq=SERVE_MAX_SEQ,
                                                   last_only=True)).lower(
        params, head).compile(compiler_options=options)
    logits, caches = jprefill(params, head)
    out = {"prefill": (np.asarray(logits), _np(caches)), "toks": toks, "decode": []}
    one = jnp.asarray(toks[:, :1])
    jdecode = jax.jit(jmodel.decode_step).lower(params, caches, one, jnp.int32(0)).compile(
        compiler_options=options)
    for i in range(decode):
        logits, caches = jdecode(params, caches, jnp.asarray(toks[:, prompt + i:prompt + i + 1]),
                                 jnp.int32(prompt + i))
        out["decode"].append(np.asarray(logits))
    out["caches"] = _np(caches)
    tmodel = LM(configs.get_config("mixtral_8x22b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_np(params)))
    return out, tmodel


def test_mixtral_prefill_and_decode_match_reference():
    """Prefill logits and every cache leaf, then teacher-forced decode
    logits and caches, against the reference compiled with excess precision
    off (see the docstring): ``SERVE_LOGITS_ATOL`` and
    ``test_torch_ssm.check_caches``'s bounds."""
    from test_torch_ssm import check_caches

    prompt, decode = 40, 4
    ref, tmodel = _mixtral_serving(prompt, decode)
    toks = torch.from_numpy(ref["toks"]).long()
    logits, caches = tmodel.prefill(toks[:, :prompt], max_seq=SERVE_MAX_SEQ, last_only=True)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], rtol=0, atol=SERVE_LOGITS_ATOL)
    assert caches["l0_attn_local_moe"].ring
    assert check_caches(caches, ref["prefill"][1]) == 3  # k, v, pos; two groups each
    for i in range(decode):
        logits, caches = tmodel.decode_step(caches, toks[:, prompt + i:prompt + i + 1], prompt + i)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][i], rtol=0,
                                   atol=SERVE_LOGITS_ATOL, err_msg=f"decode step {i}")
    check_caches(caches, ref["caches"])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_chip_moe_choice_check_on_one_layer(capacity_factor):
    """``chip_smoke.moe_decode_vs_forward`` on the reduced mixtral cut to one
    layer: its decoded positions' experts, flips and drops add up, and its
    gap where the experts agree is the card's check, here on the CPU.  At
    factor 0.25 forward's 32-token groups keep 4 slots an expert and drop
    choices that decode's 2-token groups keep."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(configs.get_config("mixtral_8x22b").reduced(), n_layers=1,
                              moe_capacity_factor=capacity_factor)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompt, new = 40, 6
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, prompt + new)))
    with torch.no_grad():
        g = smoke.moe_decode_vs_forward(model, tokens, prompt, prompt + new + 8)
    assert g["all"]["positions"] == 2 * new
    assert g["positions"] + g["flipped"] + g["dropped"] == 2 * new
    assert len(g["margins"]) == g["flipped"]
    if capacity_factor < 1:
        assert g["dropped"] > 0 and g["all"]["rel"] > smoke.SERVE_LOGITS_REL
    else:
        assert g["positions"] == 2 * new
    if g["positions"]:
        assert g["rel"] <= smoke.SERVE_LOGITS_REL


def test_qkv_bias_enters_before_rope():
    """project_qkv with biases against the reference's, on the same inputs."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA

    rng = np.random.default_rng(6)
    p = {"wq": rng.normal(size=(16, 4, 8)), "wk": rng.normal(size=(16, 2, 8)),
         "wv": rng.normal(size=(16, 2, 8)), "bq": rng.normal(size=(4, 8)),
         "bk": rng.normal(size=(2, 8)), "bv": rng.normal(size=(2, 8))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    pos = np.arange(3, 8)
    want = JA.project_qkv({k: jnp.asarray(v) for k, v in p.items()}, x, x, q_positions=pos,
                          kv_positions=pos, rope_theta=1e6)
    got = TA.project_qkv({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                         torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(pos), 1e6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the CLIs and the card's recorded cache shapes
# ---------------------------------------------------------------------------


def test_train_cli_runs_hymba_compressed_with_error_feedback():
    result = train_cli.main(["--arch", "hymba_1_5b", "--reduced", "--device", "cpu",
                             "--mode", "compressed_dp", "--error-feedback", "--steps", "2",
                             "--batch", "2", "--seq", "24"])
    losses = [row["loss"] for row in result["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert result["state"]["residual"].abs().sum() > 0


def test_serve_cli_runs_xlstm():
    result = serve_cli.main(["--arch", "xlstm_1_3b", "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "6", "--new-tokens", "3"])
    assert result["tokens"].shape == (2, 9)
    assert result["config"].layer_pattern()[-1] == "slstm"


@pytest.mark.parametrize("label", ["serve-hymba", "serve-xlstm"])
def test_chip_serve_cache_table_is_the_references(label):
    """``chip_smoke.SERVE_CACHE_SHAPES`` (each cache leaf's shape at the
    serve phase's batch and length, which the card holds the port to) is
    the reference's ``init_caches``, and the port's on the meta device."""
    from repro.models.transformer import LM as JLM

    smoke = _chip_smoke()
    arch = smoke.SERVE_ARCH[label]
    batch, prompt, new = smoke.SERVE_SHAPES[label]
    max_seq = smoke.serve_max_seq(label)
    assert max_seq == prompt + new + 8
    want = smoke.SERVE_CACHE_SHAPES[label]
    jcfg = jreg.get_config(arch)
    assert smoke.cache_shapes(jax.eval_shape(lambda: JLM(jcfg).init_caches(batch, max_seq))) \
        == want
    model = LM(configs.get_config(arch), device="meta")
    assert smoke.cache_shapes(model.init_caches(batch, max_seq)) == want
