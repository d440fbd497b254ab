"""Port parity of serving: the LM's cached prefill and decode, the KV cache,
the engine and the serving CLI, against the reference on reduced gemma2
(``max_seq`` 64, so the local layers' window of 32 makes a ring) through
``convert.params_from_jax`` and ``convert.caches_from_jax``.

Tolerances: logits within ``LOGITS_ATOL`` = 5e-2 absolute (max |logit| is
~1.2 at these weights) and cache k/v within ``REL_L2`` = 1e-2 relative L2
-- both frameworks compute in bf16 (about 3 significant digits) but round
and accumulate its matmuls and the softmax at different places, the model
tests' reason too (``tests/test_torch_model.py``); cache positions, ring
flags and ``update_kv_cache`` on the same values exactly.  Greedy tokens
equal the reference's, except where the reference's top-2 margin at a step
is under ``LOGITS_ATOL``: there the port's token must be one of the
reference's two, and the comparison stops (the sequences then condition on
different prefixes).  Sampling cannot match ``jax.random`` bits, so it is
checked for range and for determinism under one ``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import registry
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, attention as tattn
from repro_torch.serve import Engine, ServeConfig

MAX_SEQ = 64
LOGITS_ATOL = 5e-2
REL_L2 = 1e-2


@pytest.fixture(scope="module")
def pair():
    jcfg = registry.get_config("gemma2_2b").reduced()
    jmodel = registry.build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, t, max_seq=MAX_SEQ, last_only=True))
    jdecode = jax.jit(jmodel.decode_step)
    return jmodel, params, tmodel, jprefill, jdecode


def _prompts(seed, shape=(2, 40)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _jcaches(caches):
    return convert.caches_from_jax(jax.tree_util.tree_map(np.asarray, caches))


def _check_caches(tc, jc):
    assert set(tc) == set(jc)
    for key in tc:
        assert tc[key].ring == jc[key].ring, key
        assert torch.equal(tc[key].pos, jc[key].pos), key
        for leaf in ("k", "v"):
            got, want = getattr(tc[key], leaf), getattr(jc[key], leaf)
            assert got.dtype == want.dtype == torch.bfloat16
            assert _rel(got.float(), want.float()) <= REL_L2, (key, leaf)


def test_prefill_logits_and_caches_match(pair):
    _, params, tmodel, jprefill, _ = pair
    toks = _prompts(0)
    jl, jc = jprefill(params, jnp.asarray(toks))
    tl, tc = tmodel.prefill(torch.from_numpy(toks).long(), max_seq=MAX_SEQ, last_only=True)
    assert tl.shape == (2, 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGITS_ATOL)
    # the prompt (40) is longer than the local layers' ring (32 slots)
    assert tc["l0_attn_local_mlp"].ring and tc["l0_attn_local_mlp"].k.shape[2] == 32
    assert not tc["l1_attn_mlp"].ring and tc["l1_attn_mlp"].k.shape[2] == MAX_SEQ
    _check_caches(tc, _jcaches(jc))


def test_decode_teacher_forced_matches(pair):
    jmodel, params, tmodel, jprefill, jdecode = pair
    toks = _prompts(1)
    # the reference's own greedy tokens, fed to both
    forced = np.asarray(JEngine(jmodel, params, JServeConfig(max_seq=MAX_SEQ)).generate(
        jnp.asarray(toks), 7))[:, 40:]
    _, jc = jprefill(params, jnp.asarray(toks))
    _, tc = tmodel.prefill(torch.from_numpy(toks).long(), max_seq=MAX_SEQ, last_only=True)
    for i in range(6):
        tok = forced[:, i:i + 1].copy()
        jl, jc = jdecode(params, jc, jnp.asarray(tok), jnp.int32(40 + i))
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(tok).long(), 40 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGITS_ATOL,
                                   err_msg=f"decode step {i}")
    _check_caches(tc, _jcaches(jc))
    # positions 40..45 wrapped into ring slots 8..13
    assert tc["l0_attn_local_mlp"].pos[0, 8:14].tolist() == list(range(40, 46))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_reference(pair, seed):
    jmodel, params, tmodel, *_ = pair
    toks = _prompts(10 + seed, (2, 8))
    new = 8
    jout = np.asarray(JEngine(jmodel, params, JServeConfig(max_seq=MAX_SEQ)).generate(
        jnp.asarray(toks), new))
    tout = Engine(tmodel, ServeConfig(max_seq=MAX_SEQ)).generate(
        torch.from_numpy(toks), new).numpy()
    assert tout.shape == jout.shape == (2, 8 + new)
    np.testing.assert_array_equal(tout[:, :8], toks)
    # the reference's distribution at each generated position
    jlogits = np.asarray(jmodel.forward(params, jnp.asarray(jout))[0])
    for b in range(2):
        for t in range(8, 8 + new):
            if tout[b, t] == jout[b, t]:
                continue
            top2 = np.argsort(jlogits[b, t - 1])[-2:]
            margin = jlogits[b, t - 1, top2[1]] - jlogits[b, t - 1, top2[0]]
            assert margin < LOGITS_ATOL and tout[b, t] in top2, (b, t, margin)
            break


@pytest.mark.parametrize("case", ["ring-longer-write", "ring-wrap", "flat"])
def test_update_kv_cache_exact(case):
    seq, window, start, s_new = {"ring-longer-write": (32, 8, 5, 13),
                                 "ring-wrap": (32, 8, 21, 1),
                                 "flat": (16, 0, 3, 5)}[case]
    rng = np.random.default_rng(3)
    k0 = rng.normal(size=(2, min(window, seq) if window else seq, 2, 4)).astype(np.float32)
    kn = rng.normal(size=(2, s_new, 2, 4)).astype(np.float32)
    vn = rng.normal(size=(2, s_new, 2, 4)).astype(np.float32)
    jc = jattn.init_kv_cache(2, seq, 2, 4, window=window, dtype=jnp.float32)
    jc = jattn.KVCache(jnp.asarray(k0), jnp.asarray(-k0), jc.pos, jc.ring)
    tc = tattn.init_kv_cache(2, seq, 2, 4, window=window, dtype=torch.float32)
    tc = tattn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(-k0), tc.pos, tc.ring)
    assert tc.ring == jc.ring == (case != "flat")
    jc = jattn.update_kv_cache(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(start))
    tattn.update_kv_cache(tc, torch.from_numpy(kn), torch.from_numpy(vn), start)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_generate_shapes_and_determinism(pair):
    tmodel = pair[2]
    eng = Engine(tmodel, ServeConfig(max_seq=MAX_SEQ))
    prompts = torch.from_numpy(_prompts(4, (2, 8)))
    out1, out2 = eng.generate(prompts, 6), eng.generate(prompts, 6)
    assert out1.shape == (2, 14) and out1.dtype == torch.int64
    assert torch.equal(out1, out2)
    assert torch.equal(out1[:, :8], prompts.long())


def test_generate_matches_teacher_forcing(pair):
    """Greedy generation replayed through one forward gives the same argmaxes."""
    tmodel = pair[2]
    prompts = torch.from_numpy(_prompts(5, (1, 8)))
    out = Engine(tmodel, ServeConfig(max_seq=MAX_SEQ)).generate(prompts, 5)
    with torch.no_grad():
        logits, _ = tmodel(out)
    for t in range(8, 13):
        assert int(torch.argmax(logits[0, t - 1])) == int(out[0, t]), t


def test_temperature_sampling_with_generator(pair):
    tmodel = pair[2]
    eng = Engine(tmodel, ServeConfig(max_seq=MAX_SEQ, temperature=1.0))
    prompts = torch.from_numpy(_prompts(6, (2, 4)))

    def run(seed):
        return eng.generate(prompts, 4, generator=torch.Generator().manual_seed(seed))

    out = run(7)
    assert out.shape == (2, 8)
    assert bool(((out >= 0) & (out < 256)).all())
    assert torch.equal(out, run(7))
    assert torch.equal(eng.generate(prompts, 4), run(0))  # the default generator: seed 0


def test_serve_cli_standalone_cpu():
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "4", "--seed", "3"]
    result = serve_cli.main(argv)
    out = result["tokens"]
    assert out.shape == (2, 12) and bool(((out >= 0) & (out < 256)).all())
    assert result["timings"]["decode_steps"] == 3
    # weights and prompts come from --seed: a second run serves the same tokens
    assert torch.equal(serve_cli.main(argv)["tokens"], out)
    model = LM(configs.get_config("gemma2_2b").reduced(), device="cpu",
               generator=torch.Generator().manual_seed(3))
    for name, p in model.leaves().items():
        assert torch.equal(p, result["model"].get_parameter(name)), name
