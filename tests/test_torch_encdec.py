"""Port parity of cross-attention and the encoder-decoder: seamless_m4t's
``dec_cross_mlp`` decoder over its encoder's memory, and llama-vision's
``cross_attn_mlp`` layers over the frontend's patches, against the
reference at ``reduced()`` size; the frontend through the data stream, the
train step over two gloo workers, the engine and both CLIs.

Every parity test runs with ``cross_gate`` = ``GATE`` (0.5) in the weights
both packages receive: at its init value, zero, ``tanh(0)`` takes the cross
path out of the logits and every ``cross.*`` gradient is exactly zero
(``test_cross_gate_at_zero_blocks_the_cross_gradients``).

Tolerances, each with its reason:

* The reference's loss, gradients and encoder run compiled with
  ``xla_allow_excess_precision`` off, which rounds every bf16 intermediate
  as the port's eager ops do (``tests/test_torch_zoo.py``'s mixtral).
  With it on, seamless's encoder gradients sit 4.4e-2 from the port's
  (XLA keeps the bf16 products of the tiny N(0, 0.02) frames in f32);
  with it off, 8.6e-4.
* Loss within ``LOSS_REL`` = 1e-2 relative and every gradient leaf within
  ``GRAD_REL`` = 5e-2 relative L2, as qwen1.5 in ``tests/test_torch_zoo.py``
  (measured: seamless's loss bitwise and leaves at most 8.6e-4; vision's
  loss 5e-5 and leaves at most 1.8e-2) -- but for ``cross_gate``, a scalar
  a group whose gradient is a sum over every (row, position, width)
  product that cancels to a few thousandths of its terms: each package's
  bf16 rounding moves it by several percent.  It is held against the
  port's own model run in f32 (the bf16 casts taken out) within
  ``GRAD_REL``, where the reference's bf16 value is farther from that f32
  value than the port's (measured 2.7% and 6.2%).
* The encoder's output (bf16) within ``MEMORY_REL`` = 1e-2 relative L2.
* Prefill and teacher-forced decode logits within ``LOGITS_ATOL`` = 5e-2
  absolute and every cache leaf within ``test_torch_ssm.check_caches``'s
  bounds (positions exactly), as ``tests/test_torch_serve.py`` holds
  gemma2; the cross caches as long as the memory (seamless: the prompt's
  20 frames, where its reduced ``init_caches`` allots 16 slots).
* Greedy tokens: ``tests/test_torch_serve.py``'s rule (equal, except
  after a step where the reference's top-2 margin is under
  ``LOGITS_ATOL``).
* Two gloo workers, each on its own rows of a frontend batch, against one
  process on their rows together: loss within 1e-5 relative (the mean of
  two halves against the mean of the whole), and under ``pjit`` the
  gradient norm within 1e-3.
"""

import dataclasses
import importlib.util
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO
from repro.models import registry as jreg
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.data import SyntheticStream
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, attention as TA, registry as treg
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from test_torch_ssm import check_caches

ARCHS = ("seamless_m4t_large_v2", "llama3_2_vision_11b")
SEQ = 24  # training tokens (seamless: as many audio frames)
PROMPT, NEW, MAX_SEQ = 20, 6, 40
GATE = 0.5
LOSS_REL, GRAD_REL, MEMORY_REL, LOGITS_ATOL = 1e-2, 5e-2, 1e-2, 5e-2
OPTIONS = {"xla_allow_excess_precision": False}


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


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTIONS)


def _ref_one(arch, seed):
    """The reference's outputs for one arch: loss and gradients, encoder
    output, and serving (greedy tokens; prefill logits and caches; the
    decode logits and caches along its own tokens)."""
    jcfg = jreg.get_config(arch).reduced()
    jmodel = jreg.build(jcfg)
    params = jax.tree_util.tree_map(lambda a: np.array(a), jmodel.init(jax.random.PRNGKey(seed)))
    for layer in params["layers"].values():
        if "cross_gate" in layer:
            layer["cross_gate"][...] = GATE
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (2, SEQ + 1)).astype(np.int32)
    frontend = (rng.normal(size=(2, jreg._frontend_len(jcfg, SEQ), jcfg.d_model))
                * 0.02).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "frontend": frontend}
    out = {"params": params, "batch": batch}

    def loss_fn(p, b):
        return jmodel.loss(p, b)[0]

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = _compiled(jax.value_and_grad(loss_fn), params, jbatch)(params, jbatch)
    out["loss"], out["grads"] = float(loss), _np(grads)
    if jcfg.n_encoder_layers:
        out["memory"] = np.asarray(_compiled(jmodel.encode, params, jbatch["frontend"])(
            params, jbatch["frontend"]).astype(jnp.float32))

    prompts = rng.integers(0, 256, (2, PROMPT)).astype(np.int32)
    serve_front = (rng.normal(size=(2, jreg._frontend_len(jcfg, PROMPT), jcfg.d_model))
                   * 0.02).astype(np.float32)
    engine = JEngine(jmodel, params, JServeConfig(max_seq=MAX_SEQ))
    tokens = np.asarray(engine.generate(jnp.asarray(prompts), NEW, frontend=serve_front))
    logits, caches = engine._prefill(params, {"tokens": jnp.asarray(prompts),
                                              "frontend": jnp.asarray(serve_front)})
    out["prefill"] = (np.asarray(logits), _np(caches))
    stepped = [np.asarray(logits)]
    for i in range(NEW - 1):
        logits, caches = engine._decode(params, caches,
                                        jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
                                        jnp.int32(PROMPT + i))
        stepped.append(np.asarray(logits))
    out.update(prompts=prompts, serve_frontend=serve_front, tokens=tokens, stepped=stepped,
               caches=_np(caches))
    return out


@pytest.fixture(scope="module")
def ref():
    return {arch: _ref_one(arch, seed) for seed, arch in enumerate(ARCHS)}


def _model(ref, arch) -> LM:
    model = LM(configs.get_config(arch).reduced(), device="cpu")
    model.load_state_dict(convert.params_from_jax(ref[arch]["params"]))
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def test_encode_matches(ref):
    """seamless's encoder alone: bidirectional self attention with rope over
    the bf16 frames, the MLP, the final norm."""
    model = _model(ref, ARCHS[0])
    with torch.no_grad():
        memory = model.encode(torch.from_numpy(ref[ARCHS[0]]["batch"]["frontend"]))
    assert memory.dtype == torch.bfloat16 and memory.shape == (2, SEQ, 64)
    assert _rel(memory.float(), ref[ARCHS[0]]["memory"]) <= MEMORY_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(ref, arch):
    model = _model(ref, arch)
    loss, metrics = model.loss(_tbatch(ref[arch]["batch"]))
    loss.backward()
    want = ref[arch]["loss"]
    assert abs(float(loss.detach()) - want) <= LOSS_REL * abs(want)
    assert float(metrics["aux"]) == 0.0
    grads = jax.tree_util.tree_flatten_with_path(ref[arch]["grads"])[0]
    assert len(grads) == len(list(model.parameters()))
    names = set()
    for path, jg in grads:
        name = ".".join(k.key for k in path)
        names.add(name)
        tg = model.get_parameter(name).grad
        assert tg is not None and tuple(tg.shape) == jg.shape, name
        if name.endswith("cross_gate"):
            continue  # held against the f32 model below
        assert _rel(tg, jg) <= GRAD_REL, (name, _rel(tg, jg))
    if arch == ARCHS[0]:
        assert {"encoder.attn.wq", "encoder_norm.scale",
                "layers.l0_dec_cross_mlp.cross.wk",
                "layers.l0_dec_cross_mlp.norm_cross.scale"} <= names
    else:
        assert {"layers.l4_cross_attn_mlp.cross_gate", "layers.l4_cross_attn_mlp.cross.wv"} <= names
        assert "layers.l4_cross_attn_mlp.attn.wq" not in names  # no self attention


def test_cross_gate_gradient_against_f32(ref, monkeypatch):
    """llama-vision's ``cross_gate`` gradient (see the docstring): the port's
    within ``GRAD_REL`` of its own model in f32, and nearer that value than
    the reference's."""
    arch = ARCHS[1]
    name = "layers.l4_cross_attn_mlp.cross_gate"
    batch = _tbatch(ref[arch]["batch"])
    model = _model(ref, arch)
    model.loss(batch)[0].backward()
    bf16 = model.get_parameter(name).grad.clone()
    monkeypatch.setattr(T, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(T, "embed", lambda table, tokens, tp=None: torch.nn.functional.embedding(
        tokens, table))
    model.zero_grad()
    model.loss(batch)[0].backward()
    f32 = model.get_parameter(name).grad
    want = ref[arch]["grads"]["layers"]["l4_cross_attn_mlp"]["cross_gate"]
    assert float(f32.abs().min()) > 0
    assert _rel(bf16, f32) <= GRAD_REL, _rel(bf16, f32)
    assert _rel(bf16, f32) <= _rel(want, f32), (_rel(bf16, f32), _rel(want, f32))


def test_cross_gate_at_zero_blocks_the_cross_gradients():
    """At init ``cross_gate`` is zero: the cross path adds nothing, so every
    ``cross.*`` gradient is exactly zero while the gate's is not (what the
    card's ``train-vision`` phase holds across its first two steps)."""
    cfg = configs.get_config(ARCHS[1]).reduced()
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = treg.make_batch(cfg, 2, 12, generator=torch.Generator().manual_seed(1))
    model.loss(batch)[0].backward()
    grads = model.leaves()
    cross = {k: p.grad for k, p in grads.items() if ".cross." in k}
    assert len(cross) == 4 and all(not g.any() for g in cross.values())
    assert bool(torch.all(grads["layers.l4_cross_attn_mlp.cross_gate"].grad != 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match(ref, arch):
    model, r = _model(ref, arch), ref[arch]
    engine = Engine(model, ServeConfig(max_seq=MAX_SEQ))
    logits, caches = engine._prefill({"tokens": torch.from_numpy(r["prompts"]).long(),
                                      "frontend": torch.from_numpy(r["serve_frontend"])})
    want_logits, want_caches = r["prefill"]
    assert logits.shape == (2, 1, 256)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=LOGITS_ATOL)
    memory = r["serve_frontend"].shape[1]
    if arch == ARCHS[0]:
        self_kv, cross = caches["l0_dec_cross_mlp"]
        assert self_kv.k.shape == (2, 2, MAX_SEQ, 2, 16)
        # the prompt's 20 frames, where init_caches allots n_frontend_tokens (16)
        assert cross.k.shape == (2, 2, memory, 2, 16) and memory == PROMPT != 16
        assert model.init_caches(2, MAX_SEQ)["l0_dec_cross_mlp"][1].k.shape[2] == 16
        assert check_caches(caches, want_caches) == 6
    else:
        assert caches["l4_cross_attn_mlp"].k.shape == (2, 2, memory, 2, 16) and memory == 16
        assert check_caches(caches, want_caches) == 15
    assert torch.equal(caches[[k for k in caches if "cross" in k][0]][-1].pos[0]
                       if arch == ARCHS[0] else caches["l4_cross_attn_mlp"].pos[0],
                       torch.arange(memory, dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_teacher_forced_matches(ref, arch):
    """Along the reference's greedy tokens: each step's logits, then every
    cache leaf (the cross caches read, not written)."""
    model, r = _model(ref, arch), ref[arch]
    memory = model.frontend_memory(torch.from_numpy(r["serve_frontend"]))
    tokens = torch.from_numpy(np.array(r["tokens"])).long()
    logits, caches = model.prefill(tokens[:, :PROMPT], memory=memory, max_seq=MAX_SEQ,
                                   last_only=True)
    for i in range(NEW - 1):
        logits, caches = model.decode_step(caches, tokens[:, PROMPT + i:PROMPT + i + 1],
                                           PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), r["stepped"][i + 1], rtol=0,
                                   atol=LOGITS_ATOL, err_msg=f"decode step {i}")
    check_caches(caches, r["caches"])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_with_frontend_matches(ref, arch):
    model, r = _model(ref, arch), ref[arch]
    out = Engine(model, ServeConfig(max_seq=MAX_SEQ)).generate(
        torch.from_numpy(r["prompts"]), NEW,
        frontend=torch.from_numpy(r["serve_frontend"])).numpy()
    want = r["tokens"]
    assert out.shape == want.shape == (2, PROMPT + NEW)
    np.testing.assert_array_equal(out[:, :PROMPT], r["prompts"])
    for b in range(2):
        for t in range(PROMPT, PROMPT + NEW):
            if out[b, t] == want[b, t]:
                continue
            dist_ = r["stepped"][t - PROMPT][b, -1]
            top2 = np.argsort(dist_)[-2:]
            margin = dist_[top2[1]] - dist_[top2[0]]
            assert margin < LOGITS_ATOL and out[b, t] in top2, (b, t, margin)
            break


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_convert(ref, arch):
    """``params_from_jax`` covers the encoder, the cross blocks and the gate
    (every leaf, path and shape); ``caches_from_jax`` the cross KVCache and
    ``dec_cross_mlp``'s (self, cross) pair."""
    r = ref[arch]
    state = convert.params_from_jax(r["params"])
    model = _model(ref, arch)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    for name, t in state.items():
        assert torch.equal(model.get_parameter(name).detach(), t), name
    caches = convert.caches_from_jax(r["prefill"][1])
    if arch == ARCHS[0]:
        pair = caches["l0_dec_cross_mlp"]
        assert isinstance(pair, tuple) and all(isinstance(c, TA.KVCache) for c in pair)
        assert pair[1].k.dtype == torch.bfloat16 and not pair[1].ring
        assert int(pair[1].pos[0, -1]) == PROMPT - 1
    else:
        assert isinstance(caches["l4_cross_attn_mlp"], TA.KVCache)
    assert convert.params_to_jax(state).keys() == r["params"].keys()


def test_memory_is_required():
    model = LM(configs.get_config(ARCHS[1]).reduced(), device="cpu")
    batch = treg.make_batch(model.cfg, 1, 4, generator=torch.Generator().manual_seed(0))
    del batch["frontend"]
    with pytest.raises(ValueError, match="frontend"):
        model.loss(batch)
    with pytest.raises(ValueError, match="memory"):
        model.prefill(batch["tokens"])


def test_stream_emits_each_hosts_frontend():
    """The CLI's stream for each arch: seamless's frames as long as the
    sequence, vision's ``n_frontend_tokens`` patches; tokens unchanged by
    the frontend (drawn after them); each host its own rows."""
    for arch, length in zip(ARCHS, (SEQ, 16)):
        cfg = configs.get_config(arch).reduced()
        sc = train_cli.stream_config(cfg, SEQ, 4, seed=3)
        stream = SyntheticStream(sc)
        whole = stream.batch_at(2)
        assert whole["frontend"].shape == (4, length, 64) and whole["frontend"].dtype == torch.float32
        assert 0.015 < float(whole["frontend"].std()) < 0.025
        plain = SyntheticStream(dataclasses.replace(sc, frontend_dim=0, frontend_len=0))
        assert torch.equal(plain.batch_at(2)["tokens"], whole["tokens"])
        assert "frontend" not in plain.batch_at(2)
        halves = [stream.batch_at(2, host_index=h, num_hosts=2) for h in range(2)]
        assert all(h["frontend"].shape == (2, length, 64) for h in halves)
        assert not torch.equal(halves[0]["frontend"], halves[1]["frontend"])
        assert torch.equal(stream.batch_at(2, 1, 2)["frontend"], halves[1]["frontend"])
    assert train_cli.stream_config(configs.get_config("gemma2_2b"), SEQ, 4, 0).frontend_dim == 0


_WORKER = r"""
import sys, json
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.data import SyntheticStream
from repro_torch.launch import train as train_cli
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state
rank, world, port, arch, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                 sys.argv[5])
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
cfg = configs.get_config(arch).reduced()
model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    for name, p in model.named_parameters():
        if name.endswith("cross_gate"):
            p.fill_(0.5)
stream = SyntheticStream(train_cli.stream_config(cfg, 12, 4, seed=5))
if world > 1:
    batch = stream.batch_at(0, host_index=rank, num_hosts=world)
else:  # both hosts' rows in one batch
    halves = [stream.batch_at(0, host_index=h, num_hosts=2) for h in range(2)]
    batch = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
opt = OptConfig(kind="adamw", lr=1e-3)
reducer = ReducerConfig(kind="fft", theta=0.7) if mode == "compressed_dp" else None
state = init_state(model, opt)
step = build_train_step(model, opt, StepConfig(mode=mode, reducer=reducer))
m = step(state, batch)
print("METRICS " + json.dumps({"loss": m["loss"], "grad_norm": m["grad_norm"],
                               "front": float(batch["frontend"].sum()),
                               "param": float(model.get_parameter(
                                   "layers.l0_dec_cross_mlp.cross.wq"
                                   if "seamless" in arch else "layers.l4_cross_attn_mlp.cross_gate"
                               ).detach().double().sum())}))
if world > 1:
    dist.destroy_process_group()
"""


def _metrics(out):
    import json

    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("METRICS "))[len("METRICS "):])


@pytest.mark.parametrize("mode", ["pjit", "compressed_dp"])
def test_two_gloo_workers_each_take_their_frontend_rows(mode):
    """One step of 2 gloo workers, each on its own rows (tokens and
    frontend) of a reduced seamless batch, against one process on both
    workers' rows together (see the docstring for the bounds); the workers
    end with equal parameters."""
    arch = ARCHS[0]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), "2", str(port), arch,
                               mode], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    one = subprocess.run([sys.executable, "-c", _WORKER, "0", "1", "0", arch, mode], env=env,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stdout + one.stderr
    outs = []
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
        outs.append(_metrics(log))
    whole = _metrics(one.stdout)
    assert outs[0]["front"] != outs[1]["front"]
    assert abs(outs[0]["front"] + outs[1]["front"] - whole["front"]) <= 1e-4
    for got in outs:
        assert abs(got["loss"] - whole["loss"]) <= 1e-5 * abs(whole["loss"])
        if mode == "pjit":
            assert abs(got["grad_norm"] - whole["grad_norm"]) <= 1e-3 * whole["grad_norm"]
    assert outs[0]["param"] == outs[1]["param"] and outs[0]["grad_norm"] == outs[1]["grad_norm"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs(arch):
    """Compressed (EF) on seamless, the dense default on llama-vision."""
    extra = (["--mode", "compressed_dp", "--error-feedback"] if arch == ARCHS[0] else [])
    result = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "16", *extra])
    losses = [row["loss"] for row in result["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    if extra:
        assert result["state"]["residual"].abs().sum() > 0


def test_n_layers_sets_both_stacks_of_an_encdec_arch():
    result = train_cli.main(["--arch", ARCHS[0], "--reduced", "--n-layers", "1", "--device",
                             "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])
    cfg = result["state"]["model"].cfg
    assert (cfg.n_layers, cfg.n_encoder_layers) == (1, 1)
    assert result["state"]["model"].get_parameter("encoder.attn.wq").shape[0] == 1
    assert treg.with_depth(configs.get_config(ARCHS[1]), 5).n_encoder_layers == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs(arch):
    """The CLI draws the frontend (``registry.frontend_len`` of the prompt)
    after the prompts from its generator; a second call gives the same."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "6", "--new-tokens", "3"]
    result = serve_cli.main(args)
    assert result["tokens"].shape == (2, 9)
    front = result["frontend"]
    assert front.shape == (2, 6 if arch == ARCHS[0] else 16, 64)
    again = serve_cli.main(args)
    assert torch.equal(again["frontend"], front) and torch.equal(again["tokens"],
                                                                  result["tokens"])
    replay = Engine(result["model"], ServeConfig(max_seq=6 + 3 + 8)).generate(
        result["prompts"], 3, frontend=front)
    assert torch.equal(replay, result["tokens"])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_decode_check_with_a_frontend(arch):
    """``chip_smoke.decode_vs_forward`` and ``layerwise_gap`` (the card's
    serving checks) with a frontend, on a reduced model whose gate is open:
    decode along the tokens against one forward over them, over the same
    memory, end to end and layer by layer."""
    smoke = _chip_smoke()
    cfg = configs.get_config(arch).reduced()
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("cross_gate"):
                p.fill_(GATE)
    gen = torch.Generator().manual_seed(1)
    batch = treg.make_batch(cfg, 2, 14, generator=gen)
    gap = smoke.decode_vs_forward(model, batch["tokens"], 10, 24, frontend=batch["frontend"])
    assert gap["positions"] == 8 and gap["rel"] <= smoke.SERVE_LOGITS_REL
    worst = smoke.layerwise_gap(model, batch["tokens"], 10, 24, frontend=batch["frontend"])
    assert worst <= smoke.SERVE_LOGITS_REL


@pytest.mark.parametrize("label", ["serve-seamless", "serve-vision"])
def test_chip_serve_cache_table_is_the_references_prefill(label):
    """``chip_smoke.SERVE_CACHE_SHAPES`` of the frontend archs is the shape of
    the reference's prefill output at the phase's batch, prompt and memory
    (the cross caches as long as the memory), traced abstractly
    (``jax.eval_shape``) with the width cut, which no cache shape depends on;
    and the port's on the meta device."""
    smoke = _chip_smoke()
    arch = smoke.SERVE_ARCH[label]
    batch, prompt, new = smoke.SERVE_SHAPES[label]
    max_seq = smoke.serve_max_seq(label)
    jcfg = dataclasses.replace(jreg.get_config(arch), d_model=64, d_ff=128, vocab_size=256)
    jmodel = jreg.build(jcfg)
    memory = jreg._frontend_len(jcfg, prompt)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    spec = {"tokens": jax.ShapeDtypeStruct((batch, prompt), jnp.int32),
            "frontend": jax.ShapeDtypeStruct((batch, memory, 64), jnp.float32)}
    from repro.serve.engine import build_prefill_step

    _, caches = jax.eval_shape(build_prefill_step(jmodel, None, max_seq), params, spec)
    want = smoke.SERVE_CACHE_SHAPES[label]
    assert smoke.cache_shapes(caches) == want
    model = LM(configs.get_config(arch), device="meta")
    assert smoke.cache_shapes(model.init_caches(batch, max_seq, memory_len=memory)) == want
