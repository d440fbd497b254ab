"""Sharded serving (``serve.engine.Engine(model, config, mesh=, fsdp=)``)
over 4 gloo CPU ranks on ``(1, 4)`` and ``(2, 2)`` ``("data", "model")``
meshes, against the reference on the same weights (``convert.params_from_jax``,
rounded to bf16 first: the sharded engine keeps its blocks in bf16, as the
reference's serving cells place them).

Models: reduced gemma2 (a local layer's ring of 32 slots and a global
layer, the 40-token prompt past the window), hymba, xlstm (16 layers), a
MoE (mixtral, its router at ``ROUTER_SCALE`` times the init scale, ROADMAP
§3 fault 14) and gemma2 with FSDP; gemma2 at batch 1 on both meshes, where
``model`` lands on the KV heads (``(2, 2)``: the heads the plan splits) or
on head_dim (``(1, 4)``), the sequence on ``data``.  Every layout
``cache_pspecs`` gives these caches is read: the sequence split over
``model`` (split-KV), the heads and head_dim splits, the SSM's and the
mLSTM's state in place over ``d_inner``, and the gathered layouts.

* prefill logits and teacher-forced decode logits against the reference
  compiled with ``xla_allow_excess_precision`` off, at
  ``test_torch_serve.py``'s ``LOGITS_ATOL``;
* each rank's cache leaves after prefill and decode equal its
  ``cache_pspecs`` block of the port's unsharded caches, both computing in
  f32 (``chip_smoke.compute_dtype``): relative L2 within ``CACHE_REL``
  (xlstm's within ``XLSTM_CACHE_REL``; the conv tails, which are rounded
  to bf16, within a bf16 ulp);
* seamless and llama-vision (``CROSS_CASES``), whose cross caches hold the
  memory's K/V, against the port's unsharded model in f32: logits and
  every cache block;
* greedy generation gives the reference's tokens (the reference's greedy
  loop, ``Engine.generate``'s, on the compiled prefill and decode), except
  where the reference's top-2 margin is under ``LOGITS_ATOL``: there the
  port's token is one of its two and the comparison stops.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import REPO
from repro.models import registry as jreg

LOGITS_ATOL = 5e-2
CACHE_REL = 1e-6
# xlstm's 16 recurrent layers carry the split sums' f32 rounding (the
# mLSTM's reduced gate products, exponentiated) into C: 2.7e-6 measured
XLSTM_CACHE_REL = 5e-6
BF16_REL = 2.0 ** -8
GAP_F32 = 1e-5
ROUTER_SCALE = 50.0
MAX_SEQ, PROMPT, DECODE, NEW = 64, 40, 4, 6
MODELS = ("gemma2_2b", "hymba_1_5b", "xlstm_1_3b", "mixtral_8x22b")
# name -> (arch, mesh shape, batch, fsdp)
CASES = {
    "gemma2_1x4": ("gemma2_2b", (1, 4), 2, False),
    "gemma2_2x2": ("gemma2_2b", (2, 2), 2, False),
    "gemma2_b1_2x2": ("gemma2_2b", (2, 2), 1, False),
    "gemma2_b1_1x4": ("gemma2_2b", (1, 4), 1, False),
    "gemma2_fsdp_2x2": ("gemma2_2b", (2, 2), 2, True),
    "hymba_1x4": ("hymba_1_5b", (1, 4), 2, False),
    "hymba_2x2": ("hymba_1_5b", (2, 2), 2, False),
    "xlstm_2x2": ("xlstm_1_3b", (2, 2), 2, False),
    "mixtral_2x2": ("mixtral_8x22b", (2, 2), 2, False),
}
# the cross-attention kinds, held against the port's unsharded model in f32
# (their caches over the memory, written at prefill, read by decode)
CROSS_CASES = {
    "seamless_1x4": ("seamless_m4t_large_v2", (1, 4), 2, False),
    "seamless_b1_2x2": ("seamless_m4t_large_v2", (2, 2), 1, False),
    "vision_2x2": ("llama3_2_vision_11b", (2, 2), 2, False),
}

_WORKER = r"""
import dataclasses, json, sys, warnings
warnings.simplefilter("ignore")
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(sys.argv[4])
sys.path.insert(0, sys.argv[5])
cross = json.loads(sys.argv[6])
from chip_smoke import compute_dtype
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM, registry
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import build_decode_step, build_prefill_step
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", rank=rank, world_size=4)
MAX_SEQ, PROMPT, DECODE, NEW = {consts}


def leaves(c):
    if isinstance(c, tuple):
        return [t for x in c for t in leaves(x)]
    return [(f.name, getattr(c, f.name)) for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)]


def rel(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


out = {{}}
for name, (arch, shape, batch, fsdp) in cases.items():
    weights = np.load(f"{{path}}.{{arch}}.npz")
    model = LM(configs.get_config(arch).reduced(), device="cpu")
    model.load_state_dict(convert.params_from_jax({{k: weights[k] for k in weights.files}}))
    mesh = make_local_mesh(tuple(shape), ("data", "model"), device="cpu")
    toks = torch.from_numpy(np.load(f"{{path}}.tokens.{{batch}}.npy")).long()
    res = {{}}
    for f32 in (False, True):
        with (compute_dtype(torch.float32) if f32 else torch.no_grad()):
            prefill = build_prefill_step(model, MAX_SEQ, mesh=mesh, fsdp=fsdp)
            place = prefill.placement
            decode = build_decode_step(model, mesh=place)
            rows = place.rows(toks, batch)
            logits, caches = prefill({{"tokens": rows[:, :PROMPT]}}, global_batch=batch)
            got = [place.all_rows(logits, batch)]
            for i in range(DECODE):
                logits, caches = decode(caches, rows[:, PROMPT + i:PROMPT + i + 1], PROMPT + i,
                                        global_batch=batch, max_seq=MAX_SEQ)
                got.append(place.all_rows(logits, batch))
            if not f32:
                res["logits"] = torch.cat(got, dim=1).float().numpy().tolist()
                continue
            # the unsharded port in f32 on the same (bf16-valued) weights
            _, whole = model.prefill(toks[:, :PROMPT], max_seq=MAX_SEQ, last_only=True)
            for i in range(DECODE):
                _, whole = model.decode_step(whole, toks[:, PROMPT + i:PROMPT + i + 1], PROMPT + i)
            specs = place.cache_specs(batch, MAX_SEQ, None)
            mine = place.local_caches(whole, specs)
            res["cache_rel"] = {{f"{{key}}.{{n}}": rel(a, b)
                                for key in caches for (n, a), (_, b) in
                                zip(leaves(caches[key]), leaves(mine[key]))}}
            res["k_specs"] = {{key: [str(a) for a in (s[0] if isinstance(s, tuple) else s).k]
                              for key, s in specs.items()
                              if hasattr(s[0] if isinstance(s, tuple) else s, "k")}}
    engine = Engine(model, ServeConfig(max_seq=MAX_SEQ), mesh=mesh, fsdp=fsdp)
    res["generate"] = engine.generate(toks[:, :PROMPT], NEW).numpy().tolist()
    res["split"] = {{b: [k for k, v in vars(t).items() if v is True]
                    for b, t in engine.placement.tp.blocks.items()}}
    out[name] = res
for name, (arch, shape, batch, fsdp) in cross.items():
    cfg = configs.get_config(arch).reduced()
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in model.leaves().items():
            if k.endswith("cross_gate"):
                p.fill_(0.5)  # an open gate: the cross block moves the logits
            p.copy_(p.to(torch.bfloat16).float())
    mesh = make_local_mesh(tuple(shape), ("data", "model"), device="cpu")
    toks = torch.from_numpy(np.load(f"{{path}}.tokens.{{batch}}.npy")).long()
    front = registry.make_batch(cfg, batch, PROMPT,
                                generator=torch.Generator().manual_seed(2))["frontend"]
    with compute_dtype(torch.float32):
        prefill = build_prefill_step(model, MAX_SEQ, mesh=mesh, fsdp=fsdp)
        place = prefill.placement
        decode = build_decode_step(model, mesh=place)
        rows = place.rows(toks, batch)
        batch_in = {{"tokens": rows[:, :PROMPT], "frontend": place.rows(front, batch)}}
        logits, caches = prefill(batch_in, global_batch=batch)
        got = [place.all_rows(logits, batch)]
        for i in range(DECODE):
            logits, caches = decode(caches, rows[:, PROMPT + i:PROMPT + i + 1], PROMPT + i,
                                    global_batch=batch, max_seq=MAX_SEQ,
                                    memory_len=front.shape[1])
            got.append(place.all_rows(logits, batch))
        memory = model.frontend_memory(front)
        wl, whole = model.prefill(toks[:, :PROMPT], memory=memory, max_seq=MAX_SEQ,
                                  last_only=True)
        want = [wl]
        for i in range(DECODE):
            wl, whole = model.decode_step(whole, toks[:, PROMPT + i:PROMPT + i + 1], PROMPT + i)
            want.append(wl)
        specs = place.cache_specs(batch, MAX_SEQ, front.shape[1])
        mine = place.local_caches(whole, specs)
        out[name] = {{"gap": float((torch.cat(got, 1) - torch.cat(want, 1)).abs().max()),
                     "cache_rel": {{f"{{key}}.{{n}}": rel(a, b) for key in caches
                                   for (n, a), (_, b) in zip(leaves(caches[key]),
                                                             leaves(mine[key]))}}}}
with open(f"{{path}}.port.{{rank}}.json", "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16).astype(jnp.float32),
                                  tree)


def _reference(arch, params, toks):
    """The reference's prefill and teacher-forced decode logits, and its
    greedy loop's tokens and per-step logits, compiled with excess
    precision off."""
    jmodel = jreg.build(jreg.get_config(arch).reduced())
    opts = {"xla_allow_excess_precision": False}
    head = jnp.asarray(toks[:, :PROMPT])
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, t, max_seq=MAX_SEQ, last_only=True)).lower(
        params, head).compile(compiler_options=opts)
    logits, caches0 = prefill(params, head)
    one = jnp.asarray(toks[:, :1])
    decode = jax.jit(jmodel.decode_step).lower(params, caches0, one, jnp.int32(0)).compile(
        compiler_options=opts)
    out, caches = [np.asarray(logits)], caches0
    for i in range(DECODE):
        logits, caches = decode(params, caches, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
                                jnp.int32(PROMPT + i))
        out.append(np.asarray(logits))
    logits, caches = prefill(params, head)
    gen, steps = [], [np.asarray(logits)[:, -1]]
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for i in range(NEW):
        gen.append(np.asarray(tok))
        if i == NEW - 1:
            break
        logits, caches = decode(params, caches, tok, jnp.int32(PROMPT + i))
        steps.append(np.asarray(logits)[:, -1])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return {"logits": np.concatenate(out, axis=1), "generate": np.concatenate(gen, axis=1),
            "steps": np.stack(steps, axis=1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve_sharded") / "x")
    params = {}
    for i, arch in enumerate(MODELS):
        p = jreg.build(jreg.get_config(arch).reduced()).init(jax.random.PRNGKey(i))
        if arch == "mixtral_8x22b":
            p = jax.tree_util.tree_map_with_path(
                lambda kp, v: v * ROUTER_SCALE if kp[-1].key == "router" else v, p)
        params[arch] = _bf16(p)
        np.savez(f"{path}.{arch}.npz", **_flat(_np(params[arch])))
    toks = {b: np.random.default_rng(b).integers(0, 256, (b, PROMPT + DECODE)).astype(np.int32)
            for b in (1, 2)}
    for b, t in toks.items():
        np.save(f"{path}.tokens.{b}.npy", t)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    code = _WORKER.format(consts=repr((MAX_SEQ, PROMPT, DECODE, NEW)))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), str(port), path,
                               json.dumps(CASES), REPO, json.dumps(CROSS_CASES)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    ref = {(arch, b): _reference(arch, params[arch], toks[b]) for arch, _, b, _ in
           CASES.values()}
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    port_out = [json.load(open(f"{path}.port.{rank}.json")) for rank in range(4)]
    return ref, port_out


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_logits_match_reference(runs, name):
    ref, port = runs
    arch, _, b, _ = CASES[name]
    want = ref[(arch, b)]["logits"]
    for rank in range(4):  # every rank holds every row's logits
        got = np.asarray(port[rank][name]["logits"])
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_are_their_placements_slices(runs, name):
    _, port = runs
    bound = XLSTM_CACHE_REL if CASES[name][0] == "xlstm_1_3b" else CACHE_REL
    for rank in range(4):
        errs = port[rank][name]["cache_rel"]
        assert errs
        for leaf, err in errs.items():
            # the conv tails are rounded to bf16 whatever the compute dtype:
            # an f32 difference may round them a bf16 ulp apart
            assert err <= (BF16_REL if leaf.endswith(".conv") else bound), (rank, leaf, err)


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_generate_matches_reference(runs, name):
    ref, port = runs
    arch, _, b, _ = CASES[name]
    r = ref[(arch, b)]
    got = np.asarray(port[0][name]["generate"])
    assert all(port[k][name]["generate"] == port[0][name]["generate"] for k in range(4))
    assert got.shape == (b, PROMPT + NEW)
    for row in range(b):
        for t in range(NEW):
            if got[row, PROMPT + t] == r["generate"][row, t]:
                continue
            top2 = np.argsort(r["steps"][row, t])[-2:]
            margin = r["steps"][row, t, top2[1]] - r["steps"][row, t, top2[0]]
            assert margin < LOGITS_ATOL and got[row, PROMPT + t] in top2, (row, t, margin)
            break


@pytest.mark.parametrize("name", list(CROSS_CASES))
def test_cross_attention_kinds_against_the_unsharded_port(runs, name):
    """seamless (the encoder's memory) and llama-vision (its patches, the
    gate opened) serve sharded as the unsharded port does, in f32: the
    logits within ``GAP_F32``, every cache leaf (the cross caches too)
    within ``CACHE_REL`` of its block."""
    _, port = runs
    for rank in range(4):
        got = port[rank][name]
        assert got["gap"] <= GAP_F32, (rank, got["gap"])
        assert got["cache_rel"] and max(got["cache_rel"].values()) <= CACHE_REL, (rank, got)


def test_layouts(runs):
    """The placements these cases exercise: the sequence over ``model``
    at batch 2; at batch 1 the sequence over ``data`` and ``model`` on the
    KV heads (``(2, 2)``, split by the plan too) or on head_dim
    (``(1, 4)``); the SSM and mLSTM states split as the plan splits them."""
    _, port = runs
    k = port[0]
    assert k["gemma2_2x2"]["k_specs"]["l1_attn_mlp"] == ["None", "data", "model", "None", "None"]
    assert k["gemma2_b1_2x2"]["k_specs"]["l1_attn_mlp"] == ["None", "None", "data", "model",
                                                            "None"]
    assert k["gemma2_b1_1x4"]["k_specs"]["l1_attn_mlp"] == ["None", "None", "data", "None",
                                                            "model"]
    assert "heads" in k["gemma2_b1_2x2"]["split"]["layers.l1_attn_mlp.attn"]
    assert "inner" in k["hymba_1x4"]["split"]["layers.l0_hybrid.ssm"]
    assert "inner" in k["xlstm_2x2"]["split"]["layers.l0_mlstm.cell"]

