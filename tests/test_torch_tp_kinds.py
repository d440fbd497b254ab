"""Tensor parallelism for every layer kind in the sharded ``pjit`` step
(``models/tensor_parallel.py``'s per-block plan, ``train/step.py``): the
MoE kinds expert-parallel (qwen3-moe, 4 experts over ``model`` 2, under
``remat="full"``, whose backward replays the forward's collectives) and
ff-parallel (mixtral with 3 experts, which 2 does not divide: ``ff``
splits); hymba's ``hybrid`` layer (5 heads, which 2 does not divide:
the attention replicates and the SSM splits over ``d_inner``) and the
xLSTM group are in ``tests/test_torch_tp_kinds_b.py``, seamless's
``dec_cross_mlp`` with its encoder and llama-vision's ``cross_attn_mlp``
in ``tests/test_torch_tp_kinds_c.py``, through the same machinery.  Each case runs with FSDP off and on, the port on 4 gloo
workers and the reference's ``pjit`` on 4 fake CPU devices, both on a
``(2, 2)`` ``("data", "model")`` mesh, from the same parameters and
batches; the reference is compiled with ``xla_allow_excess_precision`` off
(ROADMAP §3 fault 10: by default its bf16 intermediates stay f32 and a
near-uniform router flips top-k choices).  One module fixture runs every
case of both packages once.

Tolerances (those of ``tests/test_torch_sharding.py``):
* against the reference: the loss and the grad norm within 1e-2 relative at
  each step, every parameter's update within 5 * lr of the reference's,
  the whole update within relative L2 0.1 with 99% of its signs equal;
  measured on the CPU over the three files' twelve runs: the loss at most
  7.9e-5 relative, the grad norm 7.8e-4, the update at most 3.94 * lr,
  relative L2 at most 0.076 (qwen3-moe), signs at least 99.7%;
* against the port's own replicated step on the same rows (a flat ``(4,)``
  mesh): the loss within 1e-3 relative and the grad norm within 2e-3, and
  the update as above; measured: at most 1.3e-4 and 6.6e-4 (the model
  axis's partial sums are rounded to bf16 before their f32 sum), the
  update at most 3.77 * lr, relative L2 at most 0.095 (mixtral's MoE, the
  closest to its bound) and at least 99.5% of signs;
* every leaf's local block is bitwise the slice of the full array that its
  placement names, and every rank ends with the same full parameters.

The MoE cases start their routers at ``ROUTER_SCALE`` times the init
scale (ROADMAP §3 fault 14, pinned by ``test_moe_router_at_init_scale``).

The sequence is ``SEQ`` 32 long, which the model axis divides, so the
sharded step also runs the stream between groups sequence-parallel
(``tests/test_torch_seq_parallel.py``), here and in the ``_b`` and ``_c``
files: every output of the port in the three files is bitwise the same
with the stream kept replicated, so no value measured above moved.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO, run_with_devices
from repro_torch.models import sharding as S

LR = 3e-4
WORKERS = 4
STEPS = 2
SEQ = 32
ROWS = 4
# the MoE cases' routers start 50x their init scale (0.02 / sqrt(d)), with
# logits of about unit spread: at init a router is near uniform, and the
# split sums' bf16 rounding flips its near-tied top-k choices (ROADMAP §3
# fault 14), whose gradient then moves AdamW's sign-like first updates far
# more than rounding does; test_moe_router_at_init_scale pins that
ROUTER_SCALE = 50.0
# name -> (arch, config changes on top of reduced(), the parameters' key);
# every case runs on (2, 2) with FSDP off (name) and on (name + "_fsdp")
CASES = {
    "qwen3_ep": ("qwen3_moe_235b_a22b", {"remat": "full"}),
    "mixtral_ff": ("mixtral_8x22b", {"n_experts": 3}),
}
# the block each case must split along, and the flag
SPLITS = {
    "qwen3_ep": {"layers.l0_attn_moe.moe": "experts", "layers.l0_attn_moe.attn": "heads"},
    "mixtral_ff": {"layers.l0_attn_local_moe.moe": "ff",
                   "layers.l0_attn_local_moe.attn": "heads"},
}


def _runs_for(cases, tmp_path_factory, naive=(), init=()):
    """The reference's cases on 4 fake devices (which also draw the initial
    parameters), then the port's on 4 gloo workers: each case sharded with
    FSDP off and on, and replicated on a flat mesh."""
    path = str(tmp_path_factory.mktemp("tp_kinds") / "x")
    np.save(path + ".tokens.npy",
            np.random.default_rng(5).integers(0, 256, (STEPS, ROWS, SEQ + 1)).astype(np.int32))
    out = run_with_devices(_CONFIG + _JAX_WORKERS.format(path=path, cases=json.dumps(cases),
                                                         lr=LR, steps=STEPS,
                                                         router_scale=ROUTER_SCALE),
                           devices=WORKERS)
    assert "JAX_OK" in out
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               str(LR), json.dumps(cases), json.dumps(list(naive)),
                               json.dumps(list(init)), str(ROUTER_SCALE)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORKERS)]
    for p in procs:
        log, _ = p.communicate(timeout=400)
        assert p.returncode == 0, log
    return path


_CONFIG = r"""
import dataclasses
def _config(get_config, arch, changes):
    cfg = get_config(arch).reduced()
    depth = {"xlstm_1_3b": 2, "llama3_2_vision_11b": 5}.get(arch, cfg.n_layers)
    return dataclasses.replace(cfg, n_layers=depth, **changes)
def _frontend(cfg, seq):
    if cfg.frontend == "audio_frames":
        return seq
    return cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
"""

_JAX_WORKERS = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import jaxcompat as compat
from repro.models import registry
from repro.optim import OptConfig
from repro.train import init_state
from repro.train.step import StepConfig, build_train_step
path, cases, lr, steps = {path!r}, json.loads({cases!r}), {lr!r}, {steps!r}
OPTIONS = {{"xla_allow_excess_precision": False}}
ROUTER_SCALE = {router_scale!r}
toks = np.load(path + ".tokens.npy")
opt = OptConfig(kind="adamw", lr=lr)
params0, fronts = {{}}, {{}}
flat = lambda tree: {{".".join(k.key for k in kp): np.asarray(v)
                     for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}
for name, (arch, changes) in cases.items():
    cfg = _config(registry.get_config, arch, changes)
    model = registry.build(cfg)
    state = init_state(jax.random.PRNGKey(1), model, opt)
    # a cross layer's gate starts at zero, which takes its block out of the
    # loss: open it, so the first step reaches the cross block too
    state["params"] = jax.tree_util.tree_map_with_path(
        lambda kp, v: jnp.full_like(v, 0.5) if kp[-1].key == "cross_gate" else
        v * ROUTER_SCALE if kp[-1].key == "router" else v, state["params"])
    params0.update({{name + "." + k: v for k, v in flat(state["params"]).items()}})
    fl = _frontend(cfg, toks.shape[2] - 1)
    if fl:
        fronts[name] = (np.random.default_rng(7).standard_normal(
            (steps, toks.shape[1], fl, cfg.d_model)) * 0.02).astype(np.float32)
    def batch(i):
        b = {{"tokens": jnp.asarray(toks[i, :, :-1]), "targets": jnp.asarray(toks[i, :, 1:])}}
        if name in fronts:
            b["frontend"] = jnp.asarray(fronts[name][i])
        return b
    for fsdp in (False, True):
        mesh = compat.make_auto_mesh((2, 2), ("data", "model"))
        step = build_train_step(model, opt, StepConfig(mode="pjit", fsdp=fsdp), mesh, batch(0))
        # the step donates its state: each run takes a copy
        st = jax.device_put(jax.tree_util.tree_map(jnp.copy, state), step.state_sharding)
        with compat.set_mesh(mesh):
            compiled = step.lower(st, jax.device_put(batch(0), step.batch_sharding)).compile(
                compiler_options=OPTIONS)
        metrics = []
        for i in range(steps):
            with compat.set_mesh(mesh):
                st, m = compiled(st, jax.device_put(batch(i), step.batch_sharding))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        key = name + ("_fsdp" if fsdp else "")
        np.savez(path + f".{{key}}.jax.npz", metrics=np.array(metrics), **flat(st["params"]))
np.savez(path + ".params0.npz", **params0)
np.savez(path + ".frontend.npz", **fronts)
print("JAX_OK")
"""

_PORT_WORKER = _CONFIG + r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM, tensor_parallel
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state
from repro_torch.train.step import state_pspecs
rank, port, path, lr = int(sys.argv[1]), sys.argv[2], sys.argv[3], float(sys.argv[4])
cases, naive, init = json.loads(sys.argv[5]), json.loads(sys.argv[6]), json.loads(sys.argv[7])
router_scale = float(sys.argv[8])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
params0 = np.load(path + ".params0.npz")
fronts = np.load(path + ".frontend.npz")
toks = np.load(path + ".tokens.npy")
opt = OptConfig(kind="adamw", lr=lr)
runs = [(n, n, (2, 2), ("data", "model"), False) for n in cases]
runs += [(n + "_fsdp", n, (2, 2), ("data", "model"), True) for n in cases]
runs += [(n + "_rep", n, (4,), ("data",), False) for n in cases]
runs += [(n + "_naive", n, (2, 2), ("data", "model"), False) for n in naive]
runs += [(n + "_init", n, (2, 2), ("data", "model"), False) for n in init]
runs += [(n + "_init_rep", n, (4,), ("data",), False) for n in init]
halves = tensor_parallel.TensorParallel.halves
for key, name, shape, axes, fsdp in runs:
    arch, changes = cases[name]
    # the naive chunk: this rank's block of [x | z] taken as its channels'
    tensor_parallel.TensorParallel.halves = (lambda self, y: y) if key.endswith("_naive") \
        else halves
    cfg = _config(configs.get_config, arch, changes)
    model = LM(cfg, device="cpu")
    model.load_state_dict({k[len(name) + 1:]: torch.from_numpy(params0[k])
                           for k in params0.files if k.startswith(name + ".")})
    if "_init" in key:  # the router at its init scale
        with torch.no_grad():
            for k, v in model.leaves().items():
                if k.endswith(".router"):
                    v.div_(router_scale)
    mesh = make_local_mesh(tuple(shape), tuple(axes), device="cpu")
    sc = StepConfig(mode="pjit", fsdp=fsdp)
    state = init_state(model, opt, mesh=mesh, step_cfg=sc)
    step = build_train_step(model, opt, sc, group=mesh)
    i, n = mesh.linear_index(("data",)), mesh.size_of(("data",))
    per = toks.shape[1] // n
    metrics = []
    for s, t in enumerate(toks):
        rows = torch.from_numpy(t[i * per:(i + 1) * per]).long()
        batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
        if name in fronts.files:
            batch["frontend"] = torch.from_numpy(fronts[name][s, i * per:(i + 1) * per])
        m = step(state, batch)
        metrics.append((m["loss"], m["grad_norm"]))
    leaves = model.leaves()
    out = {"metrics": np.array(metrics)}
    out.update({"full/" + k: convert.full_tensor(v).detach().numpy() for k, v in leaves.items()})
    local = lambda t: (t.to_local() if isinstance(t, DTensor) else t).detach().numpy()
    out.update({"local/" + k: local(v) for k, v in leaves.items()})
    np.savez(path + f".{key}.{rank}.npz", **out)
    specs = state_pspecs(model, opt, sc, mesh)["params"]
    tp = tensor_parallel.plan(specs, model.spec(), None, mesh.shape.get("model", 1), 0)
    split = {} if tp is None else {b: [f for f in ("heads", "kv_heads", "ff", "vocab",
                                                    "experts", "inner") if getattr(t, f)]
                                   for b, t in tp.blocks.items()}
    with open(path + f".{key}.{rank}.json", "w") as f:
        json.dump({"coords": dict(zip(mesh.axis_names, mesh.coords)), "specs": specs,
                   "shape": dict(mesh.shape), "split": split}, f)
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs_for(CASES, tmp_path_factory, init=("qwen3_ep",))


def _port(path, key):
    return [np.load(f"{path}.{key}.{rank}.npz") for rank in range(WORKERS)]


def _full(npz):
    return {k[len("full/"):]: npz[k] for k in npz.files if k.startswith("full/")}


def _initial(path, name):
    p0 = np.load(path + ".params0.npz")
    return {k[len(name) + 1:]: p0[k] for k in p0.files if k.startswith(name + ".")}


def _update(params, params0):
    return np.concatenate([np.ravel(params[k] - params0[k]) for k in sorted(params)])


def _check_update(upd_t, upd_j):
    assert np.abs(upd_j).max() > 0
    assert np.abs(upd_t - upd_j).max() <= 5 * LR
    assert np.linalg.norm(upd_t - upd_j) <= 0.1 * np.linalg.norm(upd_j)
    assert np.mean(np.sign(upd_t) == np.sign(upd_j)) >= 0.99


def check_matches_reference(path, key):
    name = key.removesuffix("_fsdp")
    ranks = _port(path, key)
    ref = np.load(f"{path}.{key}.jax.npz")
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], ref["metrics"], rtol=1e-2)
    p0 = _initial(path, name)
    full = _full(ranks[0])
    _check_update(_update(full, p0), _update({k: ref[k] for k in full}, p0))


def check_matches_replicated_port(path, key):
    name = key.removesuffix("_fsdp")
    got, want = _port(path, key)[0], _port(path, name + "_rep")[0]
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0], rtol=1e-3)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1], rtol=2e-3)
    p0 = _initial(path, name)
    _check_update(_update(_full(got), p0), _update(_full(want), p0))


def check_local_blocks(path, key, splits):
    ranks = _port(path, key)
    full = _full(ranks[0])
    for rank, npz in enumerate(ranks):
        with open(f"{path}.{key}.{rank}.json") as f:
            meta = json.load(f)
        for k, v in _full(npz).items():
            np.testing.assert_array_equal(v, full[k])  # every rank: the same parameters
            spec = tuple(meta["specs"][k])
            block = full[k][S.local_slice(spec, v.shape, meta["shape"], meta["coords"])]
            np.testing.assert_array_equal(npz["local/" + k], block)
    for block, flag in splits.items():
        assert flag in meta["split"][block], (block, meta["split"].get(block))
    # every leaf sharded over model sits in a block that computes split
    for k, spec in meta["specs"].items():
        if "model" in spec:
            assert meta["split"].get(k.rpartition(".")[0]), k


KEYS = [n + f for n in CASES for f in ("", "_fsdp")]


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_match_reference(runs, key):
    check_matches_reference(runs, key)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_match_replicated_port(runs, key):
    check_matches_replicated_port(runs, key)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_local_blocks_are_their_placements_slices(runs, key):
    check_local_blocks(runs, key, SPLITS[key.removesuffix("_fsdp")])


def test_moe_router_at_init_scale(runs):
    """ROADMAP §3 fault 14: with the router at its init scale (near
    uniform), qwen3-moe's split step keeps the loss and the grad norm within
    the replicated step's tolerances, but the split sums' rounding flips
    near-tied top-k choices, and the two steps' updates part by more than
    the relative L2 of 0.1 that the decisive router's cases hold."""
    got, want = _port(runs, "qwen3_ep_init")[0], _port(runs, "qwen3_ep_init_rep")[0]
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0], rtol=1e-3)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1], rtol=2e-3)
    p0 = {k: v / ROUTER_SCALE if k.endswith(".router") else v
          for k, v in _initial(runs, "qwen3_ep").items()}
    upd_t, upd_r = _update(_full(got), p0), _update(_full(want), p0)
    assert np.linalg.norm(upd_t - upd_r) > 0.1 * np.linalg.norm(upd_r)
