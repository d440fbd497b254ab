"""Parameter sharding of the port: the logical-axis specs and rules
(``models/sharding.py``, ``LM.spec()``) against the reference's for all ten
archs at full size, the production meshes, and the sharded ``pjit`` step
(``train/step.py``: tensor parallelism over ``model``, FSDP over ``data``)
over 4 gloo workers on a ``(2, 2)`` ``("data", "model")`` mesh against the
reference's ``pjit`` on 4 fake CPU devices with the same mesh, parameters
and batches.  One module fixture runs every case of both packages once.

Tolerances:
* the specs: equal, leaf for leaf (shape, logical axes, init, scale), and
  ``resolve_pspec`` equal spec for spec on ``{data: 16, model: 16}`` with
  and without FSDP, ``{pod: 2, data: 16, model: 16}`` and ``(2, 2)``;
* the sharded step against the reference: those of
  ``tests/test_torch_dense.py``'s docstring -- the loss and the grad norm
  within 1e-2 relative at each step, every parameter's update within
  5 * lr of the reference's, the whole update within relative L2 0.1 with
  the signs of 99% of its values equal;
  (measured on the CPU: 2.5e-5 and 1.4e-3, the update 3.8 * lr, relative
  L2 0.052, 99.7% of signs);
* the sharded step against the port's own replicated ``pjit`` step on the
  same 4 rows a step (a flat ``(4,)`` mesh): the loss within 1e-3 relative
  and the grad norm within 2e-3 (measured 3.0e-5 and 1.2e-3: the model
  axis's partial sums are rounded to bf16 before their f32 sum), and the
  update within the same 5 * lr (3.7 * lr), relative L2 0.1 (0.054 to
  0.058) and 99% of signs (99.7%): AdamW's first steps move a weight by
  about lr whatever its gradient, so a tiny gradient component whose sign
  the rounding flips moves 2 * lr apart.  FSDP alone (a ``(4,)`` mesh with
  ``fsdp``) is bitwise the replicated step;
* every leaf's local block is bitwise the slice of the full array that its
  placement names, and every rank ends with the same full parameters.

The sequence is 32 long, which the model axis divides, so the sharded step
also runs the stream between groups sequence-parallel
(``tests/test_torch_seq_parallel.py``): every output of the port here is
bitwise the same with the stream kept replicated, so no value measured
above moved.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO, run_with_devices
from repro.models import registry as jreg
from repro.models.sharding import resolve_pspec as j_resolve
from repro_torch import configs
from repro_torch.models import sharding as S
from repro_torch.models.transformer import param_specs

LR = 3e-4
WORKERS = 4
STEPS = 3
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}]
# name -> (config changes, mesh shape, axes, fsdp); the reference runs each
CASES = {
    "tp": ({}, (2, 2), ("data", "model"), False),
    "tp_fsdp": ({}, (2, 2), ("data", "model"), True),
    # one kv head: the model axis does not divide it, so wk/wv replicate
    "kv1_fsdp": ({"n_kv_heads": 1}, (2, 2), ("data", "model"), True),
}
# port only: the replicated step and FSDP alone, on the flat mesh
PORT_ONLY = {
    "rep": ({}, (4,), ("data",), False),
    "fsdp4": ({}, (4,), ("data",), True),
    "kv1_rep": ({"n_kv_heads": 1}, (4,), ("data",), False),
}


def _flat_spec(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_spec(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", jreg.ARCH_NAMES)
def test_specs_and_rules_equal_reference(arch):
    want = _flat_spec(jreg.build(jreg.get_config(arch)).spec())
    got = param_specs(configs.get_config(arch))
    assert set(got) == set(want)
    for path, j in want.items():
        t = got[path]
        assert (t.shape, t.logical_axes, t.init, t.scale) == (
            tuple(j.shape), tuple(j.logical_axes), j.init, j.scale), path
        for mesh in MESHES:
            for fsdp in (False, True):
                assert S.resolve_pspec(t, mesh, fsdp=fsdp) == tuple(
                    j_resolve(j, mesh, fsdp=fsdp)), (path, mesh, fsdp)
    assert S.count_params(got) == configs.get_config(arch).param_count()


def test_data_axes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert S.data_axes_for({"data": 4}) == ("data",)
    assert S.data_axes_for({"pod": 2, "data": 2, "model": 1}) == ("pod", "data")
    assert S.data_axes_for({"node": 2, "local": 2}) == ("node", "local")
    spec = ("data", None, "model")
    assert S.placements(spec, ("pod", "data", "model")) == (Replicate(), Shard(0), Shard(2))
    assert S.placements(spec, ("model", "data")) == (Shard(2), Shard(0))
    with pytest.raises(ValueError, match="does not have"):
        S.placements(spec, ("data",))
    block = S.local_slice(spec, (4, 3, 6), {"data": 2, "model": 3}, {"data": 1, "model": 2})
    assert block == (slice(2, 4), slice(None), slice(4, 6))


_PORT_WORKER = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state
from repro_torch.train.step import state_pspecs
rank, port, path, lr = int(sys.argv[1]), sys.argv[2], sys.argv[3], float(sys.argv[4])
cases = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
errors = {}
try:
    make_production_mesh()
except ValueError as e:
    errors["production"] = str(e)
params0 = np.load(path + ".params0.npz")
toks = np.load(path + ".tokens.npy")
opt = OptConfig(kind="adamw", lr=lr)
for name, (changes, shape, axes, fsdp) in cases.items():
    cfg = dataclasses.replace(configs.get_config("gemma2_2b").reduced(), **changes)
    model = LM(cfg, device="cpu")
    key = "kv1" if changes else "base"
    model.load_state_dict({k[len(key) + 1:]: torch.from_numpy(params0[k])
                           for k in params0.files if k.startswith(key + ".")})
    mesh = make_local_mesh(tuple(shape), tuple(axes), device="cpu")
    sc = StepConfig(mode="pjit", fsdp=fsdp)
    state = init_state(model, opt, mesh=mesh, step_cfg=sc)
    step = build_train_step(model, opt, sc, group=mesh)
    i, n = mesh.linear_index(("data",)), mesh.size_of(("data",))
    per = toks.shape[1] // n
    metrics = []
    for t in toks:
        rows = torch.from_numpy(t[i * per:(i + 1) * per]).long()
        m = step(state, {"tokens": rows[:, :-1], "targets": rows[:, 1:]})
        metrics.append((m["loss"], m["grad_norm"]))
    leaves = model.leaves()
    out = {"metrics": np.array(metrics)}
    out.update({"full/" + k: convert.full_tensor(v).detach().numpy() for k, v in leaves.items()})
    local = lambda t: (t.to_local() if isinstance(t, DTensor) else t).detach().numpy()
    out.update({"local/" + k: local(v) for k, v in leaves.items()})
    for moment in ("mu", "nu"):
        out.update({f"{moment}/" + k: local(v) for k, v in state["opt"][moment].items()})
    np.savez(path + f".{name}.{rank}.npz", **out)
    specs = state_pspecs(model, opt, sc, mesh)["params"]
    with open(path + f".{name}.{rank}.json", "w") as f:
        json.dump({"coords": dict(zip(mesh.axis_names, mesh.coords)), "specs": specs,
                   "shape": dict(mesh.shape)}, f)
# compressed_dp through the loop on the (2, 2) mesh: the exchange runs over
# data, the ranks that differ only in model take the same rows
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.data import SyntheticConfig, SyntheticStream
from repro_torch.train import TrainLoopConfig, train_loop
model = LM(configs.get_config("gemma2_2b").reduced(), device="cpu",
           generator=torch.Generator().manual_seed(0))
mesh = make_local_mesh((2, 2), ("data", "model"), device="cpu")
sc = StepConfig(mode="compressed_dp", reducer=ReducerConfig(
    kind="fft", error_feedback=True, transport="sequenced", bucket_bytes=65536,
    selector="auto", backend="auto"))
state = init_state(model, opt, error_feedback=True, mesh=mesh, step_cfg=sc)
stream = SyntheticStream(SyntheticConfig(vocab_size=256, seq_len=16, global_batch=4, seed=0))
hist = train_loop(model, opt, sc, state, stream, TrainLoopConfig(total_steps=2, log_every=1),
                  group=mesh)["history"]
np.savez(path + f".dp.{rank}.npz", loss=np.array([r["loss"] for r in hist]),
         residual=state["residual"].numpy(), data=mesh.index("data"),
         **{"params/" + k: v.detach().numpy() for k, v in model.leaves().items()})
# every layer kind runs split over model: hymba's step, which an earlier guard
# refused by name, builds and steps (tests/test_torch_tp_kinds_b.py holds it)
hymba = LM(configs.get_config("hymba_1_5b").reduced(), device="cpu")
mesh = make_local_mesh((2, 2), ("data", "model"), device="cpu")
sc = StepConfig(mode="pjit")
state = init_state(hymba, opt, mesh=mesh, step_cfg=sc)
try:
    rows = torch.from_numpy(toks[0, :2]).long()
    errors["hymba_loss"] = build_train_step(hymba, opt, sc, group=mesh)(
        state, {"tokens": rows[:, :-1], "targets": rows[:, 1:]})["loss"]
except ValueError as e:
    errors["tp_kind"] = str(e)
with open(path + f".errors.{rank}.json", "w") as f:
    json.dump(errors, f)
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""

_JAX_WORKERS = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import jaxcompat as compat
from repro.models import registry
from repro.optim import OptConfig
from repro.train import init_state
from repro.train.step import StepConfig, build_train_step
path, cases, lr = {path!r}, json.loads({cases!r}), {lr!r}
toks = np.load(path + ".tokens.npy")
batch = lambda t: {{"tokens": jnp.asarray(t[:, :-1]), "targets": jnp.asarray(t[:, 1:])}}
opt = OptConfig(kind="adamw", lr=lr)
params0 = {{}}
for name, (changes, shape, axes, fsdp) in cases.items():
    model = registry.build(dataclasses.replace(registry.get_config("gemma2_2b").reduced(),
                                               **changes))
    mesh = compat.make_auto_mesh(tuple(shape), tuple(axes))
    state = init_state(jax.random.PRNGKey(1), model, opt)
    key = "kv1" if changes else "base"
    for kp, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        params0[key + "." + ".".join(k.key for k in kp)] = np.asarray(v)
    step = build_train_step(model, opt, StepConfig(mode="pjit", fsdp=fsdp), mesh,
                            batch(toks[0]))
    state = jax.device_put(state, step.state_sharding)
    metrics = []
    for t in toks:
        with compat.set_mesh(mesh):
            state, m = step(state, batch(t))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    np.savez(path + f".{{name}}.jax.npz", metrics=np.array(metrics),
             **{{".".join(k.key for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]}})
np.savez(path + ".params0.npz", **params0)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's cases on 4 fake devices (which also draw the initial
    parameters), then the port's cases and errors on 4 gloo workers."""
    path = str(tmp_path_factory.mktemp("sharding") / "x")
    np.save(path + ".tokens.npy",
            np.random.default_rng(3).integers(0, 256, (STEPS, 4, 33)).astype(np.int32))
    out = run_with_devices(_JAX_WORKERS.format(path=path, cases=json.dumps(CASES), lr=LR),
                           devices=WORKERS)
    assert "JAX_OK" in out
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               str(LR), json.dumps({**CASES, **PORT_ONLY})], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORKERS)]
    for p in procs:
        log, _ = p.communicate(timeout=400)
        assert p.returncode == 0, log
    return path


def _port(path, name):
    return [np.load(f"{path}.{name}.{rank}.npz") for rank in range(WORKERS)]


def _full(npz):
    return {k[len("full/"):]: npz[k] for k in npz.files if k.startswith("full/")}


def _update(params, params0):
    return np.concatenate([np.ravel(params[k] - params0[k]) for k in sorted(params)])


def _initial(path, name):
    key = "kv1" if CASES.get(name, PORT_ONLY.get(name))[0] else "base"
    p0 = np.load(path + ".params0.npz")
    return {k[len(key) + 1:]: p0[k] for k in p0.files if k.startswith(key + ".")}


def _check_update(upd_t, upd_j):
    assert np.abs(upd_j).max() > 0
    assert np.abs(upd_t - upd_j).max() <= 5 * LR
    assert np.linalg.norm(upd_t - upd_j) <= 0.1 * np.linalg.norm(upd_j)
    assert np.mean(np.sign(upd_t) == np.sign(upd_j)) >= 0.99


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_pjit_matches_reference(runs, name):
    ranks = _port(runs, name)
    ref = np.load(f"{runs}.{name}.jax.npz")
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], ref["metrics"], rtol=1e-2)
    p0 = _initial(runs, name)
    full = _full(ranks[0])
    _check_update(_update(full, p0), _update({k: ref[k] for k in full}, p0))


@pytest.mark.parametrize("name,replicated", [("tp", "rep"), ("tp_fsdp", "rep"),
                                             ("kv1_fsdp", "kv1_rep")])
def test_sharded_pjit_matches_replicated_port(runs, name, replicated):
    got, want = _port(runs, name)[0], _port(runs, replicated)[0]
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0], rtol=1e-3)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1], rtol=2e-3)
    p0 = _initial(runs, name)
    _check_update(_update(_full(got), p0), _update(_full(want), p0))


def test_fsdp_alone_is_bitwise_the_replicated_step(runs):
    got, want = _port(runs, "fsdp4")[0], _port(runs, "rep")[0]
    np.testing.assert_array_equal(got["metrics"], want["metrics"])
    for k, v in _full(want).items():
        np.testing.assert_array_equal(_full(got)[k], v)


@pytest.mark.parametrize("name", ["tp", "tp_fsdp", "kv1_fsdp", "fsdp4"])
def test_local_blocks_are_their_placements_slices(runs, name):
    ranks = _port(runs, name)
    full = _full(ranks[0])
    sharded = set()
    for rank, npz in enumerate(ranks):
        with open(f"{runs}.{name}.{rank}.json") as f:
            meta = json.load(f)
        for k, v in _full(npz).items():
            np.testing.assert_array_equal(v, full[k])  # every rank: the same parameters
            spec = tuple(meta["specs"][k])
            block = full[k][S.local_slice(spec, v.shape, meta["shape"], meta["coords"])]
            np.testing.assert_array_equal(npz["local/" + k], block)
            assert npz["mu/" + k].shape == block.shape
            if any(spec):
                sharded.add(k)
    # the (2, 2) mesh shards the attention, the MLP and the table over model
    # (and, with fsdp, every leaf with an eligible axis over data)
    assert {"embed.table", "layers.l0_attn_local_mlp.mlp.up"} <= sharded


def test_named_errors(runs):
    """The production mesh's world is refused by name; a layer kind split
    over ``model`` is not (every kind splits, not only the dense ones)."""
    errors = json.load(open(f"{runs}.errors.0.json"))
    assert "needs a world of 256 workers, got 4" in errors["production"]
    assert "tp_kind" not in errors
    assert np.isfinite(errors["hymba_loss"])


@pytest.mark.parametrize("arch", jreg.ARCH_NAMES)
def test_every_leaf_sharded_over_model_is_split(arch):
    """With no process group: for every arch at full size on the production
    meshes, every leaf the rules shard over ``model`` sits in a block that
    the tensor-parallel plan computes split (the plan's role for it), and
    the plan splits each MoE over experts where ``model`` divides them, else
    over ff."""
    from repro_torch.models.tensor_parallel import plan

    cfg = configs.get_config(arch)
    specs = param_specs(cfg)
    for mesh in MESHES[:2]:
        for fsdp in (False, True):
            pspecs = S.spec_tree_to_pspecs(specs, mesh, fsdp=fsdp)
            tp = plan(pspecs, specs, None, mesh["model"], 0)
            sharded = [k for k, s in pspecs.items() if "model" in s]
            assert sharded and tp is not None
            assert [k for k in sharded if not tp.splits(k)] == [], (mesh, fsdp)
            for block, t in tp.blocks.items():
                if block.endswith(".moe"):
                    assert (t.experts, t.ff) == (cfg.n_experts % mesh["model"] == 0,
                                                 cfg.n_experts % mesh["model"] != 0)


def test_compressed_dp_on_a_model_axis_exchanges_over_data(runs):
    """``compressed_dp`` through the loop on the ``(2, 2)`` mesh: every rank
    ends with the same parameters and losses; the EF residual is one row
    per data coordinate, shared by the ranks that differ only in model."""
    ranks = [np.load(f"{runs}.dp.{rank}.npz") for rank in range(WORKERS)]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["loss"], ranks[0]["loss"])
        for k in ranks[0].files:
            if k.startswith("params/"):
                np.testing.assert_array_equal(r[k], ranks[0][k])
    by_data = {}
    for r in ranks:
        by_data.setdefault(int(r["data"]), []).append(r["residual"])
    for rows in by_data.values():
        np.testing.assert_array_equal(rows[0], rows[1])
    assert not np.array_equal(by_data[0][0], by_data[1][0])
