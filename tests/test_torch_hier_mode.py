"""The port's ``--mode hierarchical`` (``train/step.py``): 4 gloo workers on
``(2, 2, 1)`` and ``(2, 1, 2)`` ``("pod", "data", "model")`` meshes, with
error feedback on and off, 3 steps of gemma2_2b ``reduced()``, against the
reference's step on 4 fake CPU devices with the same meshes, parameters and
batches, built with the spelling that runs there,
``ReducerConfig(kind="hierarchical", axis=None, pod_axis="pod")`` (the
reference CLI's ``axis="data"`` does not: ROADMAP §3); and the exchange
alone (the ``hierarchical`` reducer kind over the pod mesh) against the
reference's reducer fed each pod's mean.  One module fixture runs every
case of both packages once.

Tolerances:
* the steps: those of ``test_two_compressed_dp_ef_steps_match_reference``
  (``tests/test_torch_train.py``), which reads its state after 2 steps:
  the packages' bf16 gradients differ by about 1e-2 relative and the
  compressor amplifies it, so the loss within 1e-2 relative at each of the
  3 steps; after 2 steps the updates' signs equal on >= 95% of the weights
  and never more than 5 * lr apart, AdamW's moments within relative L2
  0.15 and each pod's residual row within 0.2.  After the third step the
  signs still agree on >= 95%, and the bounds that grow with the steps
  grow: an update at most 2 * lr a step apart (6 * lr; a weight whose tiny
  gradient has opposite signs in the two packages moves 2 * lr apart each
  step, measured 5.9 * lr) and the residual rows within 0.25 (measured
  0.22);
* the exchange alone (no model, so no bf16): each pod's mean and residual
  within relative L2 1e-3 of the reference's, the two-level test's bound
  (``tests/test_torch_two_level.py``);
* every rank ends with bitwise the same parameters (each pod's exchange
  gives every pod the same mean), the ranks of a pod hold bitwise the same
  residual, and the two pods' residuals differ;
* a one-pod ``(1, 1, 1)`` mesh is the one-worker exchange: bitwise the
  ``compressed_dp`` step's losses and parameters (in one process).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helpers import REPO, run_with_devices
from repro.models import registry as jreg
from repro.optim import OptConfig as JOpt
from repro.train import init_state as j_init_state
from repro_torch import configs
from repro_torch.comms.reducers import ReducerConfig as TRC
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state

LR = 3e-4
WORKERS = 4
STEPS = 3
RED = dict(kind="hierarchical", theta=0.7, bucket_bytes=16 * 4096 * 4, transport="sequenced",
           selector="auto")
# name -> (mesh shape over ("pod", "data", "model"), error feedback)
CASES = {"p2d2_ef": ((2, 2, 1), True), "p2d2": ((2, 2, 1), False),
         "p2m2_ef": ((2, 1, 2), True), "p2m2": ((2, 1, 2), False)}
N_EXCHANGE = 3 * 4096 + 173

_PORT_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.comms.reducers import ReducerConfig, make_reducer
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state
rank, port, path, lr = int(sys.argv[1]), sys.argv[2], sys.argv[3], float(sys.argv[4])
cases, red = json.loads(sys.argv[5]), json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
AXES = ("pod", "data", "model")
params0 = np.load(path + ".params0.npz")
toks = np.load(path + ".tokens.npy")
opt = OptConfig(kind="adamw", lr=lr)
errors = {}
try:
    build_train_step(LM(configs.get_config("gemma2_2b").reduced(), device="cpu"), opt,
                     StepConfig(mode="hierarchical", reducer=ReducerConfig(**red)),
                     group=make_local_mesh())
except ValueError as e:
    errors["no_pod"] = str(e)
for name, (shape, ef) in cases.items():
    model = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(params0[k]) for k in params0.files})
    mesh = make_local_mesh(tuple(shape), AXES, device="cpu")
    sc = StepConfig(mode="hierarchical", multi_pod=True,
                    reducer=ReducerConfig(error_feedback=ef, backend="auto", **red))
    state = init_state(model, opt, error_feedback=ef, mesh=mesh, step_cfg=sc)
    step = build_train_step(model, opt, sc, group=mesh)
    i, n = mesh.linear_index(("pod", "data")), mesh.size_of(("pod", "data"))
    per = toks.shape[1] // n
    metrics, out = [], {"pod": mesh.index("pod")}
    for s, t in enumerate(toks, 1):
        rows = torch.from_numpy(t[i * per:(i + 1) * per]).long()
        m = step(state, {"tokens": rows[:, :-1], "targets": rows[:, 1:]})
        metrics.append((m["loss"], m["grad_norm"], m["skipped"]))
        out.update({f"params@{s}/" + k: v.detach().numpy().copy()
                    for k, v in model.leaves().items()})
        for moment in ("mu", "nu"):
            out.update({f"{moment}@{s}/" + k: v.numpy().copy()
                        for k, v in state["opt"][moment].items()})
        if ef:
            out[f"residual@{s}"] = state["residual"].numpy().copy()
    np.savez(path + f".{name}.{rank}.npz", metrics=np.array(metrics), **out)
# the exchange alone over the (2, 2, 1) mesh: this rank's gradient
mesh = make_local_mesh((2, 2, 1), AXES, device="cpu")
reduce = make_reducer(ReducerConfig(error_feedback=True, backend="auto", **red), group=mesh)
grads = np.load(path + ".grads.npy")
res = torch.zeros(grads.shape[-1])
means, ress = [], []
for g in grads:
    mean, res = reduce({"w": torch.from_numpy(g[rank].copy())}, res)
    means.append(mean["w"].numpy())
    ress.append(res.numpy().copy())
np.savez(path + f".exchange.{rank}.npz", means=np.stack(means), res=np.stack(ress))
with open(path + f".errors.{rank}.json", "w") as f:
    json.dump(errors, f)
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""

_JAX_STEPS = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro import jaxcompat as compat
from repro.comms.reducers import ReducerConfig
from repro.models import registry
from repro.optim import OptConfig
from repro.train import init_state
from repro.train.step import StepConfig, build_train_step
path, cases, red, lr = {path!r}, json.loads({cases!r}), json.loads({red!r}), {lr!r}
toks = np.load(path + ".tokens.npy")
batch = lambda t: {{"tokens": jnp.asarray(t[:, :-1]), "targets": jnp.asarray(t[:, 1:])}}
model = registry.build(registry.get_config("gemma2_2b").reduced())
opt = OptConfig(kind="adamw", lr=lr)
for name, (shape, ef) in cases.items():
    mesh = compat.make_auto_mesh(tuple(shape), ("pod", "data", "model"))
    sc = StepConfig(mode="hierarchical", multi_pod=True,
                    reducer=ReducerConfig(axis=None, pod_axis="pod", error_feedback=ef,
                                          backend="reference", **red))
    state = init_state(jax.random.PRNGKey(1), model, opt, error_feedback=ef)
    if ef:
        state["residual"] = jnp.zeros((shape[0], state["residual"].shape[0]), jnp.float32)
    step = build_train_step(model, opt, sc, mesh, batch(toks[0]))
    flat = lambda tree: {{".".join(k.key for k in kp): np.asarray(v)
                         for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}
    metrics, out = [], {{}}
    for s, t in enumerate(toks, 1):
        state, m = step(state, batch(t))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["skipped"])))
        out.update({{f"params@{{s}}/" + k: v for k, v in flat(state["params"]).items()}})
        for moment in ("mu", "nu"):
            out.update({{f"{{moment}}@{{s}}/" + k: v
                        for k, v in flat(state["opt"][moment]).items()}})
        if ef:
            out[f"residual@{{s}}"] = np.asarray(state["residual"])
    np.savez(path + f".{{name}}.jax.npz", metrics=np.array(metrics), **out)
print("JAX_OK")
"""

_JAX_EXCHANGE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.jaxcompat import make_auto_mesh, shard_map
from repro.comms.reducers import ReducerConfig, make_reducer
path, red = {path!r}, json.loads({red!r})
grads = np.load(path + ".grads.npy")
# each pod's gradient: the mean of its two workers' (the dense intra-pod mean)
pods = jnp.asarray((grads[:, 0::2] + grads[:, 1::2]) / 2)
r = make_reducer(ReducerConfig(axis=None, pod_axis="pod", error_feedback=True,
                               backend="reference", **red))
mesh = make_auto_mesh((2, 2, 1), ("pod", "data", "model"))
def step(g, res):
    out, new_res = r({{"w": g[0]}}, res[0])
    return out["w"], new_res[None]
f = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P(), P("pod")),
                      manual_axes=("pod",)))
res = jnp.zeros((2, grads.shape[-1]), jnp.float32)
means, ress = [], []
for g in pods:
    mean, res = f(g, res)
    means.append(np.asarray(mean))
    ress.append(np.asarray(res))
np.savez(path + ".exchange.jax.npz", means=np.stack(means), res=np.stack(ress))
print("JAX_OK")
"""


def _lowpass(rng, rows):
    """Rows of a smooth signal: a low-pass spectrum, as the two-level test's."""
    spec = np.zeros((rows, N_EXCHANGE // 2 + 1), np.complex128)
    spec[:, :64] = rng.standard_normal((rows, 64)) + 1j * rng.standard_normal((rows, 64))
    return np.fft.irfft(spec, n=N_EXCHANGE).astype(np.float32) * 100


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's steps (two processes of two cases each) and its
    exchange on 4 fake devices, beside the port's on 4 gloo workers."""
    path = str(tmp_path_factory.mktemp("hier_mode") / "x")
    np.save(path + ".tokens.npy",
            np.random.default_rng(5).integers(0, 256, (STEPS, 4, 33)).astype(np.int32))
    rng = np.random.default_rng(6)
    np.save(path + ".grads.npy", np.stack([_lowpass(rng, 1) + 0.1 * _lowpass(rng, WORKERS)
                                           for _ in range(2)]))
    params0 = j_init_state(jax.random.PRNGKey(1), jreg.build(jreg.get_config("gemma2_2b")
                                                             .reduced()), JOpt())["params"]
    np.savez(path + ".params0.npz", **{".".join(k.key for k in kp): np.asarray(v)
                                       for kp, v in jax.tree_util.tree_flatten_with_path(
                                           params0)[0]})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               str(LR), json.dumps(CASES), json.dumps(RED)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORKERS)]
    halves = [dict(list(CASES.items())[:2]), dict(list(CASES.items())[2:])]
    env_jax = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORKERS}")
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_STEPS.format(path=path, cases=json.dumps(half),
                                                  red=json.dumps(RED), lr=LR)], env=env_jax,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for half in halves]
    out = run_with_devices(_JAX_EXCHANGE.format(path=path, red=json.dumps(RED)),
                           devices=WORKERS)
    assert "JAX_OK" in out
    for p in jax_procs + procs:
        log, _ = p.communicate(timeout=400)
        assert p.returncode == 0, log
    return path


def _port(path, name):
    return [np.load(f"{path}.{name}.{rank}.npz") for rank in range(WORKERS)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree(npz, prefix):
    return {k[len(prefix) + 1:]: npz[k] for k in npz.files if k.startswith(prefix + "/")}


def _flat(tree):
    return np.concatenate([np.ravel(tree[k]) for k in sorted(tree)])


@pytest.mark.parametrize("name", list(CASES))
def test_hierarchical_steps_match_reference(runs, name):
    ranks = _port(runs, name)
    ref = np.load(f"{runs}.{name}.jax.npz")
    p0 = _flat(dict(np.load(runs + ".params0.npz")))
    for r in ranks:
        np.testing.assert_allclose(r["metrics"][:, 0], ref["metrics"][:, 0], rtol=1e-2)
        assert (r["metrics"][:, 2] == 0).all() and (ref["metrics"][:, 2] == 0).all()
    for step in (2, STEPS):
        upd_j = _flat(_tree(ref, f"params@{step}")) - p0
        upd_t = _flat(_tree(ranks[0], f"params@{step}")) - p0
        assert np.mean(np.sign(upd_t) == np.sign(upd_j)) >= 0.95
        assert np.abs(upd_t - upd_j).max() <= (5 if step == 2 else 2 * step) * LR
    for moment in ("mu", "nu"):
        got, want = _tree(ranks[0], f"{moment}@2"), _tree(ref, f"{moment}@2")
        assert _rel(_flat(got), _flat(want)) <= 0.15


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_parameters(runs, name):
    ranks = _port(runs, name)
    for r in ranks[1:]:
        for k, v in _tree(ranks[0], f"params@{STEPS}").items():
            np.testing.assert_array_equal(r[f"params@{STEPS}/" + k], v)


@pytest.mark.parametrize("name", [n for n, (_, ef) in CASES.items() if ef])
def test_residual_is_one_row_per_pod(runs, name):
    ranks = _port(runs, name)
    ref = np.load(f"{runs}.{name}.jax.npz")
    assert ref[f"residual@{STEPS}"].shape[0] == 2
    for r in ranks:
        pod = int(r["pod"])
        assert _rel(r["residual@2"], ref["residual@2"][pod]) <= 0.2
        assert _rel(r[f"residual@{STEPS}"], ref[f"residual@{STEPS}"][pod]) <= 0.25
        for other in ranks:
            if int(other["pod"]) == pod:
                np.testing.assert_array_equal(other[f"residual@{STEPS}"],
                                              r[f"residual@{STEPS}"])
    by_pod = {int(r["pod"]): r[f"residual@{STEPS}"] for r in ranks}
    assert _rel(by_pod[0], by_pod[1]) > 1e-3


def test_pod_exchange_matches_reference(runs):
    ref = np.load(runs + ".exchange.jax.npz")
    for rank, got in enumerate(_port(runs, "exchange")):
        for step in range(2):
            assert _rel(got["means"][step], ref["means"][step]) <= 1e-3
            assert _rel(got["res"][step], ref["res"][step][rank // 2]) <= 1e-3


def test_mode_needs_a_pod_axis(runs):
    err = json.load(open(runs + ".errors.0.json"))["no_pod"]
    assert "'pod' axis" in err and "('data',)" in err


def test_one_pod_is_the_one_worker_exchange():
    """(1, 1, 1) in one process: the pod exchange of one pod is
    ``compressed_dp``'s exchange of one worker, bitwise."""
    cfg = configs.get_config("gemma2_2b").reduced()
    opt = OptConfig(kind="adamw", lr=LR)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (STEPS, 2, 17))).long()
    out = {}
    for mode in ("compressed_dp", "hierarchical"):
        model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        mesh = make_local_mesh((1, 1, 1), ("pod", "data", "model")) if mode != "compressed_dp" \
            else None
        red = TRC(**dict(RED, kind="fft" if mode == "compressed_dp" else "hierarchical"),
                  error_feedback=True, backend="auto")
        sc = StepConfig(mode=mode, multi_pod=mesh is not None, reducer=red)
        state = init_state(model, opt, error_feedback=True, mesh=mesh, step_cfg=sc)
        step = build_train_step(model, opt, sc, group=mesh)
        losses = [step(state, {"tokens": t[:, :-1], "targets": t[:, 1:]})["loss"] for t in toks]
        out[mode] = (losses, {k: v.detach().clone() for k, v in model.leaves().items()},
                     state["residual"].clone())
    (l0, p0, r0), (l1, p1, r1) = out["compressed_dp"], out["hierarchical"]
    assert l0 == l1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(r0, r1)
