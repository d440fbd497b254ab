"""The slice end to end: the port's compressed_dp train step with error
feedback over the sequenced transport, against the reference's
``build_train_step`` (1-device mesh, ``backend="pallas"`` in interpret
mode); and the 2-worker sequenced EF exchange over gloo against the
reference on 2 fake CPU devices.

Tolerances.  Both packages get the same weights and tokens; their bf16
gradients then differ by about 1e-2 relative L2 (tests/test_torch_model.py),
and the compressor amplifies that: a 1% perturbation moves bins across the
kept-set threshold and codes across quantizer bin edges, which shows up as
about 6e-2 relative error in the exchanged gradient.  So, after 2 steps:
* loss: 1e-2 relative at each step;
* AdamW moments mu and nu (linear in the exchanged gradient): relative L2
  error <= 0.15; the EF residual: <= 0.2 (measured 6e-2 and 1e-1 on the
  CPU);
* parameters: AdamW's first steps move every weight by about lr * sign(g)
  whatever |g| is, so a weight whose tiny gradient component has opposite
  signs in the two packages moves 2 * lr apart; the updates must agree in
  sign on >= 95% of weights (measured 97%) and never differ by more than
  5 * lr;
* the 2-worker exchange (no model, so no bf16): relative L2 error <= 1e-3;
* the training loop under a warmup-cosine LR schedule: the parameter
  updates after 3 steps agree in sign on >= 95% of weights and their L2
  norms agree within 10% (a loop that applied the schedule's warmup,
  1/3 and 2/3 of the base LR in the first two steps, moves the weights
  about a third less).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO, run_with_devices
from repro import jaxcompat as compat
from repro.comms.reducers import ReducerConfig as JRC
from repro.models import registry
from repro.optim import OptConfig as JOpt
from repro.train import init_state as j_init_state
from repro.train.step import StepConfig as JStep, build_train_step as j_build
from repro_torch import configs, convert
from repro_torch.comms.reducers import ReducerConfig as TRC
from repro_torch.models import LM
from repro_torch.optim import OptConfig as TOpt
from repro_torch.train import StepConfig as TStep, build_train_step as t_build
from repro_torch.train import init_state as t_init_state
from repro_torch.train import TrainLoopConfig as TLoop, train_loop as t_train_loop

BUCKET_BYTES = 16 * 4096 * 4  # reduced gemma2 (164,416 params) -> 3 buckets


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_two_compressed_dp_ef_steps_match_reference():
    jcfg = registry.get_config("gemma2_2b").reduced()
    jmodel = registry.build(jcfg)
    opt = dict(kind="adamw", lr=3e-4)
    red = dict(kind="fft", theta=0.7, error_feedback=True, bucket_bytes=BUCKET_BYTES,
               transport="sequenced", selector="auto")
    jstate = j_init_state(jax.random.PRNGKey(1), jmodel, JOpt(**opt), error_feedback=True)
    n = jstate["residual"].shape[0]
    jstate["residual"] = jnp.zeros((1, n), jnp.float32)
    params0 = jax.tree_util.tree_map(np.asarray, jstate["params"])

    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params0))
    tstate = t_init_state(tmodel, TOpt(**opt), error_feedback=True)
    tstep = t_build(tmodel, TOpt(**opt),
                    TStep(mode="compressed_dp", reducer=TRC(backend="auto", **red)))

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (2, 33)).astype(np.int32) for _ in range(2)]
    mesh = compat.make_auto_mesh((1,), ("data",))
    example = {"tokens": jnp.asarray(batches[0][:, :-1]),
               "targets": jnp.asarray(batches[0][:, 1:])}
    jstep = j_build(jmodel, JOpt(**opt),
                    JStep(mode="compressed_dp", reducer=JRC(axis="data", backend="pallas", **red)),
                    mesh, example)
    for toks in batches:
        jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
        with compat.set_mesh(mesh):
            jstate, jm = jstep(jstate, jb)
        tm = tstep(tstate, {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                            "targets": torch.from_numpy(toks[:, 1:]).long()})
        assert abs(tm["loss"] - float(jm["loss"])) <= 1e-2 * abs(float(jm["loss"]))
        assert tm["skipped"] == float(jm["skipped"]) == 0.0
    assert tstate["step"] == int(jstate["step"]) == 2
    assert tstate["opt"]["count"] == int(jstate["opt"]["count"]) == 2

    def flat(tree):
        return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])

    def port_flat(tree):
        return flat(convert.params_to_jax(tree))

    jparams = jax.tree_util.tree_map(np.asarray, jstate["params"])
    upd_j = flat(jparams) - flat(params0)
    upd_t = port_flat(tmodel.state_dict()) - flat(params0)
    assert np.mean(np.sign(upd_t) == np.sign(upd_j)) >= 0.95
    assert np.abs(upd_t - upd_j).max() <= 5 * opt["lr"]
    for moment in ("mu", "nu"):
        assert _rel(port_flat(tstate["opt"][moment]), flat(jstate["opt"][moment])) <= 0.15
    res_j = np.asarray(jstate["residual"])[0]
    assert np.linalg.norm(res_j) > 0
    assert _rel(tstate["residual"].numpy(), res_j) <= 0.2


_PORT_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.comms.reducers import ReducerConfig, make_reducer
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cfg = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2)
grads = np.load(out + ".in.npy")
reduce = make_reducer(ReducerConfig(**cfg))
res = torch.zeros(grads.shape[1])
means = []
for _ in range(2):
    mean, res = reduce({"w": torch.from_numpy(grads[rank].copy())}, res)
    means.append(mean["w"].numpy())
np.savez(out + f".{rank}.npz", means=np.stack(means), res=res.numpy())
dist.destroy_process_group()
"""

_JAX_WORKERS = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.jaxcompat import make_auto_mesh, shard_map as smap
from repro.comms import ReducerConfig, make_reducer
path = {path!r}
grads = {{"w": jnp.asarray(np.load(path + ".in.npy"))}}
r = make_reducer(ReducerConfig(axis="data", backend="pallas", **json.loads({cfg!r})))
mesh = make_auto_mesh((2,), ("data",))
def step(g, res):
    out, new_res = r(jax.tree.map(lambda x: x[0], g), res[0])
    return out["w"], new_res[None]
f = jax.jit(smap(step, mesh=mesh, in_specs=(P("data"), P("data")),
                 out_specs=(P(), P("data"))))
res = jnp.zeros((2, grads["w"].shape[1]))
means = []
for _ in range(2):
    got, res = f(grads, res)
    means.append(np.asarray(got))
np.savez(path + ".jax.npz", means=np.stack(means), res=np.asarray(res))
print("JAX_OK")
"""


def test_two_worker_sequenced_ef_exchange_matches_reference(tmp_path):
    n = 2 * 4096 + 173
    grads = (np.random.default_rng(0).standard_normal((2, n)) * 0.1).astype(np.float32)
    path = str(tmp_path / "x")
    np.save(path + ".in.npy", grads)
    cfg = dict(kind="fft", theta=0.7, error_feedback=True, bucket_bytes=4096 * 4,
               transport="sequenced", selector="auto")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    port_cfg = json.dumps(dict(cfg, backend="auto"))
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               port_cfg], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    out = run_with_devices(_JAX_WORKERS.format(path=path, cfg=json.dumps(cfg)), devices=2)
    assert "JAX_OK" in out
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
    ref = np.load(path + ".jax.npz")
    for rank in range(2):
        got = np.load(path + f".{rank}.npz")
        for step in range(2):
            assert _rel(got["means"][step], ref["means"][step]) <= 1e-3
        assert _rel(got["res"], ref["res"][rank]) <= 1e-3
    # every worker holds the same mean, bitwise (left-to-right fold)
    np.testing.assert_array_equal(np.load(path + ".0.npz")["means"],
                                  np.load(path + ".1.npz")["means"])


def test_reducer_config_refuses_unported_paths(capsys):
    from repro_torch.comms.reducers import make_reducer
    from repro_torch.launch import train

    # the two-level paths are ported; what they refuse is a flat group, an
    # unresolved transport, and the hierarchical kind off a two-level mesh
    reduce = make_reducer(dataclasses.replace(TRC(kind="fft"), transport="hierarchical"))
    with pytest.raises(ValueError, match="node_group, local_group"):
        reduce({"w": torch.zeros(4096)})
    with pytest.raises(ValueError, match="resolved transport"):
        make_reducer(dataclasses.replace(TRC(kind="fft"), transport="auto"))
    with pytest.raises(ValueError, match="two-level mesh"):
        make_reducer(TRC(kind="hierarchical"))
    # --mode hierarchical builds on a mesh with a pod axis, and the CLI
    # refuses it on a mesh without one
    from repro_torch.launch.mesh import make_local_mesh

    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    step = t_build(tmodel, TOpt(), TStep(mode="hierarchical", multi_pod=True,
                                         reducer=TRC(kind="hierarchical")),
                   group=make_local_mesh((1, 1, 1), ("pod", "data", "model")))
    assert step.reducer_config.kind == "hierarchical"
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--device", "cpu", "--mode", "hierarchical"])
    assert "'pod' axis" in capsys.readouterr().err


def test_cli_trains_two_gloo_workers_in_lockstep(tmp_path):
    """The CLI under a 2-process gloo group: each rank trains on its own
    rows, and the averaged loss and the exchanged mean keep both ranks'
    histories identical."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import json, sys; from repro_torch.launch import train; "
            "r = train.main(sys.argv[1:]); print('HISTORY', json.dumps("
            "[{k: v for k, v in row.items() if k != 'dt'} for row in r['history']]))")
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
            "--mode", "compressed_dp", "--transport", "sequenced", "--bucket-mb", "0.25",
            "--error-feedback"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    histories = []
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
        histories.append(json.loads(log.split("HISTORY", 1)[1]))
    assert histories[0] == histories[1]
    assert [row["step"] for row in histories[0]] == [0, 1]
    assert all(np.isfinite(row["loss"]) and row["skipped"] == 0.0 for row in histories[0])


class _Tokens:
    """A stream of fixed token batches for either package."""

    def __init__(self, batches, wrap):
        self.batches, self.wrap = batches, wrap

    def batch_at(self, step, host_index=0, num_hosts=1):
        toks = self.batches[step % len(self.batches)]
        return {"tokens": self.wrap(toks[:, :-1]), "targets": self.wrap(toks[:, 1:])}


def test_train_loop_trains_at_base_lr_like_reference():
    """Both loops evaluate a warmup-cosine schedule and train at the base
    LR (the reference step takes no LR multiplier)."""
    from repro.optim import lr_schedules as j_sched
    from repro.train.loop import TrainLoopConfig as JLoop, train_loop as j_train_loop
    from repro_torch.optim import lr_schedules as t_sched

    steps = 3
    jcfg = registry.get_config("gemma2_2b").reduced()
    jmodel = registry.build(jcfg)
    opt = dict(kind="adamw", lr=1e-3)
    red = dict(kind="fft", theta=0.7, bucket_bytes=BUCKET_BYTES, transport="sequenced",
               selector="sort", backend="reference")
    jstate = j_init_state(jax.random.PRNGKey(2), jmodel, JOpt(**opt))
    params0 = jax.tree_util.tree_map(np.asarray, jstate["params"])
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, 33)).astype(np.int32) for _ in range(steps)]
    mesh = compat.make_auto_mesh((1,), ("data",))
    with compat.set_mesh(mesh):
        jout = j_train_loop(
            jmodel, JOpt(**opt),
            JStep(mode="compressed_dp", reducer=JRC(axis="data", **red)), mesh, jstate,
            _Tokens(batches, jnp.asarray),
            JLoop(total_steps=steps, log_every=1, lr_schedule=j_sched.warmup_cosine(3, steps)))

    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params0))
    tout = t_train_loop(
        tmodel, TOpt(**opt), TStep(mode="compressed_dp", reducer=TRC(**red)),
        t_init_state(tmodel, TOpt(**opt)),
        _Tokens(batches, lambda t: torch.from_numpy(t).long()),
        TLoop(total_steps=steps, log_every=1, lr_schedule=t_sched.warmup_cosine(3, steps)))
    assert [row["step"] for row in tout["history"]] == list(range(steps))
    for jrow, trow in zip(jout["history"], tout["history"]):
        assert abs(trow["loss"] - jrow["loss"]) <= 1e-2 * abs(jrow["loss"])

    def flat(tree):
        return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])

    upd_j = flat(jax.tree_util.tree_map(np.asarray, jout["state"]["params"])) - flat(params0)
    upd_t = flat(convert.params_to_jax(tmodel.state_dict())) - flat(params0)
    assert np.mean(np.sign(upd_t) == np.sign(upd_j)) >= 0.95
    ratio = np.linalg.norm(upd_t) / np.linalg.norm(upd_j)
    assert 0.9 <= ratio <= 1.1, ratio
