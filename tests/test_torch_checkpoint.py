"""Port parity of ``train/checkpoint.py``: the reference's on-disk layout
and leaf keys, so a checkpoint of either package restores in the other.

Tolerances: none -- every restored array is bitwise the saved one (and the
reference's own arrays, across packages); the step and the optimizer's
count come back as the same integers.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry
from repro.optim import OptConfig as JOpt
from repro.train import checkpoint as jck
from repro.train import init_state as j_init_state
from repro_torch import configs, convert
from repro_torch.launch import train as train_cli
from repro_torch.models import LM
from repro_torch.optim import OptConfig as TOpt
from repro_torch.train import checkpoint as tck
from repro_torch.train import init_state as t_init_state


def _state(seed=0, kind="adamw"):
    model = LM(configs.get_config("gemma2_2b").reduced(), device="cpu",
               generator=torch.Generator().manual_seed(seed))
    state = t_init_state(model, TOpt(kind=kind), error_feedback=True)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for moment in ("mu", "nu"):
            for t in state["opt"].get(moment, {}).values():
                t.copy_(torch.randn(t.shape, generator=gen))
        state["residual"].copy_(torch.randn(state["residual"].shape, generator=gen))
    state["opt"]["count"], state["step"] = 7 + seed, 9 + seed
    return state


def _arrays(state):
    return {k: np.array(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in convert.state_leaves(state).items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_roundtrip_tmp_invisible_and_fallback(tmp_path):
    d = str(tmp_path)
    old, new = _state(0), _state(1)
    tck.save(d, 3, old)
    tck.save(d, 5, new)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a dead writer's leftover
    os.makedirs(os.path.join(d, "notes"))
    assert tck.latest_step(d) == 5
    target = _state(2)
    _, step = tck.restore(d, target)
    assert step == 5 and target["step"] == 10 and target["opt"]["count"] == 8
    _assert_same(_arrays(target), _arrays(new))
    # bit rot in the newest checkpoint: warned fallback to the one before
    path = os.path.join(d, "step_00000005", "arrays.npz")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    arrays["['residual']"] = arrays["['residual']"] + 1.0
    np.savez(path, **arrays)
    with pytest.warns(UserWarning, match="falling back"):
        _, step = tck.restore(d, target)
    assert step == 3
    _assert_same(_arrays(target), _arrays(old))
    with pytest.raises(tck.CheckpointError):
        tck.restore(d, target, step=5)
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "empty"), target)


def test_async_save_snapshots_and_manager_gc(tmp_path):
    d = str(tmp_path)
    state = _state(0)
    saved = _arrays(state)
    tck.save(d, 1, state, block=False)
    with torch.no_grad():  # the port updates in place the moment save returns
        for p in state["model"].leaves().values():
            p.add_(1.0)
    tck.wait()
    target = _state(3)
    tck.restore(d, target)
    _assert_same(_arrays(target), saved)
    manager = tck.CheckpointManager(d, every=2, keep=2, async_save=True)
    for step in range(2, 9):
        manager.maybe_save(step, state)
    manager.wait()
    assert sorted(os.listdir(d)) == ["step_00000006", "step_00000008"]


def _reference_state():
    jmodel = registry.build(registry.get_config("gemma2_2b").reduced())
    jstate = j_init_state(jax.random.PRNGKey(4), jmodel, JOpt(kind="adamw"), error_feedback=True)
    key = jax.random.PRNGKey(5)
    jstate["opt"] = jax.tree_util.tree_map(
        lambda x: jax.random.normal(key, x.shape) if x.ndim else jnp.int32(11), jstate["opt"])
    jstate["residual"] = jax.random.normal(key, (1,) + jstate["residual"].shape)
    jstate["step"] = jnp.int32(12)
    return jstate


def test_checkpoints_restore_across_packages_bitwise(tmp_path):
    # reference -> port
    jstate = _reference_state()
    jck.save(str(tmp_path / "ref"), 12, jstate)
    target = _state(0)
    _, step = tck.restore(str(tmp_path / "ref"), target)
    assert step == 12 and target["step"] == 12 and target["opt"]["count"] == 11
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got = _arrays(target)
    _assert_same(got, {k: want[k] for k in got})
    assert set(want) == set(got)
    # port -> reference
    state = _state(1)
    tck.save(str(tmp_path / "port"), 10, state)
    restored, step = jck.restore(str(tmp_path / "port"), _reference_state())
    assert step == 10 and int(restored["step"]) == 10 and int(restored["opt"]["count"]) == 8
    back = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(restored)[0]}
    _assert_same(back, _arrays(state))


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--mode",
            "compressed_dp", "--transport", "sequenced", "--bucket-mb", "0.05",
            "--error-feedback", "--schedule", "streamed", "--stream-groups", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    first = train_cli.main(args + ["--steps", "2"])
    assert [row["step"] for row in first["history"]] == [0, 1]
    assert tck.latest_step(str(tmp_path)) == 2
    second = train_cli.main(args + ["--steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [row["step"] for row in second["history"]] == [2]
    assert second["health"] == {"skipped_steps": 0, "skip_steps": [], "delays": 0,
                                "transitions": []}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tck.latest_step(str(tmp_path)) == 3


_REMESH_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor
from repro_torch import configs, convert
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM
from repro_torch.models.sharding import block_of
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, checkpoint as tck, init_state
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
cfg = configs.get_config("gemma2_2b").reduced()
opt = OptConfig(kind="adamw")
toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 17))).long()


def sharded(seed, shape, axes, sc):
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    mesh = make_local_mesh(shape, axes, device="cpu")
    return mesh, model, init_state(model, opt, mesh=mesh, step_cfg=sc,
                                   error_feedback=sc.reducer is not None)


def dump(name, state):
    leaves = convert.state_leaves(state)
    full = {k: convert.full_tensor(v).detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in leaves.items()}
    ok = all(torch.equal(v.to_local(), block_of(torch.from_numpy(full[k]), v))
             for k, v in leaves.items() if isinstance(v, DTensor))
    if rank == 0:
        np.savez(f"{d}/{name}.npz", ok=np.array(ok), **full)


sc = StepConfig(mode="pjit", fsdp=True)
mesh, model, state = sharded(0, (2, 2), ("data", "model"), sc)
i = mesh.index("data")
build_train_step(model, opt, sc, group=mesh)(
    state, {"tokens": toks[2 * i:2 * i + 2, :-1], "targets": toks[2 * i:2 * i + 2, 1:]})
tck.save(f"{d}/ckpt", 1, state)
dump("saved", state)
for name, shape, axes in (("flat4", (4,), ("data",)), ("transposed", (2, 2), ("model", "data"))):
    _, _, target = sharded(1, shape, axes, sc)
    tck.restore(f"{d}/ckpt", target)
    dump(name, target)
_, _, target = sharded(2, (2, 2), ("data", "model"), sc)
tck.restore(f"{d}/ref", target)
dump("from_ref", target)
# hierarchical: the residual saved as one row per pod, restored by pod
hier = StepConfig(mode="hierarchical", multi_pod=True,
                  reducer=ReducerConfig(kind="hierarchical", error_feedback=True))
mesh, model, state = sharded(3, (2, 2, 1), ("pod", "data", "model"), hier)
j = mesh.linear_index(("pod", "data"))
build_train_step(model, opt, hier, group=mesh)(
    state, {"tokens": toks[j:j + 1, :-1], "targets": toks[j:j + 1, 1:]})
tck.save(f"{d}/hier", 1, state, row_group=mesh.group("pod"))
_, _, target = sharded(4, (2, 2, 1), ("pod", "data", "model"), hier)
tck.restore(f"{d}/hier", target, row=mesh.index("pod"))
np.savez(f"{d}/hier.{rank}.npz", pod=mesh.index("pod"), saved=state["residual"].numpy(),
         restored=target["residual"].numpy())
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""


def test_sharded_checkpoints_remesh(tmp_path):
    """A sharded (2, 2) ``("data", "model")`` FSDP state saved whole and
    restored onto a (4,) mesh and onto the transposed ``("model", "data")``
    one, every rank's block the slice of the saved arrays; the reference's
    checkpoint restored onto the (2, 2) state; a ``hierarchical`` state's
    residual saved as one row per pod and restored by pod.  4 gloo workers,
    bitwise throughout."""
    import json
    import socket
    import subprocess
    import sys

    from helpers import REPO

    d = str(tmp_path)
    jstate = _reference_state()
    jck.save(d + "/ref", 12, jstate)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _REMESH_WORKER, str(rank), str(port), d],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(4)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
    saved = dict(np.load(d + "/saved.npz"))
    assert saved.pop("ok")
    with open(os.path.join(d, "ckpt", "step_00000001", "manifest.json")) as f:
        assert set(json.load(f)["leaves"]) == set(saved)
    _assert_same(saved, dict(np.load(os.path.join(d, "ckpt", "step_00000001", "arrays.npz"))))
    for name in ("flat4", "transposed"):
        got = dict(np.load(f"{d}/{name}.npz"))
        assert got.pop("ok"), name
        _assert_same(got, saved)
    got = dict(np.load(d + "/from_ref.npz"))
    assert got.pop("ok")
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    _assert_same(got, {k: want[k] for k in got})
    rows = np.load(os.path.join(d, "hier", "step_00000001", "arrays.npz"))["['residual']"]
    assert rows.shape[0] == 2
    for rank in range(4):
        h = np.load(f"{d}/hier.{rank}.npz")
        np.testing.assert_array_equal(rows[int(h["pod"])], h["saved"])
        np.testing.assert_array_equal(h["restored"], h["saved"])
    assert not np.array_equal(rows[0], rows[1])
