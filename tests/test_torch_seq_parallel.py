"""Sequence parallelism of the stream between groups in the sharded ``pjit``
step (``models/tensor_parallel.py``'s ``scatter`` and ``gather``,
``LM._sequence_parallel``): the reference's ``_constrain_stream``, which
shards the stream its layer scan carries over ``model`` on the sequence dim
wherever ``S % model == 0 and S > 1``.

One module fixture runs the reference's ``pjit`` on 4 fake CPU devices and
the port on 4 gloo workers, both on a ``(2, 2)`` ``("data", "model")`` mesh,
from the same parameters and batches, for gemma2 (the dense kinds) and
seamless (its encoder and ``dec_cross_mlp``, with a swiglu MLP: ROADMAP §3
fault 15), tiny configs under ``remat="full"``, with FSDP off and on, at an
even sequence (the stream sharded) and an odd one (the stream replicated,
as in the reference).  The reference is compiled with
``xla_allow_excess_precision`` off (ROADMAP §3 fault 10).  The port also
runs each even case with ``LM._sequence_parallel`` patched to return None:
the stream kept replicated, the step otherwise the same
(``chip_smoke.replicated_stream``).

Tolerances:
* against the reference, those of ``tests/test_torch_sharding.py``: the
  loss and the grad norm within 1e-2 relative at each step, every
  parameter's update within 5 * lr of the reference's, the whole update
  within relative L2 0.1 with 99% of its signs equal;
* against the port's step with the stream replicated: bitwise -- the losses,
  the grad norms and every rank's blocks of the final parameters;
* the stream bytes a rank's checkpoints save
  (``chip_smoke.stream_bytes_saved``, a ``saved_tensors_hooks`` pack hook
  around each checkpoint's inputs): exactly ``B * (S / 2) * D`` bf16
  values a group (and an encoder layer) where the stream is sharded,
  ``B * S * D`` where it is replicated, ``B`` the rank's 2 rows.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO
from test_torch_tp_kinds import _CONFIG, _check_update, _full, _update

LR = 3e-4
WORKERS = 4
STEPS = 2
ROWS = 4
SEAMLESS = {"remat": "full", "mlp_activation": "swiglu"}
# name -> (arch, config changes on top of reduced(), sequence, fsdp)
CASES = {
    "dense": ("gemma2_2b", {"remat": "full"}, 16, False),
    "dense_fsdp": ("gemma2_2b", {"remat": "full"}, 16, True),
    "dense_odd": ("gemma2_2b", {"remat": "full"}, 15, True),
    "seamless": ("seamless_m4t_large_v2", SEAMLESS, 16, False),
    "seamless_fsdp": ("seamless_m4t_large_v2", SEAMLESS, 16, True),
    "seamless_odd": ("seamless_m4t_large_v2", SEAMLESS, 15, False),
}
EVEN = [n for n, c in CASES.items() if c[2] % 2 == 0]

_JAX_WORKER = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import jaxcompat as compat
from repro.models import registry
from repro.optim import OptConfig
from repro.train import init_state
from repro.train.step import StepConfig, build_train_step
path, cases, lr = sys.argv[1], json.loads(sys.argv[2]), float(sys.argv[3])
OPTIONS = {"xla_allow_excess_precision": False}
inputs = np.load(path + ".inputs.npz")
opt = OptConfig(kind="adamw", lr=lr)
flat = lambda tree: {".".join(k.key for k in kp): np.asarray(v)
                     for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
for name, (arch, changes, seq, fsdp) in cases.items():
    model = registry.build(_config(registry.get_config, arch, changes))
    state = init_state(jax.random.PRNGKey(1), model, opt)
    state["params"] = jax.tree_util.tree_map_with_path(
        lambda kp, v: jnp.asarray(inputs[arch + "." + ".".join(k.key for k in kp)]),
        state["params"])
    toks = inputs[name + "/tokens"]
    def batch(i):
        b = {"tokens": jnp.asarray(toks[i, :, :-1]), "targets": jnp.asarray(toks[i, :, 1:])}
        if name + "/frontend" in inputs.files:
            b["frontend"] = jnp.asarray(inputs[name + "/frontend"][i])
        return b
    mesh = compat.make_auto_mesh((2, 2), ("data", "model"))
    step = build_train_step(model, opt, StepConfig(mode="pjit", fsdp=fsdp), mesh, batch(0))
    st = jax.device_put(state, step.state_sharding)
    with compat.set_mesh(mesh):
        compiled = step.lower(st, jax.device_put(batch(0), step.batch_sharding)).compile(
            compiler_options=OPTIONS)
    metrics = []
    for i in range(len(toks)):
        with compat.set_mesh(mesh):
            st, m = compiled(st, jax.device_put(batch(i), step.batch_sharding))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    np.savez(path + f".{name}.jax.npz", metrics=np.array(metrics), **flat(st["params"]))
"""

_PORT_WORKER = _CONFIG + r"""
import contextlib, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from chip_smoke import replicated_stream, stream_bytes_saved
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state
rank, port, path, lr = int(sys.argv[1]), sys.argv[2], sys.argv[3], float(sys.argv[4])
cases, even = json.loads(sys.argv[5]), json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
inputs = np.load(path + ".inputs.npz")
opt = OptConfig(kind="adamw", lr=lr)
runs = [(n, n) for n in cases] + [(n + "_rep", n) for n in even]
for key, name in runs:
    arch, changes, seq, fsdp = cases[name]
    model = LM(_config(configs.get_config, arch, changes), device="cpu")
    model.load_state_dict({k[len(arch) + 1:]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith(arch + ".")})
    mesh = make_local_mesh((2, 2), ("data", "model"), device="cpu")
    sc = StepConfig(mode="pjit", fsdp=fsdp)
    state = init_state(model, opt, mesh=mesh, step_cfg=sc)
    step = build_train_step(model, opt, sc, group=mesh)
    i, n = mesh.linear_index(("data",)), mesh.size_of(("data",))
    toks = inputs[name + "/tokens"]
    per = toks.shape[1] // n
    metrics, saved = [], []
    for s, t in enumerate(toks):
        rows = torch.from_numpy(t[i * per:(i + 1) * per]).long()
        batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
        if name + "/frontend" in inputs.files:
            batch["frontend"] = torch.from_numpy(
                inputs[name + "/frontend"][s, i * per:(i + 1) * per])
        with (replicated_stream() if key.endswith("_rep") else contextlib.nullcontext()), \
                stream_bytes_saved() as stream:
            m = step(state, batch)
        metrics.append((m["loss"], m["grad_norm"]))
        saved.append(stream[0])
    out = {"metrics": np.array(metrics), "saved": np.array(saved)}
    for k, v in model.leaves().items():
        out["local/" + k] = v.to_local().detach().numpy()
        full = convert.full_tensor(v).detach().numpy()
        if rank == 0:
            out["full/" + k] = full
    np.savez(path + f".{key}.{rank}.npz", **out)
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""


def _inputs(path):
    """Each arch's parameters (the port's init, seed 0), each case's tokens
    and frontend embeddings (numpy, seeded by the sequence's length)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.registry import frontend_len

    inputs = {}
    for name, (arch, changes, seq, _) in CASES.items():
        cfg = dataclasses.replace(configs.get_config(arch).reduced(), **changes)
        if arch + ".embed.table" not in inputs:
            model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            inputs.update({f"{arch}.{k}": v.detach().numpy() for k, v in model.leaves().items()})
        rng = np.random.default_rng(seq)
        inputs[name + "/tokens"] = rng.integers(0, 256, (STEPS, ROWS, seq + 1)).astype(np.int32)
        frames = frontend_len(cfg, seq)
        if frames:
            inputs[name + "/frontend"] = (rng.standard_normal(
                (STEPS, ROWS, frames, cfg.d_model)) * 0.02).astype(np.float32)
    np.savez(path + ".inputs.npz", **inputs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's cases on 4 fake devices (one process an arch) beside
    the port's on 4 gloo workers, from the same inputs."""
    path = str(tmp_path_factory.mktemp("seq_parallel") / "x")
    _inputs(path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    # the port's workers count the stream's bytes with the card phase's hook
    port_env = dict(env, PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               str(LR), json.dumps(CASES), json.dumps(EVEN)], env=port_env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORKERS)]
    env_jax = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORKERS}")
    for arch in sorted({c[0] for c in CASES.values()}):
        cases = {n: c for n, c in CASES.items() if c[0] == arch}
        procs.append(subprocess.Popen([sys.executable, "-c", _CONFIG + _JAX_WORKER, path,
                                       json.dumps(cases), str(LR)], env=env_jax,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return path


def _port(path, key):
    return [np.load(f"{path}.{key}.{rank}.npz") for rank in range(WORKERS)]


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_parallel_step_matches_reference(runs, name):
    arch = CASES[name][0]
    ranks = _port(runs, name)
    ref = np.load(f"{runs}.{name}.jax.npz")
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], ref["metrics"], rtol=1e-2)
    inputs = np.load(runs + ".inputs.npz")
    p0 = {k[len(arch) + 1:]: inputs[k] for k in inputs.files if k.startswith(arch + ".")}
    full = _full(ranks[0])
    _check_update(_update(full, p0), _update({k: ref[k] for k in full}, p0))


@pytest.mark.parametrize("name", EVEN)
def test_sequence_parallel_step_is_bitwise_the_replicated_stream(runs, name):
    for got, want in zip(_port(runs, name), _port(runs, name + "_rep")):
        np.testing.assert_array_equal(got["metrics"], want["metrics"])
        for k in want.files:
            if k.startswith("local/"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoints_store_the_stream_shard(runs, name):
    """Each rank's checkpoints save ``1/model`` of the replicated stream's
    bytes at an even sequence, and all of them at an odd one."""
    from repro_torch import configs
    from repro_torch.models.registry import frontend_len

    arch, changes, seq, _ = CASES[name]
    cfg = configs.get_config(arch).reduced()
    whole = cfg.n_groups() * seq + cfg.n_encoder_layers * frontend_len(cfg, seq)
    whole *= 2 * cfg.d_model * 2  # the rank's 2 rows, d_model wide, in bf16
    want = whole // 2 if seq % 2 == 0 else whole
    for r in _port(runs, name):
        assert r["saved"].tolist() == [want] * STEPS
    if seq % 2 == 0:
        for r in _port(runs, name + "_rep"):
            assert r["saved"].tolist() == [whole] * STEPS


def test_card_phase_on_the_cpu():
    """The card's ``train-sp`` phase (``chip_smoke.sp_phase``) on the CPU
    over two gloo processes at reduced widths and 2 groups: the split's
    loss and gradient within the ``TP_*`` tolerances of the unsplit
    model's, the sequence-parallel stream bitwise the replicated one on
    both ranks, and the checkpoints' stream bytes halved."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    row = chip_smoke.sp_phase("cpu", groups=2, shape=(2, 16), reduced=True)
    assert row["sp_bitwise"] == [True, True]
    assert row["sp_saved"] == [row["saved_want"]["sp"]] * 2 == [4096] * 2
    assert row["rep_saved"] == [2 * 4096] * 2
