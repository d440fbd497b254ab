"""The dense baseline of the port against the reference: ``sgd``
(``optim/optimizers.py``), the ``pjit`` step (``train/step.py``) for one
process and for 2 gloo workers (against the reference's ``pjit`` on 1 and
2 fake CPU devices), and the CLI's new flags on ``--device cpu``.

Tolerances:
* ``sgd``: 3 steps bitwise against the reference's ``apply_updates`` run
  op by op (eagerly).  Under ``jit``, XLA's CPU contracts
  ``momentum * mu + g`` into a fused multiply-add, which moves the last bit
  of ~1e-7 relative of the values (as ROADMAP §3 notes for B2's
  magnitudes); the port keeps the unfused IEEE products;
* ``pjit`` steps: those of ``test_two_compressed_dp_ef_steps_match_reference``
  (``tests/test_torch_train.py``): the two packages' bf16 gradients differ
  by ~1e-2 relative, so the loss and the grad norm within 1e-2 relative at
  each step and every parameter's update within 5 * lr of the reference's.
  AdamW moves each value by about lr a step whatever its gradient, so that
  bound alone binds little: the whole update is also held within relative
  L2 0.1 of the reference's (0.070 measured) with the signs of 99% of its
  values equal (99.7%), and the same steps under ``sgd``, whose update
  scales with the mean gradient (a mean not divided by the world size moves
  it by 100%), within relative L2 0.03 (0.007).  The 2 workers end with
  bitwise the same parameters (one SUM all_reduce, divided by 2).
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
import torch

from helpers import REPO, run_with_devices
from repro import jaxcompat as compat
from repro.models import registry
from repro.optim import OptConfig as JOpt, apply_updates as j_apply, init_opt_state as j_init_opt
from repro.train import init_state as j_init_state
from repro.train.step import StepConfig as JStep, build_train_step as j_build
from repro_torch import configs, convert
from repro_torch.models import LM
from repro_torch.optim import OptConfig as TOpt, apply_updates as t_apply
from repro_torch.optim import init_opt_state as t_init_opt
from repro_torch.train import StepConfig as TStep, build_train_step as t_build
from repro_torch.train import init_state as t_init_state

LR = 3e-4


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_sgd_three_steps_bitwise(weight_decay):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((64, 33)).astype(np.float32),
              "b": {"c": rng.standard_normal(100).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(np.float32),
                                    params) for _ in range(3)]
    cfg = dict(kind="sgd", lr=0.1, momentum=0.9, weight_decay=weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_init_opt(JOpt(**cfg), jp)
    tp = convert.params_from_jax(params)
    ts = t_init_opt(TOpt(**cfg), tp)
    assert set(ts) == set(js) == {"mu", "count"}
    for g in grads:
        jp, js = j_apply(JOpt(**cfg), jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        t_apply(TOpt(**cfg), tp, convert.params_from_jax(g), ts)
    for tree, ref in ((tp, jp), (ts["mu"], js["mu"])):
        for name, value in convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          ref)).items():
            np.testing.assert_array_equal(tree[name].numpy(), value.numpy())
    assert ts["count"] == int(js["count"]) == 3


def _flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])


def _batches(seed, rows):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 256, (rows, 33)).astype(np.int32) for _ in range(2)])


# (optimizer, lr, the update's relative L2 bound against the reference's)
PJIT_OPTS = (("adamw", LR, 0.1), ("sgd", 0.1, 0.03))


def _check_update(upd_t, upd_j, kind, lr, rel_bound):
    assert np.abs(upd_j).max() > 0
    assert np.abs(upd_t - upd_j).max() <= 5 * lr
    assert np.linalg.norm(upd_t - upd_j) <= rel_bound * np.linalg.norm(upd_j), kind
    if kind == "adamw":
        assert np.mean(np.sign(upd_t) == np.sign(upd_j)) >= 0.99


def _two_pjit_steps(kind, lr, rel_bound):
    jcfg = registry.get_config("gemma2_2b").reduced()
    jmodel = registry.build(jcfg)
    opt = dict(kind=kind, lr=lr)
    jstate = j_init_state(jax.random.PRNGKey(1), jmodel, JOpt(**opt))
    params0 = jax.tree_util.tree_map(np.asarray, jstate["params"])
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params0))
    tstate = t_init_state(tmodel, TOpt(**opt))
    tstep = t_build(tmodel, TOpt(**opt), TStep(mode="pjit"))
    batches = _batches(0, 2)
    mesh = compat.make_auto_mesh((1,), ("data",))
    example = {"tokens": jnp.asarray(batches[0][:, :-1]),
               "targets": jnp.asarray(batches[0][:, 1:])}
    jstep = j_build(jmodel, JOpt(**opt), JStep(mode="pjit"), mesh, example)
    for toks in batches:
        with compat.set_mesh(mesh):
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks[:, :-1]),
                                        "targets": jnp.asarray(toks[:, 1:])})
        tm = tstep(tstate, {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                            "targets": torch.from_numpy(toks[:, 1:]).long()})
        assert "skipped" not in tm and "skipped" not in jm
        assert abs(tm["loss"] - float(jm["loss"])) <= 1e-2 * abs(float(jm["loss"]))
        assert abs(tm["grad_norm"] - float(jm["grad_norm"])) <= 1e-2 * float(jm["grad_norm"])
    assert tstate["step"] == int(jstate["step"]) == 2
    assert tstate["opt"]["count"] == int(jstate["opt"]["count"]) == 2
    upd_j = _flat(jax.tree_util.tree_map(np.asarray, jstate["params"])) - _flat(params0)
    upd_t = _flat(convert.params_to_jax(tmodel.state_dict())) - _flat(params0)
    _check_update(upd_t, upd_j, kind, lr, rel_bound)


def test_two_pjit_steps_match_reference():
    _two_pjit_steps(*PJIT_OPTS[0])


def test_two_pjit_sgd_steps_match_reference():
    _two_pjit_steps(*PJIT_OPTS[1])


_PORT_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, build_train_step, init_state
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2)
model = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
params = np.load(path + ".params.npz")
for kind, lr in (("adamw", float(sys.argv[4])), ("sgd", float(sys.argv[5]))):
    model.load_state_dict({k: torch.from_numpy(params[k]) for k in params.files})
    opt = OptConfig(kind=kind, lr=lr)
    state = init_state(model, opt)
    step = build_train_step(model, opt, StepConfig(mode="pjit"))
    metrics = []
    for toks in np.load(path + ".tokens.npy"):
        rows = torch.from_numpy(toks[2 * rank: 2 * rank + 2]).long()
        m = step(state, {"tokens": rows[:, :-1], "targets": rows[:, 1:]})
        metrics.append((m["loss"], m["grad_norm"]))
    np.savez(path + f".{kind}.{rank}.npz", metrics=np.array(metrics),
             **{k: v.detach().numpy() for k, v in model.state_dict().items()})
dist.destroy_process_group()
"""

_JAX_WORKERS = r"""
import jax, jax.numpy as jnp, numpy as np
from repro import jaxcompat as compat
from repro.models import registry
from repro.optim import OptConfig
from repro.train import init_state
from repro.train.step import StepConfig, build_train_step
path = {path!r}
model = registry.build(registry.get_config("gemma2_2b").reduced())
toks = np.load(path + ".tokens.npy")
mesh = compat.make_auto_mesh((2,), ("data",))
batch = lambda t: {{"tokens": jnp.asarray(t[:, :-1]), "targets": jnp.asarray(t[:, 1:])}}
for kind, lr in {opts!r}:
    opt = OptConfig(kind=kind, lr=lr)
    state = init_state(jax.random.PRNGKey(1), model, opt)
    step = build_train_step(model, opt, StepConfig(mode="pjit"), mesh, batch(toks[0]))
    metrics = []
    for t in toks:
        with compat.set_mesh(mesh):
            state, m = step(state, batch(t))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    flat = np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree_util.tree_leaves(state["params"])])
    np.savez(path + f".{{kind}}.jax.npz", metrics=np.array(metrics), params=flat)
print("JAX_OK")
"""


def test_two_gloo_worker_pjit_steps_match_reference(tmp_path):
    """2 workers, 2 rows each, against the reference's pjit over 2 fake
    devices on the same 4-row batches, under AdamW and then sgd."""
    path = str(tmp_path / "x")
    jmodel = registry.build(registry.get_config("gemma2_2b").reduced())
    params0 = jax.tree_util.tree_map(
        np.asarray, j_init_state(jax.random.PRNGKey(1), jmodel, JOpt(lr=LR))["params"])
    np.savez(path + ".params.npz",
             **{k: v.numpy() for k, v in convert.params_from_jax(params0).items()})
    np.save(path + ".tokens.npy", _batches(3, 4))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               repr(PJIT_OPTS[0][1]), repr(PJIT_OPTS[1][1])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    opts = [(kind, lr) for kind, lr, _ in PJIT_OPTS]
    out = run_with_devices(_JAX_WORKERS.format(path=path, opts=opts), devices=2)
    assert "JAX_OK" in out
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
    flat0 = _flat(params0)
    for kind, lr, rel_bound in PJIT_OPTS:
        ref = np.load(path + f".{kind}.jax.npz")
        got = [np.load(path + f".{kind}.{rank}.npz") for rank in range(2)]
        for g in got:
            # loss and grad norm at each step, 1e-2 relative
            np.testing.assert_allclose(g["metrics"], ref["metrics"], rtol=1e-2)
            upd = _flat(convert.params_to_jax({k: torch.from_numpy(g[k]) for k in g.files
                                               if k != "metrics"})) - flat0
            _check_update(upd, ref["params"] - flat0, kind, lr, rel_bound)
        for k in got[0].files:
            np.testing.assert_array_equal(got[0][k], got[1][k])


CLI_FLAGS = {
    "pjit-default": [],
    "dense-dp": ["--mode", "compressed_dp", "--reducer", "dense"],
    "timedomain": ["--mode", "compressed_dp", "--reducer", "timedomain", "--transport",
                   "sequenced", "--bucket-mb", "0.25", "--error-feedback"],
    "terngrad": ["--mode", "compressed_dp", "--reducer", "terngrad", "--error-feedback"],
    "qsgd": ["--mode", "compressed_dp", "--reducer", "qsgd", "--transport", "psum",
             "--bucket-mb", "0.25", "--error-feedback"],
    "psum": ["--mode", "compressed_dp", "--transport", "psum", "--bucket-mb", "0.25",
             "--error-feedback"],
    "psum-loop": ["--mode", "compressed_dp", "--transport", "psum", "--bucket-mb", "0.25",
                  "--no-stacked"],
    "theta-step": ["--mode", "compressed_dp", "--transport", "sequenced", "--bucket-mb",
                   "0.25", "--error-feedback", "--theta-schedule", "step"],
    "theta-thm35": ["--mode", "compressed_dp", "--theta-schedule", "thm35"],
}


@pytest.mark.parametrize("name", sorted(CLI_FLAGS))
def test_cli_trains_with_new_flags(name):
    from repro_torch.launch import train

    out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                      "--seq", "16", *CLI_FLAGS[name]])
    rows = out["history"]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r.get("skipped", 0.0) == 0.0 for r in rows)
    thetas = [r["theta"] for r in rows]
    if name == "pjit-default":
        assert thetas == [None] * 2 and "skipped" not in rows[0]
        assert "residual" not in out["state"]
    elif name == "theta-step":
        assert thetas == pytest.approx([0.7, 0.0])
    elif name == "theta-thm35":
        # sqrt(lr * rsqrt_decay) at lr 3e-4 stays under 0.025: quantized to 0
        assert thetas == [0.0] * 2
    else:
        assert thetas == pytest.approx([0.7] * 2)


def test_cli_refuses_dense_with_error_feedback():
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="meaningless for dense"):
        train.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch", "2", "--seq",
                    "16", "--mode", "compressed_dp", "--reducer", "dense", "--error-feedback"])


@pytest.mark.parametrize("mode", ["pjit", "compressed_dp"])
def test_step_is_its_body_and_host_epilogue(mode):
    """``train/step.py`` splits each step into its device work
    (``step.body``, the metrics left as tensors) and the host epilogue that
    reads them: two steps through ``step`` and through ``body`` (a
    compressed one committing without reading its guard, as a trace on fake
    tensors does) leave bitwise the same parameters, moments, residual and
    metrics.  The sharded ``pjit`` step is held the same way in
    ``tests/test_torch_dryrun.py``."""
    from repro_torch.comms.reducers import ReducerConfig

    cfg = configs.get_config("gemma2_2b").reduced()
    red = None if mode == "pjit" else ReducerConfig(
        kind="fft", error_feedback=True, transport="sequenced", bucket_bytes=65536,
        backend="auto", selector="auto")
    toks = torch.from_numpy(_batches(7, 2)[0]).long()
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    runs = []
    for split in (False, True):
        model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        sc, opt = TStep(mode=mode, reducer=red), TOpt(kind="adamw", lr=LR)
        state = t_init_state(model, opt, error_feedback=red is not None)
        step = t_build(model, opt, sc)
        metrics = []
        for _ in range(2):
            if not split:
                metrics.append(step(state, batch))
            else:
                kw = {} if mode == "pjit" else {"commit": True}
                metrics.append({k: float(v) for k, v in step.body(state, batch, **kw).items()})
        leaves = {k: v.detach().clone() for k, v in model.leaves().items()}
        leaves.update({f"mu/{k}": v for k, v in state["opt"]["mu"].items()})
        leaves.update({f"nu/{k}": v for k, v in state["opt"]["nu"].items()})
        if red is not None:
            leaves["residual"] = state["residual"]
        runs.append((metrics, leaves))
    assert runs[0][0] == runs[1][0]
    assert set(runs[0][1]) == set(runs[1][1])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
