"""The resilient training loop against the reference's, on the reduced
gemma2 model: the returned ``health`` (skipped steps, delays, every
degradation-ladder transition with its step and reason) and the steps each
history row ran are equal for the same fault plans.  Covered: rollback to
the last checkpoint, retry in place, a fatal crash and auto-resume with
``fired_faults`` kept across calls, a slow worker, the ladder taken after
exhausted retries and after consecutive skips, and the original error
surfacing when the ladder is exhausted.  A kernel that fails to build or
launch (``KernelError``) ends the run with no retry and no transition.

Tolerances: none -- health dicts and step sequences are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import jaxcompat as compat
from repro.comms import faults as jf
from repro.comms.reducers import ReducerConfig as JRC
from repro.models import registry
from repro.optim import OptConfig as JOpt
from repro.train import init_state as j_init_state
from repro.train.loop import TrainLoopConfig as JLoop, train_loop as j_loop
from repro.train.step import StepConfig as JStep
from repro_torch import configs, convert
from repro_torch.comms import faults as tf
from repro_torch.comms.reducers import ReducerConfig as TRC
from repro_torch.kernels.build import KernelError
from repro_torch.models import LM
from repro_torch.optim import OptConfig as TOpt
from repro_torch.train import loop as t_loop_mod
from repro_torch.train import init_state as t_init_state
from repro_torch.train.loop import TrainLoopConfig as TLoop, train_loop as t_loop
from repro_torch.train.step import StepConfig as TStep

BUCKET = 16 * 4096 * 4  # reduced gemma2 (164,416 params) -> 3 buckets
RED = dict(kind="fft", theta=0.7, error_feedback=True, bucket_bytes=BUCKET,
           transport="sequenced", selector="sort", backend="auto", schedule="streamed")
OPT = dict(kind="adamw", lr=1e-3)


class _Tokens:
    """A stream of fixed token batches for either package."""

    def __init__(self, batches, wrap):
        self.batches, self.wrap = batches, wrap

    def batch_at(self, step, host_index=0, num_hosts=1):
        toks = self.batches[step % len(self.batches)]
        return {"tokens": self.wrap(toks[:, :-1]), "targets": self.wrap(toks[:, 1:])}


_BATCHES = [np.random.default_rng(s).integers(0, 256, (2, 17)).astype(np.int32)
            for s in range(4)]
_PARAMS = {}


def _reference(events, loop_kw, calls=1):
    """The reference loop, called ``calls`` times on one loop config (a
    restart after a fatal crash); returns the last result, or the error."""
    jmodel = registry.build(registry.get_config("gemma2_2b").reduced())
    jstate = j_init_state(jax.random.PRNGKey(3), jmodel, JOpt(**OPT), error_feedback=True)
    jstate["residual"] = jnp.zeros((1, jstate["residual"].shape[0]), jnp.float32)
    _PARAMS["p0"] = jax.tree_util.tree_map(np.asarray, jstate["params"])
    plan = jf.FaultPlan.from_dicts(events)
    mesh = compat.make_auto_mesh((1,), ("data",))
    cfg = JLoop(log_every=1, faults=plan, **loop_kw)
    step_cfg = JStep(mode="compressed_dp", reducer=JRC(axis="data", faults=plan, **RED))
    out = None
    for _ in range(calls):
        try:
            with compat.set_mesh(mesh):
                out = j_loop(jmodel, JOpt(**OPT), step_cfg, mesh, jstate,
                             _Tokens(_BATCHES, jnp.asarray), cfg)
        except Exception as e:  # noqa: BLE001 -- compared by type below
            out = e
    return out


def _port(events, loop_kw, calls=1):
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_PARAMS["p0"]))
    state = t_init_state(tmodel, TOpt(**OPT), error_feedback=True)
    plan = tf.FaultPlan.from_dicts(events)
    cfg = TLoop(log_every=1, faults=plan, **loop_kw)
    step_cfg = TStep(mode="compressed_dp", reducer=TRC(faults=plan, **RED))
    out = None
    for _ in range(calls):
        try:
            out = t_loop(tmodel, TOpt(**OPT), step_cfg, state,
                         _Tokens(_BATCHES, lambda t: torch.from_numpy(t).long()), cfg)
        except Exception as e:  # noqa: BLE001
            out = e
    return out


def _same_run(j, t):
    if isinstance(j, Exception):
        assert type(t).__name__ == type(j).__name__ and str(t) == str(j)
        return
    assert t["health"] == j["health"]
    assert [row["step"] for row in t["history"]] == [row["step"] for row in j["history"]]
    assert [row["skipped"] for row in t["history"]] == [
        float(row["skipped"]) for row in j["history"]]


CASES = {
    # a crash at 3 rolls back to the step-2 checkpoint; a fatal crash at 4
    # kills the run, and the restart resumes from step 4's checkpoint with
    # the fired crash remembered; a poisoned gradient at 5 is skipped
    "rollback_fatal_resume": ([dict(kind="slow_worker", step=1, worker=0, delay_s=0.001),
                               dict(kind="step_crash", step=3),
                               dict(kind="step_crash", step=4, fatal=True),
                               dict(kind="nan_grad", step=5, worker=0)],
                              dict(total_steps=6, ckpt_every=2, ckpt_keep=2), 2),
    # no checkpoint: two retries in place, the third failure takes a rung;
    # three skipped steps take the next one
    "retry_in_place_and_ladder": ([dict(kind="step_crash", step=1)] * 3
                                  + [dict(kind="nan_grad", step=s, worker=0) for s in (3, 4, 5)],
                                  dict(total_steps=7), 1),
    # a fatal crash with nothing to resume from propagates
    "fatal": ([dict(kind="step_crash", step=2, fatal=True)], dict(total_steps=4), 1),
    # every rung fails three times: the original error surfaces
    "ladder_exhausted": ([dict(kind="step_crash", step=1)] * 12, dict(total_steps=3), 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loop_health_equals_reference(name, tmp_path):
    events, loop_kw, calls = CASES[name]
    if "ckpt_every" in loop_kw:
        jkw = dict(loop_kw, ckpt_dir=str(tmp_path / "ref"))
        tkw = dict(loop_kw, ckpt_dir=str(tmp_path / "port"))
    else:
        jkw = tkw = loop_kw
    j = _reference(events, jkw, calls)
    t = _port(events, tkw, calls)
    _same_run(j, t)
    if name == "retry_in_place_and_ladder":
        assert [x["rung"] for x in t["health"]["transitions"]] == [
            "backend:auto->reference", "schedule:streamed->stacked"]
    if name == "rollback_fatal_resume":
        assert [row["step"] for row in t["history"]] == [4, 5]


def test_loop_ladder_on_the_card_skips_the_backend_rung(monkeypatch):
    """The loop hands the ladder its model's device; were that device the
    card, the same plan as ``retry_in_place_and_ladder`` would take the
    schedule rung and then the dense one, never ``backend:auto->reference``."""
    seen = []
    degrade = t_loop_mod.reducers.degrade_config

    def on_card(cfg, device=None):
        seen.append(torch.device(device))
        return degrade(cfg, torch.device("cuda"))

    monkeypatch.setattr(t_loop_mod.reducers, "degrade_config", on_card)
    events, loop_kw, calls = CASES["retry_in_place_and_ladder"]
    _PARAMS.setdefault("p0", convert.params_to_jax(
        LM(configs.get_config("gemma2_2b").reduced(), device="cpu").state_dict()))
    t = _port(events, loop_kw, calls)
    assert seen == [torch.device("cpu")] * 2
    assert [x["rung"] for x in t["health"]["transitions"]] == [
        "schedule:streamed->stacked", "kind:fft->dense"]
    assert "residual" not in t["state"]


def test_kernel_failure_ends_the_run_without_retry_or_rung(monkeypatch, capsys):
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    state = t_init_state(tmodel, TOpt(**OPT), error_feedback=True)
    build = t_loop_mod.build_train_step
    calls = []

    def broken_build(*a, **k):
        step = build(*a, **k)

        def run(st, batch):
            calls.append(st["step"])
            if st["step"] == 1:
                raise KernelError("fused_compress: CUDA launch failed (700: an illegal "
                                  "memory access was encountered)")
            return step(st, batch)
        return run

    monkeypatch.setattr(t_loop_mod, "build_train_step", broken_build)
    assert not issubclass(KernelError, RuntimeError)
    with pytest.raises(KernelError, match="launch failed"):
        t_loop(tmodel, TOpt(**OPT), TStep(mode="compressed_dp", reducer=TRC(**RED)), state,
               _Tokens(_BATCHES, lambda t: torch.from_numpy(t).long()),
               TLoop(total_steps=4, log_every=1))
    assert calls == [0, 1]
    out = capsys.readouterr().out
    assert "retrying" not in out and "degrading" not in out and "rolling back" not in out
    assert dataclasses.asdict(TLoop())["max_retries"] == 2
