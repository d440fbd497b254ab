"""Theta and LR schedules of the port (``core/schedules.py``,
``optim/lr_schedules.py``) against the reference, and the training loop's
per-step theta.

Tolerance: none.  Schedules are host-side Python floats computed with the
same expressions, so every value over 200 steps must be equal, and the
loop's recorded theta must equal the reference's ``schedule_curve``."""

import math

import numpy as np
import pytest
import torch

from repro.core import schedules as js
from repro.optim import lr_schedules as jl
from repro_torch import configs
from repro_torch.core import schedules as ts
from repro_torch.optim import OptConfig, lr_schedules as tl
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.models import LM
from repro_torch.train import StepConfig, TrainLoopConfig, init_state, train_loop

STEPS = 200

THETA_SCHEDULES = {
    "constant": lambda m: m.constant(0.7),
    "step_decay": lambda m: m.step_decay([(0, 0.99), (60, 0.5), (120, 0.0)]),
    "polynomial_decay": lambda m: m.polynomial_decay(0.9, 150, power=2.0, theta_end=0.1),
    "sigmoid_decay": lambda m: m.sigmoid_decay(0.9, 100, steepness=0.05),
    "thm35": lambda m: m.thm35_schedule(
        2.0, lambda s: 3e-4 * (jl if m is js else tl).rsqrt_decay(10)(s)),
}

MADE = [
    ("constant", dict(theta=0.7)),
    ("step_decay", dict(points=[[0, 0.99], [30, 0.0]])),
    ("polynomial_decay", dict(theta0=0.9, total_steps=50)),
    ("polynomial_decay", dict(theta0=0.9, total_steps=50, power=0.5, theta_end=0.2)),
    ("sigmoid_decay", dict(theta0=0.9, midpoint=25)),
    ("sigmoid_decay", dict(theta0=0.8, midpoint=100, steepness=0.1)),
    ("thm35", dict(lipschitz=1.0, eta=0.3)),
    ("thm35", dict(lipschitz=0.5, eta=0.01)),
]

LR_SCHEDULES = {
    "constant": lambda m: m.constant(),
    "cosine": lambda m: m.cosine(150, final=0.05),
    "warmup_cosine": lambda m: m.warmup_cosine(20, 180),
    "rsqrt_decay": lambda m: m.rsqrt_decay(),
    "rsqrt_decay_10": lambda m: m.rsqrt_decay(10),
    "step_decay": lambda m: m.step_decay([50, 100, 150], factor=0.5),
}


@pytest.mark.parametrize("name", sorted(THETA_SCHEDULES))
def test_theta_schedule_equals_reference(name):
    ref, port = THETA_SCHEDULES[name](js), THETA_SCHEDULES[name](ts)
    assert [port(s) for s in range(STEPS)] == [ref(s) for s in range(STEPS)]
    assert ts.schedule_curve(port, STEPS) == js.schedule_curve(ref, STEPS)


@pytest.mark.parametrize("kind,params", MADE, ids=[f"{k}-{i}" for i, (k, _) in enumerate(MADE)])
def test_make_schedule_and_curve_equal_reference(kind, params):
    ref, port = js.make_schedule(kind, **params), ts.make_schedule(kind, **params)
    assert [port(s) for s in range(STEPS)] == [ref(s) for s in range(STEPS)]
    for granularity in (0.05, 0.1):
        assert (ts.schedule_curve(port, STEPS, granularity)
                == js.schedule_curve(ref, STEPS, granularity))


def test_make_schedule_none_and_unknown():
    assert ts.make_schedule(None) is None
    assert ts.schedule_curve(None, 5) == js.schedule_curve(None, 5) == (0.0,) * 5
    with pytest.raises(ValueError, match="unknown schedule kind"):
        ts.make_schedule("cyclic")


def test_quantize_theta_equals_reference():
    thetas = [-0.3, 0.0, 0.024, 0.025, 0.026, 0.3449, 0.35, 0.7, 0.93, 0.96, 1.2, math.pi / 5]
    thetas += list(np.random.default_rng(0).uniform(-0.1, 1.1, 200))
    for g in (0.05, 0.01, 0.1):
        assert [ts.quantize_theta(t, g) for t in thetas] == [js.quantize_theta(t, g)
                                                             for t in thetas]


@pytest.mark.parametrize("name", sorted(LR_SCHEDULES))
def test_lr_schedule_equals_reference(name):
    ref, port = LR_SCHEDULES[name](jl), LR_SCHEDULES[name](tl)
    assert [port(s) for s in range(STEPS)] == [ref(s) for s in range(STEPS)]


class _Tokens:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step, host_index=0, num_hosts=1):
        toks = torch.from_numpy(self.batches[step % len(self.batches)]).long()
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_loop_theta_step_schedule_records_reference_curve():
    """The loop under ``--theta-schedule step`` (theta 0.7, then 0.0 from
    step 2): one step function per quantized theta, the recorded theta equal
    to the reference's ``schedule_curve``, and the optimizer state and the EF
    residual carried across the change."""
    steps = 4
    sched = ts.step_decay([(0, 0.7), (steps // 2, 0.0)])
    want = js.schedule_curve(js.step_decay([(0, 0.7), (steps // 2, 0.0)]), steps)
    assert want == pytest.approx((0.7, 0.7, 0.0, 0.0))
    model = LM(configs.get_config("gemma2_2b").reduced(), device="cpu",
               generator=torch.Generator().manual_seed(0))
    opt = OptConfig(kind="adamw", lr=1e-3)
    red = ReducerConfig(kind="fft", theta=0.7, error_feedback=True, bucket_bytes=16 * 4096 * 4,
                        transport="sequenced", selector="auto", backend="auto")
    state = init_state(model, opt, error_feedback=True)
    rng = np.random.default_rng(2)
    stream = _Tokens([rng.integers(0, 256, (2, 17)).astype(np.int32) for _ in range(steps)])
    out = train_loop(model, opt, StepConfig(mode="compressed_dp", reducer=red), state, stream,
                     TrainLoopConfig(total_steps=steps, log_every=1, theta_schedule=sched))
    rows = out["history"]
    assert tuple(row["theta"] for row in rows) == want
    assert all(np.isfinite(row["loss"]) and row["skipped"] == 0.0 for row in rows)
    assert state["step"] == state["opt"]["count"] == steps
    # theta 0 keeps every bin: the roundtrip is exact up to the quantizer,
    # so the residual is the quantization error alone, and nonzero
    assert float(state["residual"].norm()) > 0
