"""Port parity of the resilience primitives (``comms/faults.py``), the
payloads' ``validate``, ``reducers.degrade_config``, and the step's fault
hooks: a ``nan_grad`` step and a corrupted-payload step skip and commit
nothing, as the reference's do, and a step that raises leaves the state as
it was.

Tolerances: none -- plans, event matching, checksums (uint32 sums of the
raw bits), verdicts, rung labels and skip decisions are equal to the
reference's; a skipped step's state is bitwise the state before it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import jaxcompat as compat
from repro.comms import bucketing as jb
from repro.comms import faults as jf
from repro.comms.reducers import ReducerConfig as JRC, degrade_config as j_degrade
from repro.core import compressor as jc
from repro.models import registry
from repro.optim import OptConfig as JOpt
from repro.train import init_state as j_init_state
from repro.train.step import StepConfig as JStep, build_train_step as j_build
from repro_torch import configs, convert
from repro_torch.comms import bucketing as tb
from repro_torch.comms import faults as tf
from repro_torch.comms import transport as tt
from repro_torch.comms.reducers import ReducerConfig as TRC, degrade_config as t_degrade
from repro_torch.core import compressor as tc
from repro_torch.core.quantizer import FittedQuantizer as TFQ, RangeQuantConfig as TRQ
from repro_torch.models import LM
from repro_torch.optim import OptConfig as TOpt
from repro_torch.train import StepConfig as TStep, build_train_step as t_build
from repro_torch.train import init_state as t_init_state

EVENTS = [dict(kind="nan_grad", step=1, worker=0),
          dict(kind="payload_corrupt", step=2, worker=1, plane="values"),
          dict(kind="payload_corrupt", step=3, worker=0, plane="quant"),
          dict(kind="step_crash", step=4, fatal=True),
          dict(kind="slow_worker", step=4, worker=1, delay_s=0.01),
          dict(kind="slow_worker", step=4, worker=0, delay_s=0.02)]


def test_fault_plan_dicts_and_selectors_equal_reference():
    jp, tp = jf.FaultPlan.from_dicts(EVENTS), tf.FaultPlan.from_dicts(EVENTS)
    assert tp.to_dicts() == jp.to_dicts() == EVENTS
    assert tf.FaultPlan.from_dicts(tp.to_dicts()) == tp and hash(tp) == hash(
        tf.FaultPlan.from_dicts(EVENTS))
    assert tf.FaultPlan.from_dicts(None) is None and tf.FaultPlan.from_dicts([]) is None
    assert [e.kind for e in tp.nan_events] == [e.kind for e in jp.nan_events]
    assert len(tp.corrupt_events) == len(jp.corrupt_events) == 2
    assert tp.has_exchange_faults == jp.has_exchange_faults
    for step in range(6):
        assert [i for i, _ in tp.crashes_at(step)] == [i for i, _ in jp.crashes_at(step)]
        assert tp.delay_at(step) == jp.delay_at(step)
    with pytest.raises(ValueError):
        tf.FaultPlan.from_dicts([dict(kind="meteor", step=1)])
    with pytest.raises(ValueError):
        tf.PayloadCorrupt(1, 0, plane="sideways")
    with pytest.raises(TypeError):
        tf.FaultPlan(("nan_grad",))


def test_match_events_equal_reference():
    jp, tp = jf.FaultPlan.from_dicts(EVENTS), tf.FaultPlan.from_dicts(EVENTS)
    for step in range(-1, 6):
        for worker in (None, 0, 1, 2):
            for je, te in ((jp.events, tp.events), (jp.nan_events, tp.nan_events),
                           (jp.corrupt_events, tp.corrupt_events), ((), ())):
                w = None if worker is None else jnp.int32(worker)
                assert tf.match_events(te, step, worker) == bool(
                    jf.match_events(je, jnp.int32(step), w))


N = 7 * 4096 + 100
BUCKET_BYTES = 3 * 4096 * 4


def _payloads(quantize=True):
    """The reference's stacked and monolithic payloads of one buffer and
    their port copies."""
    flat = (np.random.default_rng(0).standard_normal(N) * 0.05).astype(np.float32)
    layout = jb.build_layout(N, BUCKET_BYTES)
    comp = jc.FFTCompressor(jc.FFTCompressorConfig(quantize=quantize))
    stacked = comp.compress_stacked(jb.stack_buckets(jnp.asarray(flat), layout), layout.sizes())
    mono = comp.compress(jnp.asarray(flat))

    def quant(q):
        if q is None:
            return None
        return TFQ(TRQ(q.config.n_bits, q.config.m_bits),
                   *(torch.from_numpy(np.array(getattr(q, f)))
                     for f in ("eps", "p_codes", "vmax", "vmin")))

    planes = lambda p: [torch.from_numpy(np.array(t)) for t in (p.re, p.im, p.idx)]  # noqa
    return [(stacked, tc.StackedPayload(*planes(stacked), quant(stacked.quant),
                                        tuple(stacked.sizes), stacked.chunk)),
            (mono, tc.FFTPayload(*planes(mono), quant(mono.quant), mono.orig_len, mono.chunk))]


@pytest.mark.parametrize("quantize", [True, False])
def test_checksums_corruption_and_verdicts_equal_reference(quantize):
    for jp, tp in _payloads(quantize):
        jsum, tsum = jf.payload_checksums(jp), tf.payload_checksums(tp)
        assert [int(x) for x in tsum] == [int(x) for x in jsum]
        cases = [("clean", {})] + [(plane, {plane: True}) for plane in tf.CORRUPT_PLANES]
        # a NaN eps in the payload as compressed (not a wire corruption)
        for name, hits in cases:
            jbad = jf.corrupt_payload(jp, {k: jnp.bool_(v) for k, v in hits.items()})
            tbad = tf.corrupt_payload(tp, hits)
            assert [int(x) for x in tf.payload_checksums(tbad)] == [
                int(x) for x in jf.payload_checksums(jbad)]
            for level in tf.VALIDATE_LEVELS:
                assert bool(tf.validate_payload(tbad, level, reference_checksums=tsum)) == bool(
                    jf.validate_payload(jbad, level, reference_checksums=jsum)), (name, level)
                assert bool(tbad.validate(level) if level != "off" else True) == bool(
                    jbad.validate(level) if level != "off" else True)
        if quantize:
            jnan = dataclasses.replace(jp, quant=type(jp.quant)(
                jp.quant.config, jnp.full_like(jp.quant.eps, jnp.nan), jp.quant.p_codes,
                jp.quant.vmax, jp.quant.vmin))
            tnan = dataclasses.replace(tp, quant=dataclasses.replace(
                tp.quant, eps=torch.full_like(tp.quant.eps, float("nan"))))
            for level in ("cheap", "full"):
                assert not bool(jf.validate_payload(jnan, level)) and not bool(
                    tf.validate_payload(tnan, level))
    assert bool(tf.tree_finite({"a": torch.ones(3), "b": torch.zeros(2, dtype=torch.int16)}))
    assert not bool(tf.tree_finite({"a": torch.tensor([1.0, float("inf")])}))


def test_exchange_monitor_injects_validates_and_admits():
    _, tp = _payloads()[0]
    plan = tf.FaultPlan((tf.PayloadCorrupt(2, 0, "idx"),))
    quiet = tf.ExchangeMonitor("full", step=1, worker=0, corrupt=plan.corrupt_events)
    assert quiet.on_payload(tp) is tp and bool(quiet.ok())
    loud = tf.ExchangeMonitor("cheap", step=2, worker=0, corrupt=plan.corrupt_events)
    bad = loud.on_payload(tp)
    assert not bool(loud.ok()) and (bad.idx == tp.chunk).all()
    safe = loud.admit(bad)
    assert (safe.idx == 0).all() and (safe.re == 0).all()
    assert torch.equal(loud.admit(tp).idx, tp.idx) and torch.equal(loud.admit(tp).re, tp.re)
    # the exchange survives the corrupted payload (decoded as nothing)
    comp = tc.FFTCompressor(tc.FFTCompressorConfig())
    layout = tb.build_layout(N, BUCKET_BYTES)
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(N) * 0.05).astype(np.float32))
    mon = tf.ExchangeMonitor("cheap", step=2, worker=0, corrupt=plan.corrupt_events)
    mean = tt.SequencedTransport().run(x, comp=comp, layout=layout, monitor=mon)
    assert not bool(mon.ok()) and torch.equal(mean, torch.zeros_like(x))
    with pytest.raises(ValueError):
        tf.ExchangeMonitor("paranoid")


def test_degrade_config_rungs_equal_reference():
    def walk(cfg, degrade):
        labels = []
        while (rung := degrade(cfg)) is not None:
            cfg, label = rung
            labels.append(label)
        return labels, cfg

    plan_kw = dict(validate="full")
    for kw in (dict(backend="auto", schedule="streamed"), dict(backend="auto"),
               dict(schedule="auto"), dict(), dict(kind="timedomain", backend="auto")):
        base = dict(kind="fft", transport="psum", bucket_bytes=4096 * 4, error_feedback=True,
                    **plan_kw)
        base.update(kw)
        jl, jcfg = walk(JRC(**base), j_degrade)
        tl, tcfg = walk(TRC(**base), t_degrade)
        assert tl == jl
        assert (tcfg.kind, tcfg.error_feedback, tcfg.validate) == ("dense", False, "off")
    # the port's kernel backend is "cuda" where the reference's is "pallas"
    assert t_degrade(TRC(kind="fft", backend="cuda"))[1] == "backend:cuda->reference"
    assert j_degrade(JRC(kind="fft", backend="pallas"))[1] == "backend:pallas->reference"
    assert t_degrade(TRC(kind="dense")) is None
    plan = tf.FaultPlan((tf.NanGrad(1, 0),))
    dense, _ = t_degrade(TRC(kind="fft", faults=plan))
    assert dense.faults == plan and not dense.resilient
    assert TRC(kind="fft", validate="cheap").resilient
    assert TRC(kind="fft", faults=tf.FaultPlan((tf.PayloadCorrupt(1, 0),))).resilient
    assert not TRC(kind="fft", faults=plan).resilient


def test_degrade_config_on_the_card_has_no_backend_rung():
    """On a CUDA device the kernels are the only path: the ladder goes
    straight to the next rung and never to the plain versions.  (Config
    arithmetic only: nothing runs on a card.)"""
    def walk(cfg, device):
        labels = []
        while (rung := t_degrade(cfg, device)) is not None:
            cfg, label = rung
            labels.append(label)
        return labels

    base = dict(kind="fft", transport="sequenced", bucket_bytes=4096 * 4, error_feedback=True)
    for device in ("cuda", "cuda:0", torch.device("cuda", 1)):
        assert walk(TRC(backend="auto", **base), device) == ["kind:fft->dense"]
        assert walk(TRC(backend="cuda", schedule="streamed", **base), device) == [
            "schedule:streamed->stacked", "kind:fft->dense"]
    for device in (None, "cpu", torch.device("cpu")):
        assert walk(TRC(backend="auto", **base), device) == [
            "backend:auto->reference", "kind:fft->dense"]


BUCKET = 16 * 4096 * 4  # reduced gemma2 (164,416 params) -> 3 buckets


def _models():
    jcfg = registry.get_config("gemma2_2b").reduced()
    jmodel = registry.build(jcfg)
    jstate = j_init_state(jax.random.PRNGKey(1), jmodel, JOpt(kind="adamw"),
                          error_feedback=True)
    jstate["residual"] = jnp.zeros((1, jstate["residual"].shape[0]), jnp.float32)
    params0 = jax.tree_util.tree_map(np.asarray, jstate["params"])
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params0))
    return jmodel, jstate, tmodel


def _snapshot(state):
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else np.array(v))
            for k, v in convert.state_leaves(state).items()}


def _same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a) and a.keys() == b.keys()


def test_nan_grad_and_corrupt_payload_steps_skip_like_reference():
    """Step 0 poisons worker 0's gradient, step 1 flips value bits of its
    payload (only validate="full" sees it), step 2 is clean: both packages
    skip 0 and 1, committing nothing, and commit 2."""
    plan_events = (dict(kind="nan_grad", step=0, worker=0),
                   dict(kind="payload_corrupt", step=1, worker=0, plane="values"))
    red = dict(kind="fft", theta=0.7, error_feedback=True, bucket_bytes=BUCKET,
               transport="sequenced", selector="sort", validate="full")
    jmodel, jstate, tmodel = _models()
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 256, (2, 17)).astype(np.int32) for _ in range(3)]
    mesh = compat.make_auto_mesh((1,), ("data",))
    jstep = j_build(jmodel, JOpt(kind="adamw"), JStep(mode="compressed_dp", reducer=JRC(
        axis="data", backend="reference", faults=jf.FaultPlan.from_dicts(plan_events), **red)),
        mesh, {"tokens": jnp.asarray(toks[0][:, :-1]), "targets": jnp.asarray(toks[0][:, 1:])},
        donate=False)
    tstate = t_init_state(tmodel, TOpt(kind="adamw"), error_feedback=True)
    tstep = t_build(tmodel, TOpt(kind="adamw"), TStep(mode="compressed_dp", reducer=TRC(
        backend="auto", faults=tf.FaultPlan.from_dicts(plan_events), **red)))
    jskips, tskips = [], []
    for t in toks:
        with compat.set_mesh(mesh):
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(t[:, :-1]),
                                        "targets": jnp.asarray(t[:, 1:])})
        before = _snapshot(tstate)
        tm = tstep(tstate, {"tokens": torch.from_numpy(t[:, :-1]).long(),
                            "targets": torch.from_numpy(t[:, 1:]).long()})
        jskips.append(float(jm["skipped"]))
        tskips.append(tm["skipped"])
        after = _snapshot(tstate)
        before.pop("['step']")
        assert int(after.pop("['step']")) == len(tskips)
        assert _same(before, after) == bool(tm["skipped"])
    assert tskips == jskips == [1.0, 1.0, 0.0]


def test_step_that_raises_leaves_the_state_untouched(monkeypatch):
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    state = t_init_state(tmodel, TOpt(kind="adamw"), error_feedback=True)
    step = t_build(tmodel, TOpt(kind="adamw"), TStep(mode="compressed_dp", reducer=TRC(
        kind="fft", error_feedback=True, bucket_bytes=BUCKET, transport="sequenced")))
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.long),
             "targets": torch.ones((2, 16), dtype=torch.long)}
    step(state, batch)  # moments and residual are non-zero from here on
    before = _snapshot(state)
    calls = []

    def broken(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:  # after the EF roundtrip, inside the exchange
            raise RuntimeError("collective failed")
        return orig(self, *a, **k)

    orig = tt.Transport.run
    monkeypatch.setattr(tt.Transport, "run", broken)
    with pytest.raises(RuntimeError, match="collective failed"):
        step(state, batch)
    assert _same(before, _snapshot(state))
