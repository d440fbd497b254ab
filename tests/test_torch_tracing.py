"""The port's stage spans and counters (``repro_torch.tracing``): off, a
shared no-op that counts nothing; on, under a CPU ``torch.profiler``, every
span of the train step nested where it belongs, the compress passes and the
host's waits counted, and the step's state and metrics bitwise those of the
same step with tracing off.  One tiny compressed step (the cells' exchange:
``sequenced``, stacked, ``auto`` backend and selector) with and without
error feedback, run once with tracing off and once on."""

import collections

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs, tracing
from repro_torch.comms import transport
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.core import quantizer
from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
from repro_torch.kernels import fused_compress
from repro_torch.models import build
from repro_torch.optim import OptConfig
from repro_torch.train import TrainLoopConfig, init_state, train_loop
from repro_torch.train.step import StepConfig

STEP = "train_step"
# each span of the step and the spans it nests in, outermost first
STEP_SPANS = {name: (STEP,) for name in (
    "step.forward", "step.backward", "step.exchange", "step.guard", "step.epilogue",
    "optim.clip", "optim.update")}
EXCHANGE_SPANS = {name: (STEP, "step.exchange") for name in (
    "exchange.flat", "exchange.fft", "exchange.select", "exchange.fit", "exchange.encode",
    "exchange.gather", "exchange.decode")}
SPANS = {**STEP_SPANS, **EXCHANGE_SPANS}
# the tensor metrics the epilogue reads as floats: loss, ce, aux, grad_norm
# ("skipped" is a Python float already)
EPILOGUE_READS = 4


def _snapshot(model, state):
    out = {f"p/{k}": v.detach().clone() for k, v in model.leaves().items()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v.clone() for k, v in state["opt"][m].items()})
    if "residual" in state:
        out["residual"] = state["residual"].clone()
    return out


def _run(ef: bool, traced: bool):
    cfg = configs.get_config("gemma2_2b").reduced()
    torch.manual_seed(0)
    model = build(cfg, device="cpu")
    red = ReducerConfig(kind="fft", error_feedback=ef, transport="sequenced",
                        bucket_bytes=65536, backend="auto", selector="auto")
    step_cfg, opt = StepConfig(mode="compressed_dp", reducer=red), OptConfig(kind="adamw")
    state = init_state(model, opt, error_feedback=ef, step_cfg=step_cfg)
    stream = SyntheticStream(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                             global_batch=2))
    metrics = []
    loop_cfg = TrainLoopConfig(total_steps=1, log_every=1,
                               metrics_hook=lambda step, m, st: metrics.append(m))
    tracing.reset()
    tracing.enable(traced)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            train_loop(model, opt, step_cfg, state, stream, loop_cfg)
    finally:
        tracing.enable(False)
    return {"counters": tracing.counters(), "metrics": metrics,
            "state": _snapshot(model, state), "events": list(prof.events())}


@pytest.fixture(scope="module")
def runs():
    return {(ef, traced): _run(ef, traced) for ef in (True, False) for traced in (False, True)}


def _chains(events):
    """Each span's name -> the set of its ancestors' names (outermost first)."""
    out = collections.defaultdict(set)
    for e in events:
        if not e.is_user_annotation:
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.is_user_annotation:
                chain.append(p.name)
            p = p.cpu_parent
        out[e.name].add(tuple(reversed(chain)))
    return out


def test_tracing_off_is_one_shared_noop_and_counts_nothing(runs):
    tracing.enable(False)
    assert tracing.span("step.forward") is tracing.span("exchange.fft")
    tracing.reset()
    tracing.count("host_syncs", 3)
    assert tracing.counters() == {}
    for ef in (True, False):
        assert runs[ef, False]["counters"] == {}
        assert set(_chains(runs[ef, False]["events"])) == {STEP}


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("name", sorted(SPANS))
def test_every_span_nests_where_it_belongs(runs, ef, name):
    chains = _chains(runs[ef, True]["events"])
    assert chains[name] == {SPANS[name]}
    assert set(chains) == set(SPANS) | {STEP}


@pytest.mark.parametrize("ef,passes", [(True, 2), (False, 1)], ids=["ef", "no_ef"])
def test_encode_and_compress_passes_count_each_compress(runs, ef, passes):
    """With error feedback the step compresses twice (the local roundtrip
    and the exchange), without it once: one ``exchange.encode`` span and one
    ``exchange.compress_passes`` each."""
    run = runs[ef, True]
    encodes = sum(e.name == "exchange.encode" for e in run["events"])
    assert encodes == passes
    assert run["counters"]["exchange.compress_passes"] == passes


@pytest.mark.parametrize("ef,passes", [(True, 2), (False, 1)], ids=["ef", "no_ef"])
def test_host_syncs_count_each_wait_of_the_step(runs, ef, passes):
    """The tiny step's waits, by site, each a synchronizing call on a card:
    a compress pass sets two bins of ``hermitian_weights`` from Python
    numbers and copies the chunk counts of ``valid_chunk_mask`` to the
    device; the guard's ``bool(ok)`` reads once; the epilogue's ``float()``
    once a tensor metric.  The loop's ``torch.cuda.synchronize`` runs on a
    card only, and the fit's ``bool(done.all())`` only in the paper's search
    (``method="heuristic"``), which no step runs."""
    hermitian_weights, valid_chunk_mask, guard = 2 * passes, passes, 1
    assert runs[ef, True]["counters"]["host_syncs"] == (
        hermitian_weights + valid_chunk_mask + guard + EPILOGUE_READS)
    assert {"loss", "ce", "aux", "grad_norm", "skipped"} <= set(runs[ef, True]["metrics"][0])


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
def test_tracing_changes_no_bit_of_the_step(runs, ef):
    off, on = runs[ef, False], runs[ef, True]
    drop_dt = lambda ms: [{k: v for k, v in m.items() if k != "dt"} for m in ms]
    assert drop_dt(off["metrics"]) == drop_dt(on["metrics"])
    assert set(off["state"]) == set(on["state"])
    for k, v in off["state"].items():
        assert torch.equal(v, on["state"][k]), k


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_the_papers_fit_counts_one_wait_a_pass(max_iters):
    """``tune_eps_heuristic`` reads ``done`` on the host once a pass of its
    loop (no fit finishes in its first two passes: the sign can flip only
    from the second on)."""
    tracing.reset()
    tracing.enable(True)
    try:
        quantizer.tune_eps_heuristic(torch.tensor([-3.0]), torch.tensor([5.0]),
                                     quantizer.RangeQuantConfig(), max_iters=max_iters)
        assert tracing.counters() == {"host_syncs": max_iters}
    finally:
        tracing.enable(False)


def test_counters_read_kernel_launches_since_reset(monkeypatch):
    monkeypatch.setattr(fused_compress.KERNEL, "launches", 5)
    tracing.reset()
    monkeypatch.setattr(fused_compress.KERNEL, "launches", 7)
    assert tracing.counters() == {f"kernels.{fused_compress.KERNEL.name}": 2}


def test_gather_counts_the_payload_bytes_it_hands_the_collective(tmp_path):
    """``exchange.payload_bytes``: the bytes of every plane handed to
    ``all_gather_into_tensor``, an empty plane none (a one-rank gloo
    group)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        tracing.reset()
        tracing.enable(True)
        planes = [torch.zeros((3, 5), dtype=torch.uint8), torch.zeros((3, 5), dtype=torch.int16),
                  torch.zeros((3, 0), dtype=torch.uint8), torch.zeros((2, 1, 1))]
        for t in planes:
            assert transport._gather_plane(t, 1, None).shape == (1,) + tuple(t.shape)
        assert tracing.counters() == {"exchange.payload_bytes": 15 + 30 + 0 + 8}
    finally:
        tracing.enable(False)
        dist.destroy_process_group()
