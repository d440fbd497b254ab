"""The program's stage spans read from fabricated profiler events
(``perfbench/spans.py``): a kernel to its innermost span, an autograd-thread
op to the span the step's thread is in, the rest unspanned; idle gaps, host
self time and the synchronizing calls by span; each quantity read from a
record; and the benchmark's own reading of the same events unchanged by the
spans among them."""

from types import SimpleNamespace

import pytest
import torch

from _tiny import ROOT  # noqa: F401  (puts the checkout on the path)

from perfbench import spans, trace

MODEL = ["/x/src/repro_torch/models/layers.py(46): mlp"]
FFT = ["/x/src/repro_torch/kernels/engine.py(336): _planes"]
OPTIM = ["/x/src/repro_torch/optim/optimizers.py(60): _apply_updates"]
STEP = ["/x/src/repro_torch/train/step.py(342): body"]


def _event(name, start, end, *, device=False, kernels=(), stack=(), thread=1, note=False):
    dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    kernels = [k if isinstance(k, tuple) else (f"{name}_kernel", k) for k in kernels]
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels],
                           stack=list(stack), thread=thread, is_user_annotation=note)


def _span(name, start, end, thread=1):
    return _event(name, start, end, note=True, thread=thread)


def _step_events():
    """One step, 0 to 200 us: forward [0, 40), backward [40, 100) (the
    autograd thread's op at 50), the exchange [100, 160) holding its fft
    [105, 130), the update [170, 190); a kernel launched at 162 under no
    span; each op's kernel on the device a few us after it."""
    return [
        _span(trace.STEP_RANGE, 0, 200),
        _span("step.forward", 0, 40),
        _event("aten::mm", 2, 4, kernels=[20], stack=MODEL),
        _event("mm_kernel", 5, 25, device=True),
        _span("step.backward", 40, 100),
        _event("autograd::engine::evaluate_function: MmBackward0", 50, 55, kernels=[30],
               thread=2),
        _event("mm_kernel", 55, 85, device=True),
        _span("step.exchange", 100, 160),
        _event("aten::cat", 101, 102, kernels=[3], stack=["/x/src/repro_torch/comms/x.py(1): f"]),
        _event("cat_kernel", 102, 105, device=True),
        _span("exchange.fft", 105, 130),
        _event("aten::_fft_r2c", 106, 108, kernels=[10, 5], stack=FFT),
        _event("fft_kernel", 108, 123, device=True),
        _event("cudaStreamSynchronize", 125, 129),
        _event("aten::_local_scalar_dense", 124, 130, stack=FFT),
        _event("aten::add", 162, 163, kernels=[4], stack=STEP),
        _event("add_kernel", 163, 167, device=True),
        _span("optim.update", 170, 190),
        _event("aten::add_", 171, 172, kernels=[15], stack=OPTIM),
        _event("add_kernel", 172, 187, device=True),
        _event("cudaDeviceSynchronize", 192, 199),
        # outside the step: read by nothing
        _event("aten::mm", 205, 206, kernels=[50], stack=MODEL),
        _span("step.forward", 204, 260),
    ]


@pytest.fixture()
def record():
    return spans.span_record(_step_events())


def test_a_kernel_goes_to_its_innermost_span(record):
    assert record["span_ms"]["step.forward"] == pytest.approx(0.020)
    assert record["span_ms"]["exchange.fft"] == pytest.approx(0.015)
    assert record["span_launches"]["exchange.fft"] == 2
    assert record["span_ms"]["step.exchange"] == pytest.approx(0.003)
    assert record["span_ms"]["optim.update"] == pytest.approx(0.015)


def test_an_autograd_thread_op_goes_to_the_backward(record):
    assert record["span_ms"]["step.backward"] == pytest.approx(0.030)
    assert record["span_launches"]["step.backward"] == 1


def test_a_kernel_under_no_span_is_unspanned(record):
    assert record["unspanned_ms"] == pytest.approx(0.004)
    assert sum(record["span_ms"].values()) + record["unspanned_ms"] == pytest.approx(0.087)


def test_an_idle_gap_goes_to_the_span_open_at_its_start(record):
    idle = record["span_idle_ms"]
    # a whole gap to the span open at its start: [0, 5) and [25, 55) the
    # forward, [85, 102) the backward, [105, 108) and [123, 163) the fft,
    # [167, 172) no span, [187, 200) the update
    assert idle == pytest.approx({"step.forward": 0.035, "step.backward": 0.017,
                                  "exchange.fft": 0.043, trace.STEP_RANGE: 0.005,
                                  "optim.update": 0.013})
    assert sum(idle.values()) + sum(record["span_ms"].values()) + record[
        "unspanned_ms"] == pytest.approx(0.2)


def test_host_time_is_each_spans_self_time_and_calls_are_counted(record):
    host = record["span_host_ms"]
    assert host["step.exchange"] == pytest.approx(0.035)
    assert host["exchange.fft"] == pytest.approx(0.025)
    assert host[trace.STEP_RANGE] == pytest.approx(0.020)
    assert sum(host.values()) == pytest.approx(record["step_host_ms"]) == pytest.approx(0.2)
    # the forward begun after the step is not the step's
    assert record["span_calls"] == {"exchange.fft": 1, "optim.update": 1, "step.backward": 1,
                                    "step.exchange": 1, "step.forward": 1}


def test_synchronizing_calls_are_counted_by_site(record):
    assert record["trace_syncs"] == 2
    assert record["step_wait_ms"] == pytest.approx(0.011)
    assert record["sync_sites"] == {
        "repro_torch/kernels/engine.py(336): _planes": 1,
        "cudaDeviceSynchronize outside the program": 1}


def test_the_benchmarks_reading_is_the_same_with_the_spans_among_the_events():
    events = _step_events()
    read = {}
    for name, evs in (("with", events), ("without", [e for e in events
                                                     if not spans.is_span(e)])):
        tracer = trace.Tracer(extra_steps=1)
        tracer.detail_prof = SimpleNamespace(events=lambda evs=evs: evs)
        read[name] = tracer.detail_record()
    assert read["with"] == read["without"]
    layers = read["with"]["layer_ms"]
    rec = spans.span_record(events)
    assert layers["models"] == pytest.approx(rec["span_ms"]["step.forward"]
                                             + rec["span_ms"]["step.backward"])
    assert layers["optimizer"] == pytest.approx(rec["span_ms"]["optim.update"])
    assert layers["exchange"] == pytest.approx(rec["span_ms"]["exchange.fft"]
                                               + rec["span_ms"]["step.exchange"])
    assert layers["step other"] == pytest.approx(rec["unspanned_ms"])


def test_the_collectives_kernels_inside_the_steps():
    events = [_span(trace.STEP_RANGE, 0, 100), _span("exchange.gather", 10, 50),
              _event("c10d::_allgather_base_", 11, 12, stack=STEP, kernels=[
                  ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)", 30),
                  ("copy_kernel", 5)])]
    assert spans.collective_ms(events) == pytest.approx(0.030)
    assert spans.span_record(events)["span_ms"]["exchange.gather"] == pytest.approx(0.035)


QUANTITIES = sorted(spans.SPAN_METRICS) + sorted(spans.COUNTER_METRICS)


@pytest.mark.parametrize("name", QUANTITIES + ["gather_ms.x4", "host_syncs.x4"])
def test_each_quantity_reads_its_span_or_counter_and_none_without(name):
    base = name.split(".")[0]
    rec = {"span_ms": {v: 1.5 for v in spans.SPAN_METRICS.values()},
           "counters": {v: 2.0 for v in spans.COUNTER_METRICS.values()}}
    assert spans.metric_value(name, rec) == (1.5 if base in spans.SPAN_METRICS else 2.0)
    assert spans.metric_value(name, {}) is None
    assert spans.metric_value(name, {"span_ms": {}, "counters": {}}) is None


def test_the_spans_line_holds_every_span_and_counter(record):
    line = spans.spans_line(record, {"host_syncs": 2, "exchange.payload_bytes": 100.0},
                            wire_bytes=300.0, workers=4)
    assert line.startswith("[spans] ")
    for name in record["span_ms"]:
        assert name in line
    assert "host_syncs 2 against the trace's 2" in line
    assert "payload x (P-1) 300 B against the wire's 300 B" in line
