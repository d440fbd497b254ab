"""The yardstick's counts: the frozen kernel bounds against the ones they
were copied from, the model FLOPs against hand counts, the metric readers
on a made-up record, and the layer of an op's stack."""

import sys

import pytest
import torch

from _tiny import ROOT

from perfbench import peaks, spec, trace


def test_frozen_bounds_equal_chip_smokes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    rows, cols, k, k_pad = 221_184, 2049, 615, 640
    assert peaks.b2_bound(rows, cols, k, k_pad) == chip_smoke.b2_bound(rows, cols, k, k_pad)
    assert peaks.b3_bound(rows, k) == chip_smoke.b3_bound(rows, k)
    assert peaks.bound(1e9, 1e9, 1e9) == chip_smoke.bound(1e9, 1e9, 1e9)
    assert (peaks.HBM_BYTES_PER_S, peaks.FP32_FLOPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_FLOPS_PER_S)
    assert peaks.keep(0.7) == 615 and peaks.chunk_rows(1_351_388_160) == 329_929


TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            n_layers=2, n_encoder_layers=3, mlp_activation="swiglu")


def test_phi3_flops_by_hand():
    flops = spec.load_config("phi3_medium_14b.l3").flops
    # a layer: q and o 64x64, k and v 64x32, gate, up and down 64x128 -> 36,864
    # parameters; two layers and the 64x256 head -> 90,112; 4 x 32 tokens
    matrices = 2 * (2 * 4096 + 2 * 2048 + 3 * 8192) + 64 * 256
    assert matrices == 90_112
    attention = 12 * 2 * 4 * 16 * 32 * (4 * 32)
    assert flops(TINY, 4, 32) == 6 * 90_112 * 128 + attention == 75_497_472


def test_seamless_flops_by_hand():
    flops = spec.load_config("seamless_m4t_large_v2.json".replace(".json", "")).flops
    arch = dict(TINY, n_kv_heads=4, mlp_activation="relu")
    frames, tokens = 4 * 24, 4 * 32  # 24 frames a row
    enc_layer = 4 * 64 * 64 + 2 * 64 * 128  # q, k, v, o and up, down
    dec_token = 2 * (enc_layer + 2 * 64 * 64) + 64 * 256  # + cross q, o; head
    cross_kv = 2 * (2 * 64 * 64)  # over the frames
    total = (6 * 3 * enc_layer * frames + 12 * 3 * 4 * 16 * 24 * frames
             + 6 * dec_token * tokens + 6 * cross_kv * frames
             + 12 * 2 * 4 * 16 * (32 + 24) * tokens)
    assert flops(arch, 4, 32, 24) == total


def _record(**kw):
    rec = {"chips": 1, "window_steps": 10, "window_s": 4.0, "busy_s": 3.0,
           "kernel_device_s": {"fused_compress_kernel": 0.06, "fused_decompress_kernel": 0.04},
           "kernel_calls": {"fused_compress_kernel": 20, "fused_decompress_kernel": 10},
           "layer_ms": {"models": 50.0, "exchange": 300.0, "optimizer": 40.0},
           "wire_bytes_per_step": None, "flops_per_step": 1.4e13, "peak_flops": 989e12,
           "n_params": 1_351_388_160, "theta": 0.7, "mode": "compressed_dp"}
    rec.update(kw)
    return rec


def test_readers_on_a_record():
    read = {n: spec.metric_reader(n) for n in spec.reader_names()}
    assert spec.base_name("fused_compress_roofline.x4") == "fused_compress_roofline"
    assert spec.base_name("mfu.x4") == "mfu" and spec.base_name("mfu") == "mfu"
    rec = _record()
    assert read["mfu"](rec) == pytest.approx(100 * 1.4e13 * 10 / (4.0 * 989e12))
    assert read["idle_pct"](rec) == pytest.approx(25.0)
    assert read["model_ms"](rec) == 50.0 and read["exchange_ms"](rec) == 300.0
    assert read["optim_ms"](rec) == 40.0
    rows = 329_929
    b2, _ = peaks.b2_bound(rows, 2049, 615, 615)
    assert read["fused_compress_roofline"](rec) == pytest.approx(100 * 20 * b2 / 1e3 / 0.06)
    b3, _ = peaks.b3_bound(rows, 615)
    assert read["fused_decompress_roofline"](rec) == pytest.approx(100 * 10 * b3 / 1e3 / 0.04)
    assert read["wire_mb_per_step"](rec) is None
    assert read["wire_mb_per_step"](_record(wire_bytes_per_step=2.5e9)) == 2500.0
    dense = _record(kernel_device_s={}, kernel_calls={}, theta=None, layer_ms={"models": 50.0})
    assert read["fused_compress_roofline"](dense) is None and read["exchange_ms"](dense) is None


@pytest.mark.parametrize("stack,layer", [
    (["torch/nn/functional.py(1): silu", "/x/src/repro_torch/models/layers.py(46): mlp",
      "/x/src/repro_torch/train/step.py(9): body"], "models"),
    (["/x/src/repro_torch/kernels/fused_compress.py(12): f",
      "/x/src/repro_torch/comms/transport.py(1): run"], "exchange"),
    (["/x/src/repro_torch/core/fft.py(3): irfft_rows"], "exchange"),
    (["/x/src/repro_torch/optim/optimizers.py(60): apply_updates"], "optimizer"),
    (["/x/src/repro_torch/train/step.py(170): _all_finite"], "step other"),
    (["/c/perfbench/feed.py(40): batch_at", "/x/src/repro_torch/train/loop.py(1): x"], "data"),
    (["/c/perfbench/program.py(150): hook", "/x/src/repro_torch/train/loop.py(1): x"],
     "harness"),
    (["/c/perfbench/collectives.py(150): __torch_dispatch__",
      "/x/src/repro_torch/comms/transport.py(1): _gather_plane"], "exchange"),
    ([], "models"),
])
def test_layer_of_an_ops_stack(stack, layer):
    assert trace.layer_of(stack)[0] == layer


@pytest.mark.parametrize("name,short", [
    ("void fused_compress_kernel<5, (__nv_bool)0>(float const*, float const*)",
     "fused_compress_kernel"),
    ("void fused_decompress_kernel<unsigned char, short>(unsigned char const*)",
     "fused_decompress_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)",
     "vectorized_elementwise_kernel"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_kernel_name(name, short):
    assert trace.kernel_name(name) == short


def _event(name, start, end, *, device=False, kernels=(), stack=(), thread=1, note=False):
    from types import SimpleNamespace

    dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    kernels = [k if isinstance(k, tuple) else (f"{name}_kernel", k) for k in kernels]
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels],
                           stack=list(stack), thread=thread, is_user_annotation=note)


def test_detail_record_splits_a_step_by_layer_and_names_its_gaps():
    from types import SimpleNamespace

    model = ["/x/src/repro_torch/models/layers.py(46): mlp"]
    optim = ["/x/src/repro_torch/optim/optimizers.py(60): apply_updates"]
    events = [
        _event(trace.STEP_RANGE, 0, 100, note=True),
        _event("aten::mm", 1, 3, kernels=[20], stack=model),
        _event("cudaLaunchKernel", 2, 3),
        _event("mm_kernel", 5, 25, device=True),
        _event("aten::add_", 30, 70, kernels=[30], stack=optim),
        _event("add_kernel", 40, 70, device=True),
        _event("autograd::engine::evaluate_function: MmBackward0", 72, 95, kernels=[10],
               thread=2),
        _event("mm_kernel", 80, 90, device=True),
    ]
    tracer = trace.Tracer(extra_steps=1)
    tracer.detail_prof = SimpleNamespace(events=lambda: events)
    rec = tracer.detail_record()
    # the forward's 20 us and the backward's 10
    assert rec["layer_ms"]["models"] == pytest.approx(0.030)
    assert rec["layer_ms"]["optimizer"] == pytest.approx(0.030)
    assert rec["detail_busy_ms"] == pytest.approx(sum(rec["layer_ms"].values()))
    gaps = dict(rec["idle_gaps"])
    assert gaps["repro_torch/optim/optimizers.py(60): apply_updates"] == pytest.approx(10e-6)
    assert gaps["backward: autograd::engine::evaluate_function: MmBackward0"] == pytest.approx(
        10e-6)
    # [0, 5) and [25, 40): only the step range is open
    assert gaps["no host op"] == pytest.approx(20e-6)


def test_finish_keeps_the_wire_and_asks_again_when_work_is_lost(monkeypatch):
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    model = ["/x/src/repro_torch/models/layers.py(46): mlp"]
    gather = _event("c10d::_allgather_base_", 60, 61,
                    kernels=[("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)", 30)],
                    stack=["/x/src/repro_torch/comms/transport.py(9): _gather_plane"])
    device = [_event("mm_kernel", 5, 55, device=True), _event("nccl", 60, 90, device=True)]
    kept = [_event(trace.STEP_RANGE, 0, 100, note=True), gather,
            _event("aten::mm", 1, 3, kernels=[50], stack=model)] + device
    # the profiler lost the product's kernel: its op kept no record of it
    lost = kept[:2] + [_event("aten::mm", 1, 3, stack=model)] + device[1:]
    stats = {"all-gather": SimpleNamespace(link_bytes=3e9)}
    tracer = trace.Tracer(extra_steps=1, record_collectives=True)
    # 60 us a step of device work, 10 of it a collective's
    tracer.window_rec = {"busy_s": 120e-6, "steps": 2,
                         "kernel_device_s": {"ncclDevKernel_AllGather_RING_LL": 20e-6}}
    for events, again in ((kept, False), (lost, True)):
        tracer.detail_prof = SimpleNamespace(stop=lambda: None, events=lambda: events)
        tracer.recorder = SimpleNamespace(__exit__=lambda *a: None, stats=lambda: stats)
        assert tracer.finish() is again
        assert tracer.detail_rec["wire_bytes_per_step"] == 3e9
        assert tracer.detail_rec["layer_ms"]["transport"] == pytest.approx(0.030)
