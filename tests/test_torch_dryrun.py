"""The port's dry-run (``repro_torch.launch.dryrun``), one spawned module
fixture (a fake world lives only in its own process):

* on a fake world of 1 at the ``(1, 1)`` mesh, reduced gemma2 in ``pjit``
  and in ``compressed_dp`` (fft, error feedback, the kernel path): the
  traced flops, bytes accessed, kernels' custom-op calls and memory equal
  those of the same step run on real CPU tensors, measured the same way;
  and the sharded ``pjit`` step's body plus its host epilogue is bitwise
  the step;
* on the production meshes, a reduced config in ``pjit`` (FSDP),
  ``compressed_dp``, ``hierarchical`` (multi-pod), prefill and decode (and
  decode at batch 1) traces ``ok``, each rank's argument bytes equal to the
  arithmetic of ``state_pspecs`` (train) or of the parameters' specs and
  ``cache_pspecs`` (serving);
* the CLI writes the reference's tag and keys (a skipped cell and a
  full-size decode cell on CPU fakes);
* one reduced ``train`` cell on a ``(2, 2)`` mesh against the reference's
  compiled ``memory_analysis().argument_size_in_bytes`` (its compile takes
  a few seconds): equal but for the reference's two int32 scalars, the
  optimizer count and the step, which the port keeps on the host.

And, in this process, that a kernel's custom op called on fake tensors
returns its shapes and never reaches ``Kernel.launch``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from helpers import REPO, run_with_devices

_WORKER = r"""
import dataclasses, json, math, os, sys, warnings
warnings.simplefilter("ignore")
import torch
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM, registry
from repro_torch.models.sharding import spec_tree_to_pspecs
from repro_torch.models.transformer import init_caches
from repro_torch.optim import OptConfig
from repro_torch.serve.engine import cache_pspecs
from repro_torch.train import build_train_step, init_state
from repro_torch.train.step import StepConfig, state_pspecs
torch.set_num_threads(1)
out = {}
cfg = registry.get_config("gemma2_2b").reduced()
RED = ReducerConfig(kind="fft", theta=0.7, error_feedback=True, transport="sequenced",
                    bucket_bytes=65536, backend="auto", selector="auto")
KEYS = ("flops", "bytes", "kernels", "argument", "temp", "output", "collectives")
with dryrun.fake_world(1):
    mesh = make_local_mesh((1, 1), ("data", "model"), device="cpu")
    for mode in ("pjit", "compressed_dp"):
        red = None if mode == "pjit" else RED
        sh = ShapeConfig("t", 32, 2, "train")
        f = dryrun.trace_cell(cfg, sh, mesh, mode=mode, device="cpu", reducer=red)
        r = dryrun.trace_cell(cfg, sh, mesh, mode=mode, device="cpu", reducer=red, fake=False,
                              generator=torch.Generator().manual_seed(0))
        out["one/" + mode] = {k: [f[k], r[k]] for k in KEYS}
    # the sharded pjit step (DTensor state on the (1, 1) mesh): step() is its
    # body and the host epilogue
    runs = []
    for split in (False, True):
        model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        sc, opt = StepConfig(mode="pjit", fsdp=True), OptConfig(kind="adamw", lr=1e-3)
        state = init_state(model, opt, mesh=mesh, step_cfg=sc)
        step = build_train_step(model, opt, sc, group=mesh)
        toks = torch.randint(0, 256, (2, 17), generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        ms = []
        for _ in range(2):
            if split:
                ms.append({k: float(v) for k, v in step.body(state, batch).items()})
            else:
                ms.append(step(state, batch))
        runs.append((ms, {k: v.to_local().clone() for k, v in model.leaves().items()}))
    out["split_metrics_equal"] = runs[0][0] == runs[1][0]
    out["split_params_equal"] = all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def local_numel(shape, spec, sizes):
    return math.prod(d // sizes[a] if a else d for d, a in zip(shape, spec))


def cache_bytes(caches, specs, sizes):
    total = 0
    for key, c in caches.items():
        pairs = zip(c, specs[key]) if isinstance(c, tuple) else [(c, specs[key])]
        for leaf, spec in pairs:
            for fld in dataclasses.fields(leaf):
                t = getattr(leaf, fld.name)
                if isinstance(t, torch.Tensor):
                    total += local_numel(t.shape, getattr(spec, fld.name), sizes) * t.element_size()
    return total


CELLS = {"pjit": ("pjit", ShapeConfig("t", 32, 32, "train"), False),
         "compressed_dp": ("compressed_dp", ShapeConfig("t", 32, 32, "train"), False),
         "hierarchical": ("hierarchical", ShapeConfig("t", 32, 64, "train"), True),
         "prefill": ("pjit", ShapeConfig("p", 64, 32, "prefill"), False),
         "decode": ("pjit", ShapeConfig("d", 64, 32, "decode"), False),
         "decode_b1": ("pjit", ShapeConfig("d", 64, 1, "decode"), False)}
meta = LM(cfg, device="meta")
for name, (mode, sh, mp) in CELLS.items():
    r = dryrun.run_cell("gemma2_2b", "train_4k", mode=mode, multi_pod=mp, device="cpu", cfg=cfg,
                        shape=sh, out_dir=None, verbose=False)
    sizes = {"pod": 2, "data": 16, "model": 16} if mp else {"data": 16, "model": 16}
    if sh.kind == "train":
        sc = StepConfig(mode=mode, fsdp=mode == "pjit", multi_pod=mp)
        pspecs = state_pspecs(meta, OptConfig(kind="adamw"), sc, sizes)["params"]
        params = sum(local_numel(s.shape, pspecs[k], sizes) for k, s in meta.spec().items()) * 4
        workers = sizes["data"] * sizes.get("pod", 1)
        want = 3 * params + 2 * (sh.global_batch // workers) * sh.seq_len * 4
    else:
        pspecs = spec_tree_to_pspecs(meta.spec(), sizes)
        params = sum(local_numel(s.shape, pspecs[k], sizes) for k, s in meta.spec().items()) * 2
        b = sh.global_batch
        rows = b // sizes["data"] if b > 1 and b % sizes["data"] == 0 else b
        if sh.kind == "prefill":
            want = params + rows * sh.seq_len * 4
        else:
            full = init_caches(cfg, b, sh.seq_len, device="meta")
            specs = cache_pspecs(full, cfg, b, sizes)
            want = params + cache_bytes(full, specs, sizes) + rows * 4
            out["specs/" + name] = {k: [list(map(str, l)) for l in (v.k,)]
                                    for k, v in specs.items()}
    out["cell/" + name] = {"status": r["status"],
                           "argument": r["memory"]["argument_size_gib"] * 2**30,
                           "want": want, "kernels": r["kernel_calls"],
                           "collectives": r["collectives"]}
r = dryrun.run_cell("gemma2_2b", "train_4k", shape=ShapeConfig("t", 32, 4, "train"), device="cpu",
                    cfg=cfg, mesh_shape=(2, 2), out_dir=None, verbose=False)
out["ref_cell_argument"] = r["memory"]["argument_size_gib"] * 2**30
d = sys.argv[1]
dryrun.main(["--arch", "qwen1_5_110b", "--shape", "long_500k", "--device", "cpu", "--out", d])
dryrun.main(["--arch", "gemma2_2b", "--shape", "decode_32k", "--device", "cpu", "--out", d])
out["cli"] = {f: json.load(open(os.path.join(d, f))) for f in sorted(os.listdir(d))}
print("RESULT " + json.dumps(out))
"""

_REFERENCE = r"""
from repro import jaxcompat as compat
from repro.configs.base import ShapeConfig
from repro.launch import dryrun
from repro.models import registry
cfg = registry.get_config("gemma2_2b").reduced()
mesh = compat.make_auto_mesh((2, 2), ("data", "model"))
with compat.set_mesh(mesh):
    compiled, _, _ = dryrun._lower_cell(cfg, ShapeConfig("t", 32, 4, "train"), mesh,
                                        dict(mesh.shape), multi_pod=False, mode="pjit", theta=0.7)
print("ARGUMENT", compiled.memory_analysis().argument_size_in_bytes)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    proc = subprocess.Popen([sys.executable, "-c", _WORKER, out_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ref = run_with_devices(_REFERENCE, devices=4)
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    line = [l for l in stdout.splitlines() if l.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    out["reference_argument"] = int(ref.split("ARGUMENT")[-1].split()[0])
    return out


@pytest.mark.parametrize("mode", ["pjit", "compressed_dp"])
def test_trace_equals_a_real_run(runs, mode):
    got = runs["one/" + mode]
    for key, (fake, real) in got.items():
        assert fake == real, (key, fake, real)
    assert got["flops"][0] > 0 and got["bytes"][0] > 0 and got["temp"][0] > 0
    if mode == "compressed_dp":
        # the EF roundtrip and the exchange each compress: B4 and B2 twice a step
        assert got["kernels"][0] == {"sampled_threshold": 2, "fused_compress": 2}


def test_sharded_step_is_its_body_and_epilogue(runs):
    assert runs["split_metrics_equal"] and runs["split_params_equal"]


@pytest.mark.parametrize("name", ["pjit", "compressed_dp", "hierarchical", "prefill", "decode",
                                  "decode_b1"])
def test_production_cells_trace_with_their_argument_bytes(runs, name):
    cell = runs["cell/" + name]
    assert cell["status"] == "ok"
    assert cell["argument"] == cell["want"], cell
    if name in ("compressed_dp", "hierarchical"):
        assert cell["kernels"] == {"sampled_threshold": 1, "fused_compress": 1}
    if name == "pjit":  # FSDP: gathered over data at use, gradients reduce-scattered
        assert {"all-gather", "reduce-scatter"} <= set(cell["collectives"])


def test_decode_at_batch_one_puts_model_on_heads_or_head_dim(runs):
    for key, (k_spec,) in runs["specs/decode_b1"].items():
        assert k_spec[1] == "None" and k_spec[2] == "data" and "model" in k_spec[3:], k_spec
    for key, (k_spec,) in runs["specs/decode"].items():
        assert k_spec[1] == "data" and k_spec[2] == "model", k_spec


def test_argument_bytes_against_reference_compile(runs):
    # the reference's state also holds the optimizer count and the step as
    # int32 scalars; the port keeps both as host ints
    assert runs["ref_cell_argument"] + 8 == runs["reference_argument"]


def test_cli_writes_the_reference_tag_and_keys(runs):
    cli = runs["cli"]
    assert set(cli) == {"qwen1_5_110b__long_500k__single__pjit.json",
                        "gemma2_2b__decode_32k__single__pjit.json"}
    skipped = cli["qwen1_5_110b__long_500k__single__pjit.json"]
    assert skipped["status"] == "skipped" and "500k" in skipped["reason"]
    cell = cli["gemma2_2b__decode_32k__single__pjit.json"]
    assert cell["status"] == "ok" and cell["chips"] == 256 and cell["kind"] == "decode"
    assert set(cell["memory"]) == {"argument_size_gib", "output_size_gib", "temp_size_gib"}
    assert set(cell["cost"]) == {"flops", "bytes accessed"}
    assert set(cell["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant",
                                     "step_time_s", "roofline_fraction", "useful_ratio"}
    assert cell["collectives"]["all-reduce"]["count"] > 0


def _fake_inputs():
    """Each kernel's wrapper and its arguments, made under the caller's
    FakeTensorMode, with the output shapes it must give."""
    from repro_torch.kernels import (fft4step, fused_compress, fused_decompress, pack,
                                     range_quant, sampled_threshold, topk_threshold)

    mag = torch.empty(4, 100)
    col = torch.empty(4, 1)
    re = torch.empty(4, 2049)
    w = torch.empty(2049)
    eps, p = torch.tensor(0.01), torch.tensor(100.0)
    codes = torch.empty(4, 384, dtype=torch.uint8)
    idx = torch.empty(4, 384, dtype=torch.int32)
    x = torch.empty(4, 4096)
    return [
        (lambda: topk_threshold.threshold(mag, k=10), [(4, 1), (4, 1)]),
        (lambda: sampled_threshold.sampled_select(mag, k=10), [(4, 1)] * 3),
        (lambda: fused_compress.fused_compress(re, re, w, eps, p, col, k_keep=300),
         [(4, 384)] * 3 + [(4, 1)]),
        (lambda: fused_compress.fused_compress(re, re, w, eps, p, k_keep=300),
         [(4, 384)] * 3 + [(4, 1)]),
        (lambda: fused_decompress.fused_decompress(codes, codes, idx, eps, p), [(4, 4096)]),
        (lambda: range_quant.encode(x, eps, p), [(4, 4096)]),
        (lambda: range_quant.decode(codes, eps, p), [(4, 384)]),
        (lambda: pack.pack(x, col, k=128), [(4, 128), (4, 128)]),
        (lambda: pack.unpack(x[:, :128], idx[:, :128], cols=4096), [(4, 4096)]),
        (lambda: fft4step.fft4096(x, x), [(4, 4096), (4, 4096)]),
    ]


def test_kernel_ops_on_fake_tensors_never_launch(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.kernels import _checks
    from repro_torch.kernels.build import Kernel

    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached Kernel.launch")

    monkeypatch.setattr(Kernel, "launch", refuse)
    monkeypatch.setattr(_checks, "on_cpu", lambda t: False)  # the CUDA branch, if reached
    with FakeTensorMode():
        for fn, shapes in _fake_inputs():
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            assert [tuple(t.shape) for t in out] == shapes
            assert all(isinstance(t, FakeTensor) for t in out)
