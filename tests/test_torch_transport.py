"""Port parity of the exchange paths: the ``allgather`` transport (one
monolithic payload), ``sequenced`` stacked and as the per-bucket loop,
``psum`` stacked and as the loop, ``ReducerConfig``'s fixed quantizer range
(``range_mode="fixed"``), and the ``timedomain``, ``terngrad`` and ``qsgd``
reducers, each with error feedback, and the ``dense`` reducer without it,
over 2 gloo workers against the reference on 2 fake CPU devices; and, in
one process, the per-bucket loop against the batched executor.

Tolerances:
* 2 workers, 2 EF steps (no model, so no bf16): the mean and each worker's
  residual within relative L2 error 1e-3 of the reference (the two FFT
  libraries agree to ~1e-6, which moves a few codes by one step); every
  worker holds the same mean, bitwise (the left-to-right worker fold, or
  one SUM all_reduce); within the port, ``psum``'s mean and residuals are
  bitwise ``sequenced``'s (the reference's own claim,
  ``tests/test_transports.py``);
* one process: the loop and the batched executor give bitwise the same
  local roundtrip and the same mean (per-bucket fits over the same values,
  row-for-row the same transforms).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO, run_with_devices
from repro_torch.comms import bucketing as tb
from repro_torch.comms import transport as tt
from repro_torch.core import compressor as tc

N = 2 * 4096 + 173
BUCKETS = dict(bucket_bytes=4096 * 4)
CASES = {
    "allgather": dict(transport="allgather"),
    "loop": dict(transport="sequenced", stacked=False, **BUCKETS),
    # ReducerConfig's fixed quantizer range through the batched executor
    "fixed": dict(transport="sequenced", range_mode="fixed", fixed_range=[-2.0, 2.0],
                  **BUCKETS),
    "sequenced": dict(transport="sequenced", **BUCKETS),
    "psum": dict(transport="psum", **BUCKETS),
    "psum_loop": dict(transport="psum", stacked=False, **BUCKETS),
    # the baselines: a stacked non-spectral compressor, and two without
    # compress_stacked (the loop), over each gather shape
    "timedomain": dict(kind="timedomain", transport="sequenced", **BUCKETS),
    "terngrad": dict(kind="terngrad", transport="allgather"),
    "qsgd": dict(kind="qsgd", transport="psum", **BUCKETS),
    "dense": dict(kind="dense", error_feedback=False),
}

_PORT_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.comms.reducers import ReducerConfig, make_reducer
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2)
grads = np.load(out + ".in.npy")
for name, cfg in cases.items():
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    reduce = make_reducer(ReducerConfig(backend="auto", **cfg))
    res = torch.zeros(grads.shape[1])
    means = []
    for _ in range(2):
        g = {"w": torch.from_numpy(grads[rank].copy())}
        if cfg["error_feedback"]:
            mean, res = reduce(g, res)
        else:
            mean = reduce(g)
        means.append(mean["w"].numpy())
    np.savez(out + f".{name}.{rank}.npz", means=np.stack(means), res=res.numpy())
dist.destroy_process_group()
"""

_JAX_WORKERS = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.jaxcompat import make_auto_mesh, shard_map as smap
from repro.comms import ReducerConfig, make_reducer
path = {path!r}
grads = {{"w": jnp.asarray(np.load(path + ".in.npy"))}}
mesh = make_auto_mesh((2,), ("data",))
for name, cfg in json.loads({cases!r}).items():
    cfg = {{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}}
    r = make_reducer(ReducerConfig(axis="data", backend="pallas", **cfg))
    def step(g, res):
        g = jax.tree.map(lambda x: x[0], g)
        if not cfg["error_feedback"]:
            return r(g)["w"], res
        out, new_res = r(g, res[0])
        return out["w"], new_res[None]
    f = jax.jit(smap(step, mesh=mesh, in_specs=(P("data"), P("data")),
                     out_specs=(P(), P("data"))))
    res = jnp.zeros((2, grads["w"].shape[1]))
    means = []
    for _ in range(2):
        got, res = f(grads, res)
        means.append(np.asarray(got))
    np.savez(path + f".{{name}}.jax.npz", means=np.stack(means), res=np.asarray(res))
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def two_worker_runs(tmp_path_factory):
    """Both packages run every case once: 2 gloo workers and 2 fake devices."""
    path = str(tmp_path_factory.mktemp("exchange") / "x")
    grads = (np.random.default_rng(0).standard_normal((2, N)) * 0.1).astype(np.float32)
    np.save(path + ".in.npy", grads)
    cases = {name: {**dict(kind="fft", theta=0.7, error_feedback=True, selector="auto"), **cfg}
             for name, cfg in CASES.items()}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               json.dumps(cases)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    out = run_with_devices(_JAX_WORKERS.format(path=path, cases=json.dumps(cases)), devices=2)
    assert "JAX_OK" in out
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
    return path


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_worker_ef_exchange_matches_reference(two_worker_runs, name):
    path = two_worker_runs
    ref = np.load(f"{path}.{name}.jax.npz")
    got = [np.load(f"{path}.{name}.{rank}.npz") for rank in range(2)]
    for rank in range(2):
        for step in range(2):
            assert _rel(got[rank]["means"][step], ref["means"][step]) <= 1e-3
        if CASES[name].get("error_feedback", True):
            assert np.linalg.norm(ref["res"][rank]) > 0
            assert _rel(got[rank]["res"], ref["res"][rank]) <= 1e-3
    np.testing.assert_array_equal(got[0]["means"], got[1]["means"])


@pytest.mark.parametrize("stacked", [True, False])
def test_psum_mean_bitwise_equals_sequenced(two_worker_runs, stacked):
    """psum reduces what sequenced gathers: each worker's dequantized
    spectrum, summed and times 1/2 -- bitwise the same mean and residual."""
    seq, psum = ("sequenced", "psum") if stacked else ("loop", "psum_loop")
    for rank in range(2):
        a = np.load(f"{two_worker_runs}.{seq}.{rank}.npz")
        b = np.load(f"{two_worker_runs}.{psum}.{rank}.npz")
        np.testing.assert_array_equal(a["means"], b["means"])
        np.testing.assert_array_equal(a["res"], b["res"])


@pytest.mark.parametrize("backend,quantize", [("cuda", True), ("reference", True),
                                              ("cuda", False)])
def test_per_bucket_loop_equals_batched_executor(backend, quantize):
    n = 7 * 4096 + 100
    flat = torch.from_numpy(
        (np.random.default_rng(3).standard_normal(n) * 0.05).astype(np.float32))
    layout = tb.build_layout(n, 3 * 4096 * 4)
    assert layout.n_buckets == 3 and not layout.uniform
    assert torch.equal(tb.concat_buckets(tb.split_buckets(flat, layout), layout), flat)
    comp = tc.FFTCompressor(tc.FFTCompressorConfig(backend=backend, selector="sampled",
                                                   quantize=quantize))
    seq = tt.get_transport("sequenced")
    for local in (True, False):
        loop = seq.run(flat, comp=comp, layout=layout, local=local, stacked=False)
        stacked = seq.run(flat, comp=comp, layout=layout, local=local, stacked=True)
        assert loop.shape == flat.shape
        assert torch.equal(loop, stacked)


def test_allgather_roundtrip_is_one_monolithic_payload():
    """allgather ignores the layout: its roundtrip is compress -> decompress
    of the whole buffer with one quantizer fit."""
    flat = torch.from_numpy(
        (np.random.default_rng(4).standard_normal(N) * 0.05).astype(np.float32))
    comp = tc.FFTCompressor(tc.FFTCompressorConfig(backend="cuda", selector="sampled"))
    ag = tt.get_transport("allgather")
    want = comp.decompress(comp.compress(flat))
    for layout in (tb.build_layout(N, None), tb.build_layout(N, 4096 * 4)):
        assert torch.equal(ag.run(flat, comp=comp, layout=layout, local=True), want)
        assert torch.equal(ag.run(flat, comp=comp, layout=layout), want)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.get_transport("hierarchical")


@pytest.mark.parametrize("flags", [["--transport", "allgather"],
                                   ["--transport", "sequenced", "--bucket-mb", "0.25",
                                    "--no-stacked"]])
def test_cli_accepts_allgather_and_the_per_bucket_loop(flags):
    from repro_torch.launch import train

    out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--mode", "compressed_dp", "--error-feedback", *flags])
    rows = out["history"]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0.0 for r in rows)
