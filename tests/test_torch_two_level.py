"""Port parity of the two-level exchange: the ``hierarchical`` and
``reduce_scatter`` transports, the ``hierarchical`` reducer kind, the ring
collectives and the two-level mesh, over 4 gloo workers on a ``(2, 2)``
``("node", "local")`` mesh against the reference on 4 fake CPU devices.
Every case runs once in a module-scoped fixture (both packages), on the
reference test's correlated low-pass gradients (a shared low-pass signal
plus a tenth of per-worker low-pass jitter, ``tests/test_transports.py``).

Tolerances:
* the means and residuals against the reference's: relative L2 error 1e-3
  (the two packages' FFT libraries agree to ~1e-6, which moves a few codes
  by one step or swaps a few bins across the kept-set threshold); for the
  unquantized stacked cases the kept bins of the mean's spectrum may differ
  from the reference's on at most 1% of them (kept-set flips);
* ``reduce_scatter`` against the port's own ``psum``: max abs 1e-5 (the
  reference's bound; with 4 workers the backends' sum order is not the
  reference's fold, so no bitwise claim); ``hierarchical`` against ``psum``:
  relative L2 5% (the reference's envelope: the node mean is compressed
  once per island instead of each worker's gradient);
* every rank holds bitwise the same mean;
* error feedback: the residuals of ``psum``, ``hierarchical`` and
  ``reduce_scatter`` agree within 1e-6 (each is this worker's own
  roundtrip), and within relative L2 1e-3 of the reference's;
* the rings: bitwise the reference's rings (the same step order and sum
  order); ``run(plan=...)`` bitwise ``run(layout=...)``;
* the ``hierarchical`` kind: the payload verdicts bitwise the reference's,
  with a payload corruption and a poisoned gradient at FaultPlan worker
  coordinates that are not the ranks of the workers they hit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO, run_with_devices

N = 3 * 4096 + 173
WORKERS = 4
BUCKETS = dict(bucket_bytes=4096 * 4)
FFT = dict(kind="fft", theta=0.7, selector="auto")
# name -> (reducer kwargs, steps); run by both packages unless PORT_ONLY
CASES = {
    "hier_q": (dict(FFT, transport="hierarchical", **BUCKETS), 1),
    "hier": (dict(FFT, transport="hierarchical", quantize=False, **BUCKETS), 1),
    "hier_loop": (dict(FFT, transport="hierarchical", stacked=False, **BUCKETS), 1),
    "rs_q": (dict(FFT, transport="reduce_scatter", **BUCKETS), 1),
    "rs": (dict(FFT, transport="reduce_scatter", quantize=False, **BUCKETS), 1),
    "rs_loop": (dict(FFT, transport="reduce_scatter", stacked=False, **BUCKETS), 1),
    "psum": (dict(FFT, transport="psum", quantize=False, **BUCKETS), 1),
    "psum_q": (dict(FFT, transport="psum", **BUCKETS), 1),
    # the reference's EF parity test: theta 0.8, unquantized, 3 steps
    "ef_psum": (dict(FFT, theta=0.8, transport="psum", quantize=False, error_feedback=True,
                     **BUCKETS), 3),
    "ef_hier": (dict(FFT, theta=0.8, transport="hierarchical", quantize=False,
                     error_feedback=True, **BUCKETS), 3),
    "ef_rs": (dict(FFT, theta=0.8, transport="reduce_scatter", quantize=False,
                   error_feedback=True, **BUCKETS), 3),
    # the non-spectral compressors: timedomain stacked, qsgd the loop
    "td_hier": (dict(kind="timedomain", theta=0.7, transport="hierarchical", **BUCKETS), 1),
    "td_rs": (dict(kind="timedomain", theta=0.7, transport="reduce_scatter", **BUCKETS), 1),
    "qsgd_hier": (dict(kind="qsgd", transport="hierarchical", **BUCKETS), 1),
    "qsgd_rs": (dict(kind="qsgd", transport="reduce_scatter", **BUCKETS), 1),
    # the hierarchical kind with EF, validated in full: a corrupted payload
    # at step 1 and a poisoned gradient at step 2, both at FaultPlan worker
    # coordinates (local_index * nodes + node_index) that are not the rank
    "kind": (dict(kind="hierarchical", theta=0.7, selector="auto", transport="sequenced",
                  error_feedback=True, validate="full", **BUCKETS), 3),
}
PORT_ONLY = ("psum", "psum_q")
FAULTS = [["payload_corrupt", 1, 1, "values"], ["nan_grad", 2, 2]]
# the FaultPlan coordinates above land on these ranks (node * 2 + local)
CORRUPTED_RANK, POISONED_RANK = 2, 1
RING_SHAPE = (8, 5)

_PORT_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.comms import bucketing, collectives, faults, scheduler, transport
from repro_torch.comms.reducers import ReducerConfig, fault_worker, make_reducer
from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig
from repro_torch.launch.mesh import make_two_level_mesh
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases, fault_events = json.loads(sys.argv[4]), json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
try:
    make_two_level_mesh(3)
    uneven = ""
except ValueError as e:
    uneven = str(e)
mesh = make_two_level_mesh(2)
np.savez(path + f".mesh.{rank}.npz", coords=np.array(mesh.coords),
         node=np.array(dist.get_process_group_ranks(mesh.node)),
         local=np.array(dist.get_process_group_ranks(mesh.local)), uneven=np.array(uneven))
grads = np.load(path + ".in.npy")
plan = faults.FaultPlan(tuple(faults.NanGrad(s, w) if kind == "nan_grad"
                              else faults.PayloadCorrupt(s, w, *rest)
                              for kind, s, w, *rest in fault_events))
for name, (cfg, steps) in cases.items():
    config = ReducerConfig(backend="auto", faults=plan if name == "kind" else None, **cfg)
    reduce = make_reducer(config, group=mesh)
    worker = fault_worker(config, mesh)
    res = torch.zeros(grads.shape[1])
    means, ress, oks = [], [], []
    for step in range(steps):
        g = torch.from_numpy(grads[rank].copy())
        if name == "kind" and faults.match_events(plan.nan_events, step, worker):
            g.fill_(float("nan"))
        extra = {"step": step} if config.resilient else {}
        out = reduce({"w": g}, res, **extra) if config.error_feedback else reduce({"w": g}, **extra)
        if not isinstance(out, tuple):
            out = (out,)
        mean = out[0]
        if config.error_feedback:
            res = out[1]
        means.append(mean["w"].numpy())
        ress.append(res.numpy().copy())
        oks.append(bool(out[-1]) if config.resilient else True)
    np.savez(path + f".{name}.{rank}.npz", means=np.stack(means), res=np.stack(ress),
             ok=np.array(oks))
x = torch.from_numpy(np.load(path + ".ring.npy")[rank])
rings = {}
for label, group in (("flat", mesh.flat), ("local", mesh.local)):
    rings[label + "_ag"] = collectives.ring_all_gather(x, group).numpy()
    rings[label + "_agr"] = collectives.ring_all_gather(x, group, reverse=True).numpy()
    rings[label + "_rs"] = collectives.ring_reduce_scatter(x, group).numpy()
    rings[label + "_ar"] = collectives.ring_all_reduce(
        x[:7], group, shard_hook=lambda s: s * 3.0).numpy()
np.savez(path + f".rings.{rank}.npz", **rings)
comp = FFTCompressor(FFTCompressorConfig(backend="cuda", selector="sampled"))
layout = bucketing.build_layout(grads.shape[1], 4096 * 4)
flat = torch.from_numpy(grads[rank].copy())
plans = {}
# reduce_scatter over 2 workers (mesh.local), where any sum order is the
# same, and over all 4 (the backend's order, which depends on the size)
for label, name, group in (("hierarchical", "hierarchical", mesh),
                           ("reduce_scatter", "reduce_scatter", mesh.local),
                           ("reduce_scatter_4", "reduce_scatter", mesh)):
    tr = transport.get_transport(name)
    plans[label + "_layout"] = tr.run(flat, comp=comp, layout=layout, group=group).numpy()
    plans[label + "_plan"] = tr.run(flat, comp=comp, plan=scheduler.build_plan(layout, 2),
                                    group=group).numpy()
np.savez(path + f".plans.{rank}.npz", **plans)
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""

_JAX_WORKERS = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.jaxcompat import make_auto_mesh, shard_map as smap
from repro.comms import ReducerConfig, collectives, faults, make_reducer
path = {path!r}
cases, fault_events = json.loads({cases!r}), json.loads({faults!r})
grads = jnp.asarray(np.load(path + ".in.npy"))
plan = faults.FaultPlan(tuple(faults.NanGrad(s, w) if kind == "nan_grad"
                              else faults.PayloadCorrupt(s, w, *rest)
                              for kind, s, w, *rest in fault_events))
two = make_auto_mesh((2, 2), ("node", "local"))
pods = make_auto_mesh((2, 2), ("pod", "data"))
for name, (cfg, steps) in cases.items():
    if name == "kind":
        mesh, axes = pods, ("pod", "data")
        config = ReducerConfig(axis="data", pod_axis="pod", backend="reference", faults=plan,
                               **cfg)
    else:
        mesh, axes = two, ("node", "local")
        config = ReducerConfig(axis=axes, backend="reference", **cfg)
    r = make_reducer(config)

    def step(g, res, s):
        g, res = g[0], res[0]
        if name == "kind":
            # the reducer's FaultPlan coordinate: (axis, pod_axis) row-major
            hit = faults.match_events(plan.nan_events, s,
                                      collectives.axis_linear_index(("data", "pod")))
            g = jnp.where(hit, jnp.nan, g)
        extra = {{"step": s}} if config.resilient else {{}}
        out = r({{"w": g}}, res, **extra) if config.error_feedback else r({{"w": g}}, **extra)
        if not isinstance(out, tuple):
            out = (out,)
        new_res = out[1] if config.error_feedback else res
        ok = out[-1] if config.resilient else jnp.bool_(True)
        return out[0]["w"][None], new_res[None], jnp.asarray(ok)[None]

    f = jax.jit(smap(step, mesh=mesh, in_specs=(P(axes), P(axes), P()),
                     out_specs=(P(axes), P(axes), P(axes))))
    res = jnp.zeros_like(grads)
    means, ress, oks = [], [], []
    for s in range(steps):
        mean, res, ok = f(grads, res, jnp.int32(s))
        means.append(np.asarray(mean))
        ress.append(np.asarray(res))
        oks.append(np.asarray(ok))
    np.savez(path + f".{{name}}.jax.npz", means=np.stack(means, 1), res=np.stack(ress, 1),
             ok=np.stack(oks, 1))
x = jnp.asarray(np.load(path + ".ring.npy"))


def rings(axis):
    def body(v):
        v = v[0]
        return tuple(o[None] for o in (
            collectives.ring_all_gather(v, axis),
            collectives.ring_all_gather(v, axis, reverse=True),
            collectives.ring_reduce_scatter(v, axis),
            collectives.ring_all_reduce(v[:7], axis, shard_hook=lambda s: s * 3.0)))
    return body


out = {{}}
for label, mesh, axes, axis in (("flat", make_auto_mesh((4,), ("data",)), ("data",), "data"),
                                ("local", two, ("node", "local"), "local")):
    got = jax.jit(smap(rings(axis), mesh=mesh, in_specs=P(axes), out_specs=(P(axes),) * 4))(x)
    for suffix, val in zip(("ag", "agr", "rs", "ar"), got):
        out[label + "_" + suffix] = np.asarray(val)
np.savez(path + ".rings.jax.npz", **out)
print("JAX_OK")
"""


def _lowpass(rng, rows: int) -> np.ndarray:
    """Rows of white noise through a 64-tap moving average: spectral energy
    concentrated at low frequencies, as real gradients have it."""
    raw = rng.standard_normal((rows, N + 63))
    kernel = np.ones(64) / 64.0
    return np.stack([np.convolve(r, kernel, mode="valid")[:N] for r in raw])


@pytest.fixture(scope="module")
def two_level_runs(tmp_path_factory):
    """Both packages run every case once: 4 gloo workers on a (2, 2) mesh
    and 4 fake devices."""
    path = str(tmp_path_factory.mktemp("two_level") / "x")
    rng = np.random.default_rng(0)
    grads = (_lowpass(rng, 1) + 0.1 * _lowpass(rng, WORKERS)).astype(np.float32)
    np.save(path + ".in.npy", grads)
    np.save(path + ".ring.npy", rng.standard_normal((WORKERS,) + RING_SHAPE).astype(np.float32))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_WORKER, str(rank), str(port), path,
                               json.dumps(CASES), json.dumps(FAULTS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORKERS)]
    ref_cases = {k: v for k, v in CASES.items() if k not in PORT_ONLY}
    out = run_with_devices(_JAX_WORKERS.format(path=path, cases=json.dumps(ref_cases),
                                               faults=json.dumps(FAULTS)), devices=WORKERS)
    assert "JAX_OK" in out
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
    return path


def _port(path, name):
    return [np.load(f"{path}.{name}.{rank}.npz") for rank in range(WORKERS)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _kept_bins(x: np.ndarray) -> np.ndarray:
    """The bins of a mean's chunked spectrum that carry energy (a mean of
    unquantized kept sets is zero elsewhere, up to the irfft's rounding)."""
    n_chunks = -(-x.shape[0] // 4096)
    spec = np.abs(np.fft.rfft(np.pad(x, (0, n_chunks * 4096 - x.shape[0])).reshape(-1, 4096)))
    return spec > 1e-4 * spec.max()


MEAN_CASES = ["hier_q", "hier", "hier_loop", "rs_q", "rs", "rs_loop", "td_hier", "td_rs",
              "qsgd_hier", "qsgd_rs"]


@pytest.mark.parametrize("name", MEAN_CASES)
def test_two_level_mean_matches_reference(two_level_runs, name):
    ref = np.load(f"{two_level_runs}.{name}.jax.npz")
    got = _port(two_level_runs, name)
    for rank in range(WORKERS):
        assert _rel(got[rank]["means"][0], ref["means"][rank, 0]) <= 1e-3
        np.testing.assert_array_equal(got[rank]["means"], got[0]["means"])
    if name in ("hier", "rs"):
        mine, theirs = _kept_bins(got[0]["means"][0]), _kept_bins(ref["means"][0, 0])
        assert np.count_nonzero(mine != theirs) <= 0.01 * np.count_nonzero(theirs)


@pytest.mark.parametrize("quantize", [True, False])
def test_two_level_means_against_psum(two_level_runs, quantize):
    """reduce_scatter reduces what psum reduces (max abs 1e-5); hierarchical
    stays within psum's 5% envelope on correlated gradients."""
    suffix = "_q" if quantize else ""
    psum = _port(two_level_runs, "psum" + suffix)[0]["means"][0]
    rs = _port(two_level_runs, "rs" + suffix)[0]["means"][0]
    hier = _port(two_level_runs, "hier" + suffix)[0]["means"][0]
    assert np.abs(rs - psum).max() < 1e-5
    assert _rel(hier, psum) < 0.05


@pytest.mark.parametrize("name", ["ef_psum", "ef_hier", "ef_rs"])
def test_two_level_error_feedback(two_level_runs, name):
    ref = np.load(f"{two_level_runs}.{name}.jax.npz")
    got = _port(two_level_runs, name)
    base = _port(two_level_runs, "ef_psum")
    for rank in range(WORKERS):
        res = got[rank]["res"]
        assert np.linalg.norm(res) > 0
        assert np.abs(res - base[rank]["res"]).max() < 1e-6
        for step in range(3):
            assert _rel(res[step], ref["res"][rank, step]) <= 1e-3
            assert _rel(got[rank]["means"][step], ref["means"][rank, step]) <= 1e-3
        np.testing.assert_array_equal(got[rank]["means"], got[0]["means"])
    if name == "ef_rs":
        assert np.abs(got[0]["means"] - base[0]["means"]).max() < 1e-5


def test_hierarchical_kind_matches_reference(two_level_runs):
    """The kind's dense island mean, its exchange over the node group and
    its FaultPlan coordinate.  The corrupted payload is plan worker 1, rank
    2: only rank 2 validates its own payload (and fails), and the node
    group that gathers it (ranks 0 and 2) gets another mean than ranks 1
    and 3.  The poisoned gradient is plan worker 2, rank 1: its island's
    dense mean, and so the residuals of ranks 0 and 1, are NaN."""
    ref = np.load(f"{two_level_runs}.kind.jax.npz")
    got = _port(two_level_runs, "kind")
    oks = np.stack([g["ok"] for g in got])
    np.testing.assert_array_equal(oks, ref["ok"].astype(bool))
    want = np.ones_like(oks)
    want[CORRUPTED_RANK, 1] = False
    np.testing.assert_array_equal(oks, want)
    for rank in range(WORKERS):
        mean, res = got[rank]["means"], got[rank]["res"]
        for step in range(3):
            assert _rel(mean[step], ref["means"][rank, step]) <= 1e-3
        for step in range(2):
            assert _rel(res[step], ref["res"][rank, step]) <= 1e-3
        np.testing.assert_array_equal(np.isnan(res[2]), np.isnan(ref["res"][rank, 2]))
        assert np.isnan(res[2]).all() == (rank // 2 == POISONED_RANK // 2)
    step1 = [g["means"][1] for g in got]
    np.testing.assert_array_equal(step1[0], step1[CORRUPTED_RANK])
    assert _rel(step1[0], step1[1]) > 0.1


@pytest.mark.parametrize("name", ["ag", "agr", "rs", "ar"])
@pytest.mark.parametrize("group", ["flat", "local"])
def test_rings_bitwise_reference(two_level_runs, group, name):
    ref = np.load(f"{two_level_runs}.rings.jax.npz")[f"{group}_{name}"]
    for rank in range(WORKERS):
        got = np.load(f"{two_level_runs}.rings.{rank}.npz")[f"{group}_{name}"]
        np.testing.assert_array_equal(got, ref[rank])


@pytest.mark.parametrize("transport", ["hierarchical", "reduce_scatter", "reduce_scatter_4"])
def test_run_plan_bitwise_run_layout(two_level_runs, transport):
    """Bitwise where every sum is over at most 2 workers or a fixed fold
    (hierarchical on the (2, 2) mesh, reduce_scatter over 2 workers); over
    4 workers reduce_scatter's sum order is the backend's and depends on
    the message's size, so a dispatch group's shard may round otherwise
    (max abs 1e-5, the reference's bound against psum)."""
    for rank in range(WORKERS):
        got = np.load(f"{two_level_runs}.plans.{rank}.npz")
        plan, layout = got[transport + "_plan"], got[transport + "_layout"]
        if transport == "reduce_scatter_4":
            assert np.abs(plan - layout).max() < 1e-5
        else:
            np.testing.assert_array_equal(plan, layout)


def test_mesh_is_node_major_with_named_errors(two_level_runs):
    from repro_torch.launch import mesh as tm

    for rank in range(WORKERS):
        got = np.load(f"{two_level_runs}.mesh.{rank}.npz")
        node, local = divmod(rank, 2)
        assert tuple(got["coords"]) == (node, local)
        assert list(got["local"]) == [2 * node, 2 * node + 1]
        assert list(got["node"]) == [local, 2 + local]
        assert "do not split evenly across 3 nodes" in str(got["uneven"])
    # no process group: one worker
    mesh = tm.make_two_level_mesh(1)
    assert mesh.topology == (1, 1) and mesh.node is None and mesh.local is None
    with pytest.raises(ValueError, match="needs 2 workers"):
        tm.make_two_level_mesh(2, local=1)
    with pytest.raises(ValueError, match="do not split evenly"):
        tm.make_two_level_mesh(2)
    with pytest.raises(ValueError, match="non-positive"):
        tm.make_local_mesh((1, 0))
    with pytest.raises(ValueError, match="nodes must be >= 1"):
        tm.make_two_level_mesh(0)
    with pytest.raises(ValueError, match="explicit axes"):
        tm.make_local_mesh((1, 1, 1))


def test_axis_arithmetic_over_groups_meshes_and_names():
    """The reference's axis helpers over the port's specs: a group (no
    process group: one worker), a mesh, a mesh's axis names."""
    from repro.comms import collectives as jcol
    from repro_torch.comms import collectives as tcol
    from repro_torch.launch.mesh import Mesh

    for spec in ("data", ["node", "local"], ("pod",)):
        assert tcol.normalize_axes(spec) == jcol.normalize_axes(spec)
    for bad in ((), [1]):
        with pytest.raises(ValueError):
            tcol.normalize_axes(bad)
    mesh = Mesh(("node", "local"), (2, 3), (1, 0), (None, None))
    assert tcol.axis_sizes(mesh) == (2, 3) and tcol.axis_size(mesh) == 6
    assert tcol.axis_sizes("local", mesh=mesh) == (3,)
    assert tcol.axis_size(("local", "node"), mesh=mesh) == 6
    assert tcol.axis_linear_index(mesh) == 3  # node-major: the rank
    assert tcol.axis_linear_index(("local", "node"), mesh=mesh) == 1
    assert tcol.axis_size() == 1 and tcol.axis_linear_index() == 0
    with pytest.raises(ValueError, match="need mesh="):
        tcol.axis_size("node")


def test_cli_trains_four_gloo_workers_on_two_nodes():
    """``--nodes 2 --transport hierarchical`` under 4 gloo processes (a
    (2, 2) mesh): every rank trains on its own rows, and the exchanged mean
    and the metrics averaged over the mesh's flat group keep the ranks'
    histories identical."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import json, sys; from repro_torch.launch import train; "
            "r = train.main(sys.argv[1:]); print('HISTORY', json.dumps("
            "[{k: v for k, v in row.items() if k != 'dt'} for row in r['history']]))")
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
            "--mode", "compressed_dp", "--nodes", "2", "--transport", "hierarchical",
            "--bucket-mb", "0.25", "--error-feedback"]
    procs = []
    for rank in range(WORKERS):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), RANK=str(rank),
                   WORLD_SIZE=str(WORKERS), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    histories = []
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
        histories.append(json.loads(log.split("HISTORY", 1)[1]))
    assert all(h == histories[0] for h in histories)
    assert [row["step"] for row in histories[0]] == [0, 1]
    assert all(np.isfinite(row["loss"]) and row["skipped"] == 0.0 for row in histories[0])
