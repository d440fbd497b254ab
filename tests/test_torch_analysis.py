"""The dry-run's analysis (``repro_torch.analysis``) against the reference's
(``repro.analysis``): the ring model, record for record, against the
reference's HLO parser on HLO lines written from the same records (every
kind, group sizes 2 to 512, async ``-start``/``-done`` pairs); the roofline
with the reference's ``V5E`` passed in, ``as_dict()`` equal; and, in a
spawned process over a fake world of 16 ranks, the recorder seeing
``torch.distributed``'s and ``DTensor``'s collectives with their bytes and
group sizes, counted as ``CommDebugMode`` counts them.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro_torch.analysis import collectives as C
from repro_torch.analysis import roofline as R

GROUPS = (2, 8, 16, 64, 512)
DTYPES = {"f32": 4, "bf16": 2, "s32": 4, "u8": 1}


def _records(seed=0):
    """Records of every kind at every group size, with their HLO lines: a
    payload of ``rows x cols`` elements of one dtype, the group written as
    an iota or an explicit list, some kinds as an async start and done."""
    rng = np.random.default_rng(seed)
    recs, lines = [], []
    for i, (kind, n) in enumerate((k, n) for k in C.OP_KINDS for n in GROUPS):
        dtype = list(DTYPES)[i % len(DTYPES)]
        rows, cols = (int(x) for x in rng.integers(1, 300, 2))
        payload = rows * cols * DTYPES[dtype]
        shape = f"{dtype}[{rows},{cols}]{{1,0}}"
        if kind == "collective-permute":
            recs.append(C.Collective(kind, float(payload), 1, "send"))
            groups = "source_target_pairs={{0,1},{1,0}}"
        else:
            recs.append(C.Collective(kind, float(payload), n, kind))
            groups = (f"replica_groups=[{512 // n},{n}]<=[512]" if i % 2 else
                      "replica_groups={{" + ",".join(map(str, range(n))) + "}}")
        if i % 3 == 0:  # async: the start carries the payload, the done does not count
            lines.append(f"  %s{i} = {shape} {kind}-start({shape} %p{i}), {groups}")
            lines.append(f"  %d{i} = {shape} {kind}-done({shape} %s{i})")
        else:
            lines.append(f"  %c{i} = {shape} {kind}({shape} %p{i}), {groups}")
    lines.append("  %a = f32[8]{0} add(f32[8] %x, f32[8] %y)")
    return recs, "\n".join(lines)


def test_ring_model_equals_reference_parser():
    recs, text = _records()
    ours = C.summarize(C.stats_of(recs))
    ref = jhlo.summarize(jhlo.parse_collectives(text))
    assert set(ours) == set(C.OP_KINDS)
    assert ours == ref


def test_link_bytes_formulas():
    for n in GROUPS:
        assert C.link_bytes("all-reduce", 96.0, n) == 2.0 * 96.0 * (n - 1) / n
        assert C.link_bytes("reduce-scatter", 96.0, n) == 96.0 * (n - 1)
        assert C.link_bytes("collective-permute", 96.0, n) == 96.0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_equals_reference_with_v5e(kind):
    recs, _ = _records(1)
    coll = C.summarize(C.stats_of(recs))
    cost = {"flops": 3.7e15, "bytes accessed": 9.1e12}
    args = dict(cost=cost, collectives=coll, chips=256, n_active_params=2.6e9,
                tokens=1048576, kind=kind)
    v5e = R.HW(**dataclasses.asdict(jroof.V5E))
    ours = R.compute_roofline(hw=v5e, **args).as_dict()
    ref = jroof.compute_roofline(hw=jroof.V5E, **args).as_dict()
    assert ours == ref
    assert R.model_flops(2.6e9, 100, kind) == jroof.model_flops(2.6e9, 100, kind)


def test_h100_is_the_default():
    assert R.H100 == R.HW()
    assert (R.H100.peak_flops, R.H100.hbm_bw, R.H100.ici_bw, R.H100.dcn_bw,
            R.H100.chips_per_pod) == (989.4e12, 3.35e12, 450e9, 50e9, 8)
    terms = R.compute_roofline(cost={"flops": 989.4e12, "bytes accessed": 3.35e12},
                               collectives={"all-reduce": {"link_bytes": 450e9}}, chips=8,
                               n_active_params=1.0, tokens=1.0, kind="decode")
    assert terms.compute_s == terms.memory_s == terms.collective_s == 1.0
    assert terms.dcn_bytes == 0.0  # the reference code's charge rule (ROADMAP.md §3)


_FAKE_WORLD = r"""
import json, sys, warnings
warnings.simplefilter("ignore")
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.analysis.collectives import CollectiveRecorder
from repro_torch.dist_util import init_fake_world
from repro_torch.launch.mesh import make_local_mesh
init_fake_world(16)
mesh = make_local_mesh((4, 4), ("data", "model"), device="cpu")
dm = mesh.device_mesh
with FakeTensorMode():
    x = torch.ones(6, 8)
    with CommDebugMode() as cdm, CollectiveRecorder() as rec:
        dist.all_reduce(x, group=mesh.group("model"))
        dist.all_reduce(x.to(torch.bfloat16), group=mesh.flat)
        dist.all_gather([torch.empty(6, 8) for _ in range(4)], x, group=mesh.group("data"))
        dist.all_gather_into_tensor(torch.empty(24, 8), x, group=mesh.group("data"))
        dist.reduce_scatter_tensor(torch.empty(6, 2), torch.ones(6, 8), group=mesh.group("model"))
        dist.all_to_all_single(torch.empty(8, 8), torch.ones(8, 8), group=mesh.group("data"))
        d = DTensor.from_local(torch.ones(2, 8), dm, [Shard(0), Replicate()], run_check=False)
        d.redistribute(dm, [Replicate(), Replicate()])
        g = DTensor.from_local(torch.ones(8, 8), dm, [Partial(), Replicate()], run_check=False)
        g.redistribute(dm, [Shard(0), Replicate()])
        g.redistribute(dm, [Replicate(), Replicate()])
counts = {str(k): v for k, v in cdm.get_comm_counts().items()}
print(json.dumps({"records": [[r.kind, r.payload, r.group, r.op] for r in rec.records],
                  "cdm": counts, "summary": rec.summary()}))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake_world_records():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE_WORLD], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_recorder_sees_dist_and_dtensor_collectives(fake_world_records):
    recs = [tuple(r) for r in fake_world_records["records"]]
    assert recs == [
        ("all-reduce", 192.0, 4, "allreduce_"),
        ("all-reduce", 96.0, 16, "allreduce_"),
        ("all-gather", 768.0, 4, "allgather_"),
        ("all-gather", 768.0, 4, "_allgather_base_"),
        ("reduce-scatter", 48.0, 4, "_reduce_scatter_base_"),
        ("all-to-all", 256.0, 4, "alltoall_base_"),
        ("all-gather", 256.0, 4, "all_gather_into_tensor"),  # DTensor: Shard(0) -> Replicate
        ("reduce-scatter", 64.0, 4, "reduce_scatter_tensor"),  # Partial -> Shard(0)
        ("all-reduce", 256.0, 4, "all_reduce"),  # Partial -> Replicate
    ]


def test_recorder_counts_as_comm_debug_mode(fake_world_records):
    """Every collective ``CommDebugMode`` counts, the recorder counts as
    often, per op."""
    cdm = fake_world_records["cdm"]
    ours = {}
    for kind, _, _, op in fake_world_records["records"]:
        ours[op] = ours.get(op, 0) + 1
    names = {op.rsplit(".", 1)[-1]: n for op, n in cdm.items()}
    assert names == ours
    summary = fake_world_records["summary"]
    assert summary["all-reduce"]["count"] == 3
    assert summary["all-reduce"]["link_bytes"] == (2 * 192 * 3 / 4 + 2 * 96 * 15 / 16
                                                   + 2 * 256 * 3 / 4)
