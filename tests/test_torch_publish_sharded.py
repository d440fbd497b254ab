"""Publishing a sharded state (``serve/publish.py``'s gathers and
``gather_hook``, ``launch/train.py --publish-dir``): the training CLI on 4
gloo workers, once with ``--mesh production`` -- patched to a ``(2, 2)``
``("data", "model")`` mesh, so ``--mode pjit`` keeps the state sharded, TP
and the sequence-parallel stream over ``model`` -- and once replicated on
the flat world, each publishing to a ring of its own with ``--publish-every
2``.  Rank 0 writes; the other ranks join its gathers of the leaves.  Both
runs train on the same global rows (the synthetic stream draws a host's rows
from its index and count, so the workers draw the global batch and slice
it).  One module fixture runs both.

Tolerances:
* the ring's manifest (versions, steps, meta) and its version-0 snapshot:
  equal to the replicated run's, and the snapshot bitwise the writer's
  gathered weights; every rank gathers every leaf once for the snapshot and
  once a publish (no rank hangs: the workers exit in time);
* each version's weights, rebuilt from the snapshot and the deltas: within
  0.1 of that delta's norm of the trainer's gathered weights at its step
  (``chip_smoke.STALENESS``: the codec rounds a kept value by at most 2^-4
  of itself);
* against the replicated run, the sharded step's own tolerances
  (``tests/test_torch_sharding.py``, which reads them after 3 steps): the
  losses within 1e-3 relative at every step, and the last version's update
  since version 0, 3 steps in, within relative L2 0.1 of the replicated
  ring's (measured 0.059).  After the first step it is 0.112: AdamW's first
  step moves every weight by about lr whatever its gradient, so the 0.3% of
  signs that the split's rounding flips move 2 * lr apart;
* a subscriber that follows the sharded ring: bitwise the writer's mirror.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO

WORKERS = 4
STEPS = 4
PUBLISH_EVERY = 2
RUNS = {"sharded": ["--mesh", "production"], "replicated": []}

_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from repro_torch.launch import mesh as mesh_mod, train as cli
from repro_torch.serve import publish
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
runs, args = json.loads(sys.argv[4]), json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
# the production mesh at the size of this world
cli.make_production_mesh = lambda multi_pod=False, device=None: mesh_mod.make_local_mesh(
    (2, 2), ("data", "model"), device="cpu")


class GlobalRows(cli.SyntheticStream):
    # the global batch drawn as one host's, each host taking its rows: both
    # runs train on the same rows, however many hosts split them
    def batch_at(self, step, host_index=0, num_hosts=1):
        per = self.config.global_batch // num_hosts
        return {k: v[host_index * per:(host_index + 1) * per]
                for k, v in super().batch_at(step).items()}


cli.SyntheticStream = GlobalRows
gathers = [0]
full_tensor = publish.full_tensor


def counted(t):
    gathers[0] += isinstance(t, DTensor)
    return full_tensor(t)


publish.full_tensor = counted
# the writer's flat weights at the version-0 snapshot and at each publish
truth = []
flat = publish._flat


def recorded(params):
    truth.append(flat(params))
    return truth[-1]


publish._flat = recorded
for name, extra in runs.items():
    gathers[0] = 0
    truth.clear()
    result = cli.main(args + extra + ["--publish-dir", f"{path}.{name}"])
    leaves = result["state"]["model"].leaves()
    out = {"gathers": gathers[0], "leaves": len(leaves),
           "dtensors": sum(isinstance(v, DTensor) for v in leaves.values()),
           "losses": [row["loss"] for row in result["history"]]}
    if rank == 0:
        np.save(f"{path}.{name}.mirror.npy", result["publisher"].state.materialize().numpy())
        np.save(f"{path}.{name}.truth.npy", torch.stack(truth).numpy())
    with open(f"{path}.{name}.{rank}.json", "w") as f:
        json.dump(out, f)
dist.barrier()  # rank 0 hosts the store: no rank tears down before all are done
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("publish_sharded") / "ring")
    args = ["--reduced", "--device", "cpu", "--steps", str(STEPS), "--batch", "4", "--seq",
            "16", "--publish-every", str(PUBLISH_EVERY)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(port), path,
                               json.dumps(RUNS), json.dumps(args)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORKERS)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return path


def _ranks(path, name):
    return [json.load(open(f"{path}.{name}.{rank}.json")) for rank in range(WORKERS)]


def _versions(ring):
    """Each version's flat weights: the version-0 snapshot, then each delta
    folded on."""
    from repro_torch.core.compressor import StackedPayload
    from repro_torch.serve import ReplicaSubscriber, SpectrumReplicaState

    sub = ReplicaSubscriber(ring, device="cpu")
    manifest = sub.reader.manifest()
    _, _, flat = sub.reader.read_snapshot(manifest)
    weights = [torch.from_numpy(flat.copy())]
    state = SpectrumReplicaState(weights[0], sub.layout, sub.comp)
    for entry in manifest["deltas"]:
        state.fold(StackedPayload.from_bytes(sub.reader.read_delta(manifest, entry["version"]),
                                             torch.device("cpu")))
        weights.append(state.materialize().clone())
    return manifest, weights


def test_cli_publishes_a_sharded_state(rings):
    """``--publish-dir`` with the sharded ``--mode pjit`` state: every leaf
    a DTensor, every rank gathering each leaf for the version-0 snapshot and
    for each publish, the replicated run gathering nothing."""
    publishes = len(range(0, STEPS, PUBLISH_EVERY))
    for r in _ranks(rings, "sharded"):
        assert r["dtensors"] == r["leaves"] > 0
        assert r["gathers"] == r["leaves"] * (1 + publishes)
    for r in _ranks(rings, "replicated"):
        assert (r["dtensors"], r["gathers"]) == (0, 0)


def test_each_version_is_the_trainers_weights(rings):
    """Each version of the sharded ring is the trainer's gathered weights at
    its publish, to the codec's rounding of that delta."""
    manifest, got = _versions(f"{rings}.sharded")
    truth = torch.from_numpy(np.load(f"{rings}.sharded.truth.npy"))
    assert len(truth) == len(got) == 1 + len(manifest["deltas"])
    assert torch.equal(got[0], truth[0])
    for v in range(1, len(got)):
        delta = float((got[v] - got[v - 1]).norm())
        assert delta > 0
        assert float((got[v] - truth[v]).norm()) <= 0.1 * delta, v


def test_sharded_ring_matches_the_replicated_ring(rings):
    got_manifest, got = _versions(f"{rings}.sharded")
    want_manifest, want = _versions(f"{rings}.replicated")
    assert got_manifest == want_manifest
    assert [d["step"] for d in got_manifest["deltas"]] == list(range(0, STEPS, PUBLISH_EVERY))
    assert torch.equal(got[0], want[0])
    update, ref = got[-1] - got[0], want[-1] - want[0]
    assert float((update - ref).norm()) <= 0.1 * float(ref.norm())
    for g, w in zip(_ranks(rings, "sharded"), _ranks(rings, "replicated")):
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-3)


def test_subscriber_follows_the_sharded_ring_bitwise(rings):
    from repro_torch.serve import ReplicaSubscriber

    sub = ReplicaSubscriber(f"{rings}.sharded", device="cpu")
    assert sub.follow(timeout_s=5.0) == len(range(0, STEPS, PUBLISH_EVERY))
    mirror = torch.from_numpy(np.load(f"{rings}.sharded.mirror.npy"))
    assert torch.equal(sub.weights(), mirror)
