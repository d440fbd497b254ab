"""Port parity of the weight-delta ring, publisher and subscriber: the
reference's ``tests/test_publish.py`` cases run through both packages on
the same seeded numpy trajectories, rings read across the packages, the
wire accounts, and the training and serving CLIs end to end.

What must agree, and how closely:

* sync stats (``applied``, ``decompress_count``, ``rebases``,
  ``snapshot_loads``, ``gap_detected``, ``bytes_read``, ``version``,
  ``closed``) equal the reference's exactly, sync by sync;
* within the port, the publisher's mirror and every subscriber are BITWISE
  equal, however they batched the catch-up;
* the port's replica weights are within ``WEIGHT_REL`` = 1e-4 relative L2
  of the reference's: torch's and XLA's FFTs differ by ~1e-7 relative, which
  can move a range-quantizer code by one step (8-bit codes with 3 mantissa
  bits, so ~6% of one value) or a bin across the keep threshold;
* the reference's own bounds hold on the port (theta 0 unquantized exact to
  rtol 1e-5 / atol 1e-6; staleness under 0.1 relative and not growing);
* a replica served by the CLI is within ``STALENESS`` = 0.1 of the last
  delta's size from the trainer's final weights: the mirror's error is that
  delta's codec error, and 3 mantissa bits round a kept value by at most
  2^-4 of itself.
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import (PublishConfig as JPublishConfig, ReplicaSubscriber as JSubscriber,
                         WeightDeltaPublisher as JPublisher)
from repro_torch.comms import cost_model
from repro_torch.comms.reducers import flatten_tree
from repro_torch.serve import (PublishConfig, ReplicaSubscriber, RingReader,
                               SpectrumReplicaState, WeightDeltaPublisher)
from repro_torch.core.compressor import StackedPayload

N = 3000
WEIGHT_REL = 1e-4
STALENESS = 0.1


def _np_params(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(50, 40)).astype(np.float32),
            "b": rng.normal(size=(N - 2000,)).astype(np.float32)}


def _trajectory(seed: int, start: int, steps: int, scale: float = 1e-2):
    """params, then one small random update a step (the reference's _walk)."""
    params = _np_params(seed)
    out = [params]
    for step in range(steps):
        rng = np.random.default_rng(start + step)
        params = {k: v + (scale * rng.normal(size=v.shape)).astype(np.float32)
                  for k, v in params.items()}
        out.append(params)
    return out


def _cfg(**kw):
    kw.setdefault("chunk", 64)
    kw.setdefault("bucket_bytes", 4 * 1024)  # 1024 floats -> 3 buckets
    kw.setdefault("snapshot_every", 4)
    kw.setdefault("capacity", 4)
    return kw


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


class _Jax:
    """The reference package behind one interface."""

    def publisher(self, d, params, kw):
        return JPublisher(str(d), self.params(params), JPublishConfig(**kw))

    def subscriber(self, d):
        return JSubscriber(str(d))

    def params(self, p):
        return {k: jnp.asarray(v) for k, v in p.items()}

    def state(self, p):
        return {"params": self.params(p)}

    def weights(self, x):
        return np.asarray(x)


class _Port:
    def publisher(self, d, params, kw):
        return WeightDeltaPublisher(str(d), self.params(params), PublishConfig(**kw))

    def subscriber(self, d):
        return ReplicaSubscriber(str(d), device="cpu")

    def params(self, p):
        return {k: torch.from_numpy(v.copy()) for k, v in p.items()}

    def state(self, p):
        params = self.params(p)
        return {"model": types.SimpleNamespace(leaves=lambda: params)}

    def weights(self, x):
        return x.numpy()


# scenario -> (config, seed, steps): the reference's test_publish.py cases
SCENARIOS = {
    "theta0_unquantized_exact": (_cfg(theta=0.0, quantize=False), 0, 1),
    "lossy_staleness_bounded": (_cfg(theta=0.7, quantize=True), 0, 12),
    "catchup_one_decompress": (_cfg(theta=0.5, snapshot_every=8, capacity=8), 1, 3),
    "catchup_across_rebase": (_cfg(theta=0.5, snapshot_every=4, capacity=8), 2, 6),
    "ring_wrap_snapshot_fallback": (_cfg(theta=0.5, snapshot_every=4, capacity=4), 3, 10),
}


def _run(pkg, other, d, kw, seed, steps):
    """Publish a trajectory with ``pkg``; a ``replay`` replica syncs after
    every delta; a ``laggard`` made at v0, and one of the ``other`` package
    on the same ring, sync once at the end."""
    traj = _trajectory(seed, 100 * (seed + 1), steps)
    pub = pkg.publisher(d, traj[0], kw)
    replay, laggard, cross = pkg.subscriber(d), pkg.subscriber(d), other.subscriber(d)
    replay_stats, errs = [], []
    for step in range(steps):
        pub.publish(step, pkg.params(traj[step + 1]))
        replay_stats.append(dataclasses.asdict(replay.sync()))
        true = np.asarray(flatten_tree({k: torch.from_numpy(v) for k, v in
                                        traj[step + 1].items()})[0])
        errs.append(_rel(pkg.weights(replay.weights()), true))
    return dict(replay_stats=replay_stats, laggard_stats=dataclasses.asdict(laggard.sync()),
                cross_stats=dataclasses.asdict(cross.sync()), errs=errs, dir=str(d),
                replay=pkg.weights(replay.weights()), laggard=pkg.weights(laggard.weights()),
                cross=other.weights(cross.weights()),
                mirror=pkg.weights(pub.state.materialize()), version=pub.version)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario through both packages, once: name -> (reference, port)."""
    out = {}
    for name, (kw, seed, steps) in SCENARIOS.items():
        d = tmp_path_factory.mktemp(name)
        out[name] = (_run(_Jax(), _Port(), d / "jax", kw, seed, steps),
                     _run(_Port(), _Jax(), d / "port", kw, seed, steps))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_publish_subscribe_matches_reference(runs, name):
    j, t = runs[name]
    steps = SCENARIOS[name][2]
    assert t["replay_stats"] == j["replay_stats"]
    assert t["laggard_stats"] == j["laggard_stats"]
    assert t["version"] == j["version"] == steps
    # the mirror is a replica: bitwise, however the catch-up was batched
    np.testing.assert_array_equal(t["mirror"], t["replay"])
    np.testing.assert_array_equal(t["laggard"], t["replay"])
    assert _rel(t["replay"], j["replay"]) <= WEIGHT_REL
    lag = t["laggard_stats"]
    if name == "theta0_unquantized_exact":
        assert t["replay_stats"][0]["applied"] == 1
        assert t["replay_stats"][0]["decompress_count"] == 1
        assert t["errs"][0] < 1e-5
    elif name == "lossy_staleness_bounded":
        assert max(t["errs"]) < 0.1 and t["errs"][-1] < 3.0 * max(t["errs"][0], 1e-6)
    elif name == "catchup_one_decompress":
        assert lag["applied"] == 3 and lag["decompress_count"] == 1
        assert not lag["gap_detected"]
    elif name == "catchup_across_rebase":
        assert lag["applied"] == 6 and lag["rebases"] == 1
    else:
        assert lag["gap_detected"] and lag["snapshot_loads"] == 1 and lag["version"] == 10


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rings_read_across_packages(runs, name):
    """The port's subscriber on the reference's ring, and the reference's on
    the port's (its ``backend="reference"``), each against the writer's own
    laggard."""
    j, t = runs[name]
    assert j["cross_stats"] == j["laggard_stats"]
    assert t["cross_stats"] == t["laggard_stats"]
    assert _rel(j["cross"], j["laggard"]) <= WEIGHT_REL
    assert _rel(t["cross"], t["laggard"]) <= WEIGHT_REL


def test_ring_files_match_reference(runs):
    """The version-0 snapshot's bytes, the manifest's key structure and each
    delta blob's size are the reference's."""
    j, t = runs["ring_wrap_snapshot_fallback"]
    d = {name: os.path.dirname(r["dir"]) for name, r in (("jax", j), ("port", t))}
    tman, jman = RingReader(t["dir"]).manifest(), RingReader(j["dir"]).manifest()
    assert _keys(tman) == _keys(jman)
    assert [e["nbytes"] for e in tman["deltas"]] == [e["nbytes"] for e in jman["deltas"]]
    fresh = {}
    for name, pkg in (("jax", _Jax()), ("port", _Port())):
        pkg.publisher(os.path.join(d[name], "v0-" + name), _np_params(9), _cfg())
        fresh[name] = open(os.path.join(d[name], "v0-" + name, "snapshot_0000000.f32"),
                           "rb").read()
    assert fresh["port"] == fresh["jax"]


def test_reference_backend_name_pallas_reads_as_cuda(runs, tmp_path):
    """A manifest naming the reference's ``pallas`` backend (written by hand:
    its Pallas stages would run in interpret mode here) reads with the
    port's ``cuda`` backend and decodes the same."""
    import shutil

    j, _ = runs["catchup_across_rebase"]
    ring = str(tmp_path / "ring")
    shutil.copytree(j["dir"], ring)
    path = os.path.join(ring, "manifest.json")
    manifest = json.load(open(path))
    manifest["meta"]["compressor"]["backend"] = "pallas"
    json.dump(manifest, open(path, "w"), indent=1)
    sub, plain = (ReplicaSubscriber(r, device="cpu") for r in (ring, j["dir"]))
    assert (sub.comp.config.backend, plain.comp.config.backend) == ("cuda", "reference")
    assert dataclasses.asdict(sub.sync()) == dataclasses.asdict(plain.sync())
    assert torch.equal(sub.weights(), plain.weights())


def test_theta0_unquantized_delta_is_exact(tmp_path):
    traj = _trajectory(0, 1, 1)
    pub = WeightDeltaPublisher(str(tmp_path), _Port().params(traj[0]),
                               PublishConfig(**_cfg(theta=0.0, quantize=False)))
    pub.publish(0, _Port().params(traj[1]))
    sub = ReplicaSubscriber(str(tmp_path), device="cpu")
    stats = sub.sync()
    assert stats.applied == 1 and stats.decompress_count == 1
    true = flatten_tree(_Port().params(traj[1]))[0]
    np.testing.assert_allclose(sub.weights().numpy(), true.numpy(), rtol=1e-5, atol=1e-6)
    back = sub.params_like(_Port().params(traj[1]))
    assert set(back) == {"w", "b"} and back["w"].shape == (50, 40)


def test_publish_cadence_and_close(tmp_path):
    traj = _trajectory(4, 500, 7)
    versions = {}
    for name, pkg in (("jax", _Jax()), ("port", _Port())):
        pub = pkg.publisher(tmp_path / name, traj[0], _cfg(publish_every=3))
        hook = pub.hook()
        for step in range(7):
            hook(step, pkg.state(traj[step + 1]))
        assert pub.version == 3  # steps 0, 3, 6
        pub.close()
        versions[name] = pkg.subscriber(tmp_path / name).follow(timeout_s=5.0)
    assert versions == {"jax": 3, "port": 3}


def test_config_invariants():
    with pytest.raises(ValueError, match="capacity"):
        PublishConfig(capacity=2, snapshot_every=8)
    with pytest.raises(ValueError, match="publish_every"):
        PublishConfig(publish_every=0)
    with pytest.raises(ValueError, match="snapshot_every"):
        PublishConfig(snapshot_every=0, capacity=4)
    # the reference's defaults; the training CLI passes its backend and selector
    assert (PublishConfig().backend, PublishConfig().selector) == ("reference", "sort")


def test_publisher_rejects_mismatched_tree(tmp_path):
    pub = WeightDeltaPublisher(str(tmp_path), _Port().params(_np_params(5)),
                               PublishConfig(**_cfg()))
    with pytest.raises(ValueError, match="elements"):
        pub.publish(0, {"w": torch.zeros((3, 3))})


def _keys(tree):
    """The manifest's key structure (dicts and the entries of lists)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


def test_publish_wire_account_matches_reference():
    from repro.comms import cost_model as jcost
    from repro.core.compressor import FFTCompressor as JFFT, FFTCompressorConfig as JCfg
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig

    sizes = (4096 * 3, 4096 * 3, 5000)
    for theta in (0.0, 0.7):
        t = cost_model.publish_wire_account(
            sum(sizes), FFTCompressor(FFTCompressorConfig(theta=theta)).wire_bits, sizes,
            steps=10, publish_every=3, snapshot_every=2)
        j = jcost.publish_wire_account(
            sum(sizes), JFFT(JCfg(theta=theta)).wire_bits, sizes, steps=10, publish_every=3,
            snapshot_every=2)
        assert t.to_dict() == j.to_dict()
        assert t.n_publishes == 4 and t.n_snapshots == 3
    for transport, topo in (("allgather", None), ("psum", None), ("hierarchical", (2, 4))):
        args = (1 << 16, [1e5, 1e5, None], transport, 8)
        assert (cost_model.run_wire_account(*args, topology=topo).to_dict()
                == jcost.run_wire_account(*args, topology=topo).to_dict())


def _last_delta_norm(ring_dir) -> float:
    """Norm of the ring's last delta, decoded on its own."""
    sub = ReplicaSubscriber(ring_dir, device="cpu")
    manifest = sub.reader.manifest()
    state = SpectrumReplicaState(torch.zeros(sub.layout.total), sub.layout, sub.comp)
    blob = sub.reader.read_delta(manifest, int(manifest["latest_version"]))
    state.fold(StackedPayload.from_bytes(blob, "cpu"))
    return float(torch.linalg.vector_norm(state.materialize().double()))


def test_train_publish_then_serve_follow_cli(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli, train as train_cli

    ring = str(tmp_path / "ring")
    result = train_cli.main(["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
                             "--seq", "32", "--n-layers", "2", "--publish-dir", ring])
    out = capsys.readouterr().out
    assert f"[publish] ring at {ring}" in out and "[publish] closed ring at v4" in out
    pub = result["publisher"]
    meta = RingReader(ring).manifest()["meta"]
    assert (meta["arch"], meta["reduced"], meta["n_layers"]) == ("gemma2_2b", True, 2)
    assert meta["compressor"]["backend"] == "auto" and pub.comp.config.selector == "auto"
    true = flatten_tree(result["state"]["model"].leaves())[0].detach()
    served = serve_cli.main(["--follow", ring, "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "[serve] v4: +4 deltas" in out and "1 decompress" in out
    assert "ring closed at v4; weights loaded" in out
    assert served["model"].cfg.n_layers == 2 and served["tokens"].shape == (2, 12)
    weights = flatten_tree(served["model"].leaves())[0].detach()
    assert torch.equal(weights, pub.state.materialize())
    stale = float(torch.linalg.vector_norm((true - weights).double()))
    assert stale <= STALENESS * _last_delta_norm(ring)
