"""Port parity of ``comms/calibrate.py``: the alpha-beta fit, the artifact and
its key, the profiling pass on a one-rank gloo group, and the CLI's
``--schedule auto --calibrate --calibration-path`` (profile once, then
load).

Tolerances: ``fit_alpha_beta`` is exact (the reference's float expressions
in the same order); profiles round-trip exactly through their JSON; the
measurements themselves are only checked to be positive and finite (a CPU
timing is no device number).
"""

import json
import math

import pytest

from repro.comms import calibrate as jcal
from repro_torch.comms import calibrate as tcal
from repro_torch.comms import cost_model as tcm
from repro_torch.launch import train as train_cli

SWEEPS = [([65536, 262144, 1048576, 4194304], [3e-5, 4.1e-5, 9.7e-5, 3.3e-4]),
          ([1, 2, 3], [5.0, 4.0, 3.0]),  # a falling fit clamps to the floors
          ([0.0, 0.0, 0.0], [1e-5, 2e-5, 3e-5]),  # a one-worker psum: no bytes move
          ([7.0], [1e-4])]


@pytest.mark.parametrize("xs,ts", SWEEPS)
def test_fit_alpha_beta_equals_reference(xs, ts):
    assert tcal.fit_alpha_beta(xs, ts) == jcal.fit_alpha_beta(xs, ts)


def test_fit_alpha_beta_refuses_bad_sweeps():
    for xs, ts in (([], []), ([1.0, 2.0], [1.0])):
        with pytest.raises(ValueError):
            tcal.fit_alpha_beta(xs, ts)


def _profile(model="none", workers=1):
    return tcal.CostProfile(
        key=tcal.ProfileKey("cpu", "cpu", workers, model, tcal.torch.__version__),
        fits=(tcal.LinkFit("gather", 2e-5, 1e-10, 4), tcal.LinkFit("psum", 3e-5, 2e-10, 4)),
        throughputs=tcm.Throughputs(1e9, 2e9, 3e9, 4e9), backprop_flops_per_s=5e12)


def test_artifacts_roundtrip_and_keys(tmp_path):
    path = str(tmp_path / "p.json")
    prof = _profile()
    prof.save(path)
    assert tcal.CostProfile.load(path) == prof
    assert tcal.load_profile_for(path, device="cpu") == prof  # a comms-only calibration
    assert prof.fit_for("sequenced").alpha_s == 2e-5 and prof.t_comm("psum") == 1 / 2e-10
    assert prof.backprop_s(10 ** 6, 4096) == 4.0 * 1e6 * 4096 / 5e12
    for other in (_profile(workers=2), _profile(model="LM/7")):
        other.save(path)
        if other.key.workers != 1:
            with pytest.raises(tcal.ProfileKeyMismatch):
                tcal.load_profile_for(path, device="cpu")
        with pytest.raises(tcal.ProfileKeyMismatch):
            tcal.CostProfile.load(path, expect=prof.key)
        assert tcal.CostProfile.load(path, expect=prof.key, strict=False) == other
    with pytest.raises(ValueError):
        tcal.LinkFit("broadcast", 1e-5, 1e-10)
    with pytest.raises(ValueError):
        tcal.LinkFit("gather", 0.0, 1e-10)
    with pytest.raises(ValueError):
        tcal.CostProfile(key=prof.key, fits=prof.fits[:1], throughputs=prof.throughputs,
                         backprop_flops_per_s=1.0)
    assert not tcal.UNCALIBRATED.calibrated
    assert tcal.UNCALIBRATED.throughputs == tcm.H100
    assert tcal.UNCALIBRATED.t_comm("sequenced") == tcm.NETWORKS[tcm.DEFAULT_NETWORK]
    assert tcal.collective_family("psum") == "psum"
    # the two-level transports price by hop, as the reference's
    for transport in ("hierarchical", "reduce_scatter"):
        assert tcal.collective_family(transport) == jcal.collective_family(transport)
    with pytest.raises(ValueError):
        tcal.collective_family("auto")


def _two_level_profile(nodes, local):
    return tcal.CostProfile(
        key=tcal.ProfileKey("cpu", "cpu", nodes * local, "none", tcal.torch.__version__,
                            mesh=(("node", nodes), ("local", local)), axes=("node", "local")),
        fits=(tcal.LinkFit("gather", 2e-5, 1e-10, 4), tcal.LinkFit("psum", 3e-5, 2e-10, 4),
              tcal.LinkFit("gather", 9e-5, 1e-9, 4, axis="node"),
              tcal.LinkFit("psum", 1e-6, 1e-12, 4, axis="local")),
        throughputs=tcm.Throughputs(1e9, 2e9, 3e9, 4e9), backprop_flops_per_s=5e12)


def test_per_axis_profiles_roundtrip_and_keep_their_topology(tmp_path):
    """Per-axis fits round-trip and price their hop (the base fit where an
    axis has none); a (2, 2) calibration raises on a (4, 1) mesh and a
    version-1 artifact raises."""
    from repro_torch.launch.mesh import Mesh

    path = str(tmp_path / "two.json")
    prof = _two_level_profile(2, 2)
    prof.save(path)
    assert tcal.CostProfile.load(path) == prof
    assert prof.t_comm("hierarchical", axis="node") == 1 / 1e-9
    assert prof.alpha_s("psum", axis="local") == 1e-6
    assert prof.alpha_s("psum", axis="node") == 3e-5  # no per-axis psum fit on node
    assert prof.t_comm("psum") == 1 / 2e-10
    plan = tcm.two_level_exchange_time_s(4e6, 1e6, nodes=2, local=2, profile=prof)
    assert plan.inter_s == plan.wire.inter_bits_per_node / 8.0 / (1 / 1e-9)
    mesh = Mesh(("node", "local"), (2, 2), (0, 0), (None, None))
    assert tcal.profile_key(group=mesh, device="cpu") == prof.key
    with pytest.raises(tcal.ProfileKeyMismatch):  # its workers are 4, its mesh (2, 2)
        tcal.load_profile_for(path, group=Mesh(("node", "local"), (4, 1), (0, 0),
                                               (None, None)), device="cpu")
    _two_level_profile(4, 1).save(path)
    with pytest.raises(tcal.ProfileKeyMismatch):
        tcal.CostProfile.load(path, expect=prof.key)
    d = prof.to_dict()
    d["version"] = "repro_torch/1"
    json.dump(d, open(path, "w"))
    with pytest.raises(tcal.ProfileKeyMismatch, match="version"):
        tcal.CostProfile.load(path)
    with pytest.raises(ValueError, match="duplicate"):
        tcal.CostProfile(key=prof.key, fits=prof.fits + prof.fits[-1:],
                         throughputs=prof.throughputs, backprop_flops_per_s=1.0)


def test_reference_artifact_raises_profile_key_mismatch(tmp_path):
    path = str(tmp_path / "ref.json")
    jcal.UNCALIBRATED.save(path)
    with pytest.raises(tcal.ProfileKeyMismatch):
        tcal.CostProfile.load(path)
    with pytest.raises(tcal.ProfileKeyMismatch):
        tcal.load_profile_for(path, device="cpu")
    d = json.load(open(path))
    d["version"] = tcal.ARTIFACT_VERSION  # even with the port's version: the key differs
    json.dump(d, open(path, "w"))
    with pytest.raises(tcal.ProfileKeyMismatch):
        tcal.CostProfile.load(path)


def test_calibrate_smoke_on_a_one_rank_gloo_group(tmp_path, capsys):
    out = str(tmp_path / "smoke.json")
    assert tcal.main(["--smoke", "--device", "cpu", "--out", out]) == 0
    prof = tcal.CostProfile.load(out)
    assert prof.calibrated and prof.key.workers == 1 and prof.key.platform == "cpu"
    assert [f.n_points for f in prof.fits] == [len(tcal.SMOKE_SIZES_BYTES)] * 2
    thr = prof.throughputs
    assert all(math.isfinite(v) and v > 0 for v in (thr.t_m, thr.t_f, thr.t_p, thr.t_s))
    assert thr.t_m == thr.t_f == thr.t_p == thr.t_s  # one rate prices the fused roundtrip
    assert tcal.main(["--check", out, "--device", "cpu"]) == 0
    assert "matches the live system" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="process group"):
        tcal.benchmark_collectives(device="cpu")


def test_cli_schedule_auto_profiles_once_then_loads(tmp_path):
    path = str(tmp_path / "cal.json")
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "1",
            "--mode", "compressed_dp", "--transport", "sequenced", "--bucket-mb", "0.05",
            "--error-feedback", "--schedule", "auto", "--calibrate", "--calibration-path",
            path]
    first = train_cli.main(args)
    second = train_cli.main(args)
    assert first["calibration"]["profiled"] and not second["calibration"]["profiled"]
    assert second["calibration"]["profile"] == first["calibration"]["profile"]
    assert first["calibration"]["profile"]["key"]["model"] == "LM/164416"
    assert first["schedule_decision"] == second["schedule_decision"]
    assert first["schedule_decision"].schedule in ("stacked", "streamed")
    # the artifact prices the step without --calibrate too
    third = train_cli.main([a for a in args if a != "--calibrate"])
    assert third["calibration"] is None
    assert third["schedule_decision"] == first["schedule_decision"]
