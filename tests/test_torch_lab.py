"""Port parity of the convergence lab (``repro_torch/lab``): the specs and
matrices, the evaluator, the report writer, the runner and the CLI,
against the reference's ``repro.lab``.

* The matrices are the reference's row for row, dict for dict, but for the
  backend axis: the reference's ``*_pallas`` row (``backend="pallas"``) is
  the port's ``*_cuda`` row (``backend="cuda"``).
* Both evaluators give the same claims, names, verdicts and details (the
  word ``pallas`` read as ``cuda``) on the reference's fabricated matrices
  (``tests/test_lab.py``) and on the repo's ``BENCH_convergence.json`` and
  ``BENCH_chaos.json``, whose ``_pallas`` rows are renamed in memory.
* The report is byte for byte the reference's.
* The runner at one worker, given the reference's initial parameters and
  batches through its seam: ``theta``, ``payload_bits``,
  ``compression_ratio``, ``n_elems`` and the wire account exactly equal;
  the convnet (float32) within 1e-5 relative on losses, gradient energy
  and the probe's ratios (measured 2e-7); the LM (bf16 matmuls, which the
  two frameworks round at different places, ``tests/test_torch_model.py``)
  within 1e-3 relative on losses (measured 2.2e-4) and 1e-2 absolute on
  the probe's ratios (measured 2.7e-3).
* A row of two workers, spawned by the runner under gloo: its dense curve
  equals the one-worker run on the same global batch within 1e-4 relative
  (the mean of two half-batch gradients against one full-batch gradient,
  summed in other orders).
"""

import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helpers import REPO
from repro.lab import evaluate as jeval
from repro.lab import report as jreport
from repro.lab import runner as jrunner
from repro.lab import spec as jspec
from repro.optim import OptConfig as JOpt
from repro.train import init_state as j_init_state
from repro_torch import convert
from repro_torch.lab import evaluate as teval
from repro_torch.lab import report as treport
from repro_torch.lab import run as trun
from repro_torch.lab import runner as trunner
from repro_torch.lab import spec as tspec

import test_lab as ref_lab_tests


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """The lab's models are tiny: one intra-op thread a process runs them
    faster than a pool, and keeps the parallel test workers from
    oversubscribing the cores (spawned ranks read OMP_NUM_THREADS)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _to_port(name: str) -> str:
    return name.replace("_pallas", "_cuda")


def _spec_as_port(d):
    d = dict(d)
    d["name"] = _to_port(d["name"])
    if d.get("backend") == "pallas":
        d["backend"] = "cuda"
    return d


def _runs_as_port(runs):
    out = {}
    for name, run in runs.items():
        run = copy.deepcopy(run)
        run["spec"] = _spec_as_port(run["spec"])
        out[_to_port(name)] = run
    return out


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [8, 2, 1])
def test_matrices_equal_reference_modulo_backend(workers):
    for name in ("smoke_matrix", "full_matrix", "chaos_matrix"):
        ref = [_spec_as_port(s.to_dict()) for s in getattr(jspec, name)(workers)]
        port = [s.to_dict() for s in getattr(tspec, name)(workers)]
        assert port == ref, name
        for s in getattr(tspec, name)(workers):
            assert tspec.ExperimentSpec.from_dict(json.loads(json.dumps(s.to_dict()))) == s
    smoke = {s.name: s for s in tspec.smoke_matrix(workers)}
    assert len(smoke) == 24
    for model in ("lm", "convnet"):
        assert smoke[f"{model}_fft_theta0.7_cuda"].backend == "cuda"
        assert all(s.backend == "reference" for n, s in smoke.items()
                   if not n.endswith("_cuda"))
    assert tspec.group_by_model(tspec.smoke_matrix(workers)).keys() == {"lm", "convnet"}


BAD_SPECS = [dict(model="mlp"), dict(reducer=None, schedule={"kind": "constant", "theta": 0.5}),
             dict(workers=8, global_batch=12), dict(validate="sometimes"),
             dict(faults=[{"kind": "meteor", "step": 1}]), dict(ckpt_every=-1),
             dict(exchange_schedule="eager"), dict(selector="heap"),
             dict(exchange_schedule="streamed", transport="allgather"),
             dict(nodes=3, workers=8), dict(nodes=0), dict(transport="hierarchical"),
             dict(theta=0.5, schedule={"kind": "constant", "theta": 0.7}),
             dict(theta=0.9, schedule={"kind": "step_decay", "points": [[0, 0.99], [5, 0.0]]}),
             dict(workers=0), dict(backend="tpu")]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: ",".join(sorted(d)))
def test_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jspec.ExperimentSpec(name="x", **bad)
    with pytest.raises(ValueError):
        tspec.ExperimentSpec(name="x", **bad)


def test_spec_backend_names_are_the_engines():
    from repro_torch.kernels.engine import BACKEND_NAMES

    for backend in BACKEND_NAMES:
        tspec.ExperimentSpec(name="x", backend=backend)
    with pytest.raises(ValueError):
        tspec.ExperimentSpec(name="x", backend="pallas")
    with pytest.raises(ValueError):
        jspec.ExperimentSpec(name="x", backend="cuda")


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


def _claims(claims):
    return [(c.name, c.passed, c.detail) for c in claims]


def _ref_claims(claims):
    return [(c.name, c.passed, c.detail.replace("pallas", "cuda")) for c in claims]


FABRICATED = [
    ("good", lambda: ref_lab_tests._matrix_runs(), 2),
    ("t09", lambda: ref_lab_tests._matrix_runs(t09_final=1.9), 1),
    ("mixed", lambda: ref_lab_tests._matrix_runs(mixed_final=3.5), 1),
    ("trio", lambda: ref_lab_tests._matrix_runs(
        trio_losses=[4.0, 3.1, 2.6, 2.25, 2.05, 2.02 + 1e-3]), 2),
    ("hier", lambda: ref_lab_tests._matrix_runs(
        hier_losses=[4.0, 3.1, 2.6, 2.25, 2.05, 2.02 * 1.2]), 1),
    ("backend", lambda: ref_lab_tests._matrix_runs(
        pallas_losses=[4.0, 3.1, 2.6, 2.25, 2.05, 2.02 + 1e-2]), 2),
    ("streamed", lambda: ref_lab_tests._matrix_runs(
        streamed_losses=[4.0, 3.1, 2.6, 2.25, 2.05, 2.02 + 1e-7]), 2),
    ("sampled", lambda: ref_lab_tests._matrix_runs(
        sampled_losses=[4.0, 3.1, 2.6, 2.25, 2.05, 2.02 * 1.2]), 1),
    ("chaos", lambda: ref_lab_tests._chaos_runs(), 1),
]


@pytest.mark.parametrize("case", FABRICATED, ids=lambda c: c[0])
def test_evaluators_agree_on_fabricated_matrices(case):
    _, make, tail = case
    for drop in (None, "lm_dense", "lm_fft_theta0.7_pallas", "lm_fft_theta0.7_rs",
                 "lm_fft_theta0.7_bucketed_streamed", "lm_fft_theta0.7"):
        runs = make()
        if drop is not None:
            runs.pop(drop, None)
        jclaims, jok = jeval.evaluate_results(runs, jeval.Tolerances(final_tail=tail))
        tclaims, tok = teval.evaluate_results(_runs_as_port(runs),
                                              teval.Tolerances(final_tail=tail))
        assert _claims(tclaims) == _ref_claims(jclaims) and tok == jok, drop
        assert _claims(teval.chaos_claims(_runs_as_port(runs))) == _ref_claims(
            jeval.chaos_claims(runs))
    assert dataclasses.asdict(teval.Tolerances()) == dataclasses.asdict(jeval.Tolerances())


@pytest.mark.parametrize("artifact", ["BENCH_convergence.json", "BENCH_chaos.json"])
def test_evaluators_agree_on_the_repos_artifacts(artifact):
    with open(os.path.join(REPO, artifact)) as f:
        runs = json.load(f)["runs"]
    jclaims, jok = jeval.evaluate_results(runs)
    tclaims, tok = teval.evaluate_results(_runs_as_port(runs))
    assert _claims(tclaims) == _ref_claims(jclaims) and tok == jok
    assert len(tclaims) >= 6
    assert _claims(teval.chaos_claims(_runs_as_port(runs))) == _ref_claims(
        jeval.chaos_claims(runs))


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def test_report_bytes_equal_reference(tmp_path):
    runs = ref_lab_tests._chaos_runs()
    claims, ok = jeval.evaluate_results(runs, jeval.Tolerances(final_tail=2))
    claim_dicts = [c.to_dict() for c in claims]
    jreport.write_json(str(tmp_path / "ref.json"), runs, claim_dicts, ok)
    treport.write_json(str(tmp_path / "port.json"), runs, claim_dicts, ok)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    block = treport.render_markdown(runs, claim_dicts, ok)
    assert block == jreport.render_markdown(runs, claim_dicts, ok)
    assert treport.MARKER == jreport.MARKER
    doc = f"# E\n\n## Convergence results\n\n{treport.MARKER}\n\n*(pending)*\n\n## Next\n\nkeep\n"
    for name, mod in (("ref.md", jreport), ("port.md", treport)):
        (tmp_path / name).write_text(doc)
        assert mod.splice_experiments_md(str(tmp_path / name), block)
        assert mod.splice_experiments_md(str(tmp_path / name), block)
    assert (tmp_path / "port.md").read_bytes() == (tmp_path / "ref.md").read_bytes()
    (tmp_path / "none.md").write_text("no marker\n")
    assert not treport.splice_experiments_md(str(tmp_path / "none.md"), block)
    assert (tmp_path / "none.md").read_text() == "no marker\n"


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


class _TorchBatches:
    """The reference's stream, batches as torch tensors."""

    def __init__(self, stream):
        self.stream = stream

    def batch_at(self, step, host_index=0, num_hosts=1):
        out = {}
        for k, v in self.stream.batch_at(step).items():
            v = np.array(v)
            out[k] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
        return out

    def entropy_floor(self):
        return self.stream.entropy_floor()


def _row(model, **extra):
    kw = dict(name=f"{model}_fft_theta0.7", model=model, workers=1, steps=5, theta=0.7,
              schedule={"kind": "constant", "theta": 0.7})
    if model == "convnet":
        kw.update(opt="sgd", lr=0.1)
    kw.update(extra)
    return kw


@pytest.mark.parametrize("model", ["lm", "convnet"])
def test_runner_matches_reference_at_one_worker(model):
    kw = _row(model)
    jres = jrunner.run_experiment(jspec.ExperimentSpec(**kw), verbose=False)
    jmodel, jstream = jrunner._build_model_and_stream(jspec.ExperimentSpec(**kw))
    opt = (JOpt(kind="sgd", lr=0.1, momentum=0.9) if model == "convnet"
           else JOpt(kind="adamw", lr=3e-3))
    params = j_init_state(jax.random.PRNGKey(0), jmodel, opt)["params"]
    tres = trunner.run_experiment(
        tspec.ExperimentSpec(**kw), verbose=False, device="cpu",
        init_params=convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        stream=_TorchBatches(jstream))
    assert tres.n_elems == jres.n_elems
    assert tres.wire == jres.wire and tres.entropy_floor == jres.entropy_floor
    assert len(tres.records) == len(jres.records) == 5
    loss_rtol, ratio_atol = (1e-5, 1e-5) if model == "convnet" else (1e-3, 1e-2)
    for got, want in zip(tres.records, jres.records):
        assert set(got) == set(want), (got, want)
        for key in ("step", "theta", "payload_bits", "compression_ratio", "skipped"):
            assert got[key] == want[key], key
        assert got["loss"] == pytest.approx(want["loss"], rel=loss_rtol)
        for key in ("err_ratio", "norm_ratio"):
            assert got[key] == pytest.approx(want[key], abs=ratio_atol), key
        if model == "convnet":
            assert got["grad_sq"] == pytest.approx(want["grad_sq"], rel=1e-5)
            assert got["acc"] == want["acc"]
    assert tres.health == dict(jres.health)
    d = tres.to_dict()
    assert set(d) == set(jres.to_dict())
    json.dumps(d)


def test_runner_two_gloo_workers_match_one_on_the_same_global_batch():
    dense = tspec.ExperimentSpec(name="lm_dense", model="lm", reducer=None, workers=2, steps=3)
    one = trunner.run_experiment(dataclasses.replace(dense, workers=1), verbose=False,
                                 device="cpu")
    two = trunner.run_experiment(dense, verbose=False, device="cpu")
    assert two.spec == dense and len(two.records) == 3
    for a, b in zip(two.records, one.records):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_sq"] == pytest.approx(b["grad_sq"], rel=1e-3)
    assert two.wire is None
    fft = tspec.ExperimentSpec(**_row("lm", workers=2, steps=3, transport="psum"))
    res = trunner.run_experiment(fft, verbose=False, device="cpu")
    assert len(res.records) == 3 and res.health["skip_steps"] == []
    assert all(np.isfinite(r["loss"]) and "err_ratio" in r for r in res.records)
    assert res.wire["workers"] == 2 and res.wire["compressed_bits"] > 0
    assert [r["theta"] for r in res.records] == [0.7000000000000001] * 3


def test_runner_crash_row_resumes_bitwise_at_one_worker():
    """The harness's fatal crash and auto-resume: the convnet's crash row
    restarts once from its step-30 checkpoint, its records deduplicated to
    one a step, bitwise the clean row (the reference's resilience claim)."""
    rows = {s.name: s for s in tspec.chaos_matrix(1)}
    runs = {name: trunner.run_experiment(rows[name], verbose=False, device="cpu").to_dict()
            for name in ("convnet_fft_theta0.7", "convnet_chaos_crash")}
    crash = runs["convnet_chaos_crash"]
    assert crash["health"]["resumes"] == 1
    assert [r["step"] for r in crash["records"]] == list(range(50))
    claims = {c.name: c for c in teval.chaos_claims(runs)}
    assert claims["convnet:crash_resume_bitwise"].passed, claims


def test_runner_raises_when_a_spawned_rank_fails():
    spec = tspec.ExperimentSpec(name="lm_dense", model="lm", reducer=None, workers=2, steps=1)
    with pytest.raises(Exception, match="batch_at"):
        trunner.run_experiment(spec, verbose=False, device="cpu",
                               stream=trunner.GlobalBatchShards(None))


def test_runner_refuses_rows_wider_than_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spec = tspec.ExperimentSpec(name="lm_dense", model="lm", reducer=None, workers=2)
    with pytest.raises(RuntimeError, match="needs 2 workers"):
        trunner.run_experiment(spec, verbose=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.run_experiment(dataclasses.replace(spec, workers=1), verbose=False)


def test_global_batch_shards_slice_the_rows():
    from repro_torch.data import SyntheticConfig, SyntheticStream

    stream = SyntheticStream(SyntheticConfig(vocab_size=64, seq_len=8, global_batch=8))
    shards = trunner.GlobalBatchShards(stream)
    whole = stream.batch_at(2)
    parts = [shards.batch_at(2, h, 4) for h in range(4)]
    for key in whole:
        assert torch.equal(torch.cat([p[key] for p in parts]), whole[key])
    assert all(torch.equal(shards.batch_at(2)[k], whole[k]) for k in whole)
    assert shards.entropy_floor() == stream.entropy_floor()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


class _Fake:
    def __init__(self, run):
        self.run = run

    def to_dict(self):
        return self.run


@pytest.mark.parametrize("passing", [True, False])
def test_cli_writes_under_lab_out_and_exits_on_claims(tmp_path, monkeypatch, capsys,
                                                      passing):
    runs = _runs_as_port(ref_lab_tests._matrix_runs(t09_final=2.6 if passing else 1.9))
    seen = {}

    def fake_run_matrix(matrix, verbose=True, *, device=None):
        seen.update(names=[s.name for s in matrix], device=device)
        return {name: _Fake(run) for name, run in runs.items()}

    monkeypatch.setattr(trun, "run_matrix", fake_run_matrix)
    monkeypatch.setattr(trun, "evaluate_results", lambda r: teval.evaluate_results(
        r, teval.Tolerances(final_tail=2)))
    monkeypatch.chdir(tmp_path)
    rc = trun.main(["--smoke", "--workers", "1", "--device", "cpu", "--quiet"])
    assert rc == (0 if passing else 1)
    assert seen["device"] == "cpu" and "lm_fft_theta0.7_cuda" in seen["names"]
    data = json.loads((tmp_path / "lab_out" / "convergence.json").read_text())
    assert data["bench"] == "convergence_lab" and data["all_claims_passed"] is passing
    assert sorted(os.listdir(tmp_path)) == ["lab_out"]
    assert ("ALL CLAIMS PASS" if passing else "CLAIM FAILURES") in capsys.readouterr().out


def test_cli_raises_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main(["--smoke", "--workers", "1", "--quiet"])


# ---------------------------------------------------------------------------
# tier-2: the port's smoke matrix at one worker on the CPU (~60 s)
# ---------------------------------------------------------------------------


def _chip_smoke_verdicts():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LAB_VERDICTS


@pytest.mark.lab
def test_port_lab_smoke_matrix_at_one_worker(tmp_path):
    """``python -m repro_torch.lab.run --smoke --workers 1 --device cpu``
    gives the verdicts the chip phase holds the card to
    (``chip_smoke.LAB_VERDICTS``): 18 pass, the convnet's
    ``theta0.7_matches_dense`` and ``mixed_recovers`` fail, as the
    reference's do at one worker; so the CLI exits 1."""
    out = tmp_path / "convergence.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lab.run", "--smoke", "--workers", "1",
         "--device", "cpu", "--out", str(out), "--quiet"],
        capture_output=True, text=True, timeout=1800, env=env, cwd=str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    data = json.loads(out.read_text())
    got = {c["name"]: c["passed"] for c in data["claims"]}
    assert got == _chip_smoke_verdicts()
    run = data["runs"]["lm_fft_theta0.7"]
    assert len(run["records"]) == run["spec"]["steps"] == 50
    assert all("err_ratio" in r for r in run["records"])
    assert run["wire"]["compressed_bits"] > 0
    assert sorted(os.listdir(tmp_path)) == ["convergence.json"]

