"""The benchmark's files: found by name, within the contract's limits, and
free of JAX, of the JAX package and of the JAX package's benchmarks."""

import ast
import json
import os
import re

import pytest

from _tiny import ROOT

from perfbench import check, spec

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
HERE = os.path.join(ROOT, "perfbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _sources():
    for dirpath, _, names in os.walk(HERE):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(_sources())
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), r) for f in files for r in _imported_roots(f)
           if r in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    plain = [os.path.join(HERE, "reference", n) for n in os.listdir(os.path.join(HERE, "reference"))
             if n.endswith(".py")] + [os.path.join(HERE, n) for n in ("weights.py", "feed.py")]
    bad = [(os.path.relpath(f, ROOT), r) for f in plain for r in _imported_roots(f)
           if r == "repro_torch"]
    assert not bad, bad


def test_reads_none_of_the_jax_benchmarks():
    for path in _sources():
        if os.path.samefile(path, __file__):
            continue
        text = open(path).read()
        assert not re.search(r"(?<![A-Za-z])BENCH_", text), path
        assert "benchmarks/" not in text, path


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.traffic.workers == c.chips
    assert set(c.limits) == {"loss", "grad", "change"}
    assert check.compared(c.limits), "a cell compares at least one number"
    for k, lim in c.limits.items():
        if k in check.compared(c.limits):  # set between its readings, nearer the upper
            assert lim["lower"] < lim["limit"] < lim["upper"], (k, lim)
            assert lim["limit"] / lim["lower"] > lim["upper"] / lim["limit"], (k, lim)
        else:
            assert lim["lower"] > 0 and lim["why"], (k, lim)
    reported = {m["name"].split(".")[0] for m in c.end_to_end}
    assert reported == {"setup_s", "tokens_per_s", "peak_mem_gib"}
    moved = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in moved for m in c.per_layer), "a cell reports what its metrics move"
    assert c.per_layer
    assert c.config.flops(c.config.arch, c.traffic.rows, c.traffic.seq, c.frames()) > 0


def test_every_per_layer_metric_has_its_reader():
    readers = set(spec.reader_names())
    for m in BENCH["per_layer"]:
        assert spec.base_name(m["name"]) in readers
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names), names
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["why"]) <= 200 and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:  # every cell reports set-up, one more end-to-end metric, a layer
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2, (w["name"], e2e)
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
