"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the reference package
``repro``; and its entry points refuse to fall back to the CPU."""

import ast
import os

import pytest
import torch

from helpers import REPO

FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference():
    files = list(_port_files())
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), root) for f in files for root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda_unless_cpu_requested(monkeypatch):
    from repro_torch import device
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1", "--mode", "compressed_dp",
                    "--transport", "sequenced"])
    assert device.resolve("cpu").type == "cpu"


def test_cli_refuses_unported_flags(capsys):
    from repro_torch.launch import train

    for flags in (["--mode", "hierarchical"], ["--publish-dir", "ring"],
                  ["--mesh", "production"], ["--mesh", "multi_pod"]):
        with pytest.raises(SystemExit):
            train.main(["--reduced", "--device", "cpu", "--steps", "1", *flags])
        assert "ROADMAP" in capsys.readouterr().err
