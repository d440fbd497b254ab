"""Build the port's kernels from several source trees and time them: the
shared part of ``fft_core_bench.py`` and ``compress_kernels_bench.py``.

A tree is a directory holding ``csrc`` sources and their headers:
``src/repro_torch/kernels/csrc``, or that directory of an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch


def build_all(trees, sources, out_dir):
    """One nvcc per (tree, source), all at once, with the port's flags, into
    ``out_dir/<name>/``; prints each build's ptxas register lines and any
    line that reports spill bytes.  ``trees`` maps a name to a directory.
    Returns {name: {source: CDLL}}."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    jobs = []
    for name, src in trees.items():
        (Path(out_dir) / name).mkdir(parents=True, exist_ok=True)
        for source in sources:
            target = Path(out_dir) / name / source.replace(".cu", ".so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(target), str(Path(src) / source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((name, source, target, proc))
    libs = {}
    for name, source, target, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(out)
            raise SystemExit(f"{name}/{source}: nvcc failed")
        for line in out.splitlines():
            if "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
                print(f"[ptxas {name}/{source}] {line.strip()}")
        libs.setdefault(name, {})[source] = ctypes.CDLL(str(target))
    return libs


def time_ms(fn, iters):
    """Mean device time (ms, CUDA events) of ``iters`` calls after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
