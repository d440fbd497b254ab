"""Each cell's step traced with the port's dry-run (``repro_torch.launch.dryrun``)
on fake tensors, before the cell spends chip time: the predicted peak a
worker (the trace's argument bytes plus its temporaries' peak).  A cell on
more chips is traced over a fake world of that many ranks, one ``data``
axis.  Not part of a benchmark run.

    python3 perfbench/tools/dryrun_cells.py [--device cuda|cpu] [cell ...]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if HERE in sys.path:
    sys.path.remove(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from perfbench import program, spec  # noqa: E402


def predicted_peak(cell, device: str) -> float:
    """GiB a worker, by the dry-run's trace."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    cfg = program.arch_config(cell)
    t = cell.traffic
    shape = ShapeConfig(cell.name, t.seq, t.rows * t.workers, "train")
    reducer = program.reducer_config(t.data) if t.mode != "pjit" else None
    world = t.workers
    ctx = dryrun.fake_world(world) if world > 1 else contextlib.nullcontext()
    with ctx:
        mesh = make_local_mesh((world,), ("data",), device=device) if world > 1 else None
        m = dryrun.trace_cell(cfg, shape, mesh, mode=t.mode, device=device, skip_cost=True,
                              reducer=reducer)
    return (m["argument"] + m["temp"]) / 2 ** 30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args(argv)
    names = args.cells or [w["name"] for w in spec.benchmark()["workloads"]]
    for name in names:
        peak = predicted_peak(spec.load_cell(name), args.device)
        print(f"[dryrun] {name}: predicted peak {peak:.2f} GiB a worker", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
