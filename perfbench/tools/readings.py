"""The readings that set a cell's limits (not part of a benchmark run).

For each seed, in one process at the cell's own size:

* ``program``: the program's first steps (set-up as a run has it, the
  window closed after one step) against the reference: the lower readings;
* ``control``: the reference with every part the configuration states in
  float32 computed in bfloat16 (parameters, gradients as exchanged, the EF
  residual, AdamW's moments), against the reference: an upper reading;
* ``half_batch``, ``no_exchange``: the reference with that fault planted,
  against the reference (``no_exchange`` only with more than one worker).
  A step that returns its state unchanged reads 1 on ``change`` by the
  comparison's measure and needs no run.

    python3 perfbench/tools/readings.py --workload phi3m-l3.cdp.b4s512 \\
        --seeds 11,12,13 [--no-program] [--control] [--faults half_batch] [--leaves] \\
        [--out FILE]

Prints one JSON line a seed and reading; ``--out`` appends them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if HERE in sys.path:
    sys.path.remove(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from perfbench import bench, check, program, spec  # noqa: E402


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def leaf_gaps(prog, ref):
    """Each leaf's ``grad`` and ``change`` gap, as ``check.numbers`` takes
    the worst of them."""
    out = {}
    for key in ("grad", "change"):
        floor = statistics.median(ref[key].values())
        out[key] = {k: abs(prog[key][k] - v) / max(v, floor, 1e-30)
                    for k, v in ref[key].items()}
    return out


def readings(cell, seeds, device, *, arch=None, with_program=True, control=True,
             faults=(), log=print, leaves=False):
    """One dict a seed and reading: ``{"seed", "what", "loss", "grad",
    "change"}``."""
    import dataclasses

    a = None if arch is None else dataclasses.asdict(arch)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        prog = None
        if with_program:
            prog = program.run(cell, seed, 0.0, device, arch=arch)["readings"].__dict__
            _free(device)
        ref = bench.reference_readings(cell, seed, device, arch=a)
        _free(device)
        rows = []
        if prog is not None:
            rows.append(("program", check.numbers(prog, ref)))
            if leaves:
                log(json.dumps({"seed": seed, "leaves": leaf_gaps(prog, ref)}))
        if control:
            ctrl = bench.reference_readings(cell, seed, device, arch=a,
                                            state_dtype=torch.bfloat16)
            rows.append(("control", check.numbers(_as_readings(ctrl), ref)))
            _free(device)
        for fault in faults:
            f = bench.reference_readings(cell, seed, device, arch=a, fault=fault)
            rows.append((fault, check.numbers(_as_readings(f), ref)))
            _free(device)
        for what, nums in rows:
            row = dict(seed=seed, what=what, **nums)
            out.append(row)
            log(json.dumps(row))
        log(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                        "loss0": ref["loss"][0]}))
    return out


def _as_readings(ref):
    return {"loss": ref["loss"], "grad": ref["grad"], "change": ref["change"],
            "shapes": ref["shapes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--no-program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--leaves", action="store_true", help="each leaf's program gaps too")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    bench.set_cache_dirs()
    if not args.no_program:
        bench.prebuild_kernels(cell)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None

    def log(line):
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    readings(cell, seeds, torch.device("cuda", 0), with_program=not args.no_program,
             control=args.control, faults=[f for f in args.faults.split(",") if f], log=log,
             leaves=args.leaves)
    return 0


if __name__ == "__main__":
    sys.exit(main())
