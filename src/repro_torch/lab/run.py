"""CLI: run the convergence lab matrix on the port and write its report.

    PYTHONPATH=src python -m repro_torch.lab.run --smoke --workers 1   # one card
    PYTHONPATH=src python -m repro_torch.lab.run --smoke --workers 2 --device cpu
    PYTHONPATH=src python -m repro_torch.lab.run --chaos --workers 1

It runs on ``cuda`` unless ``--device cpu`` is given (and raises without a
GPU otherwise).  A row with one worker runs in this process; a row with N
spawns N processes: gloo on the CPU, NCCL with one GPU a worker on the card,
which must have N GPUs (a row is never shrunk to fit).  The JSON artifact
goes to ``--out`` (default ``lab_out/convergence.json``, or
``lab_out/chaos.json`` with ``--chaos``); ``--docs PATH`` splices the
results table into a markdown file holding ``report.MARKER`` (default
``skip``).  The exit status is nonzero when any claim fails.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.lab import report, spec
from repro_torch.lab.evaluate import chaos_claims, evaluate_results
from repro_torch.lab.runner import run_matrix

OUT_DIR = "lab_out"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="convergence lab matrix")
    p.add_argument("--smoke", action="store_true",
                   help="smoke matrix (tiny LM + convnet, every transport)")
    p.add_argument("--chaos", action="store_true",
                   help="chaos lane only: fault rows + their clean comparators, judged "
                        "by the resilience claims")
    p.add_argument("--workers", type=int, default=8,
                   help="workers a row (default 8: one GPU each on the card)")
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default cuda)")
    p.add_argument("--out", default=None,
                   help=f"JSON artifact path (default {OUT_DIR}/convergence.json; "
                        f"{OUT_DIR}/chaos.json with --chaos)")
    p.add_argument("--docs", default="skip",
                   help="markdown file to splice the results table into (default skip)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(OUT_DIR, "chaos.json" if args.chaos else "convergence.json")

    if args.chaos:
        matrix = spec.chaos_matrix(args.workers)
    elif args.smoke:
        matrix = spec.smoke_matrix(args.workers)
    else:
        matrix = spec.full_matrix(args.workers)
    results = run_matrix(matrix, verbose=not args.quiet, device=args.device)
    runs = {name: r.to_dict() for name, r in results.items()}
    if args.chaos:
        # only the resilience claims apply to the chaos lane
        claims = chaos_claims(runs)
        all_passed = bool(claims) and all(c.passed for c in claims)
    else:
        claims, all_passed = evaluate_results(runs)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    report.write_json(args.out, runs, [c.to_dict() for c in claims], all_passed)
    print(f"[lab] wrote {args.out}")
    if args.docs != "skip":
        block = report.render_markdown(runs, [c.to_dict() for c in claims], all_passed)
        if report.splice_experiments_md(args.docs, block):
            print(f"[lab] updated {args.docs}")
        else:
            print(f"[lab] marker not found in {args.docs}; table not spliced")

    for c in claims:
        print(f"[lab] {'PASS' if c.passed else 'FAIL'} {c.name}: {c.detail}")
    print(f"[lab] {'ALL CLAIMS PASS' if all_passed else 'CLAIM FAILURES'}")
    return 0 if all_passed else 1


if __name__ == "__main__":
    sys.exit(main())
