"""A/B of two checkouts of the repo on one NVIDIA GPU, end to end: pairs of
``chip_smoke.py --rows R`` runs and of the bisect training CLI, the order
alternating, then each phase's medians.

    python3 tools/phase_ab.py A=DIR B=DIR [--pairs 10] [--rows 16384] [--out DIR]
        [--cli bisect|no-stacked] [--cli-only]
    python3 tools/phase_ab.py --from-log FILE

Each ``DIR`` is a checkout (for instance ``git archive`` of a commit unpacked
into ``build/``, which ``.gitignore`` lists); its own ``chip_smoke.py`` and
package run from there.  Pair i runs A then B for odd i, B then A for even
i.  A run is ``python3 chip_smoke.py --rows R`` (its ``[phase ms]`` line: the
mean steady step of each training phase, and the ``ops`` pipeline's time),
then the CLI with ``--selector bisect --steps 5`` on the main path's
arguments (the mean of steps 1-4: "bisect CLI"); ``--cli no-stacked`` runs
the per-bucket loop (``--no-stacked``, selector auto) instead ("no-stacked
CLI"), and ``--cli-only`` leaves out ``chip_smoke.py``.  Every run's output goes to
``--out`` (default ``build/phase_ab``).  For each phase it prints A's
and B's medians, A's interquartile range, and the pairs in which B was
faster; for a phase that only one tree has, its median and interquartile
range.  ``--from-log FILE`` prints the same from the ``[pair ...]`` lines
of an earlier run's output, running nothing.  B's gain is claimed where B
is faster in at least 9 of 10 pairs and the medians differ by more than
A's interquartile range; a loss is shown where B is faster in at most 1 of
10 and slower by more than that range.  A run that fails stops the tool.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_CLI = ["--arch", "gemma2_2b", "--n-layers", "4", "--batch", "4", "--seq", "512",
            "--mode", "compressed_dp", "--reducer", "fft", "--error-feedback",
            "--backend", "auto", "--transport", "sequenced", "--bucket-mb", "64", "--steps", "5"]
CLIS = {"bisect": MAIN_CLI + ["--selector", "bisect"],
        "no-stacked": MAIN_CLI + ["--selector", "auto", "--no-stacked"]}


def run(cmd, cwd, log: Path, env=None) -> str:
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise SystemExit(f"{' '.join(cmd)} in {cwd} failed (rc {proc.returncode}); see {log}")
    return proc.stdout


def one_run(tree: Path, rows: int, log_stem: Path, cli: str, cli_only: bool) -> dict:
    """Phase -> ms of one chip_smoke run (unless ``cli_only``) and one run
    of the ``cli`` CLI in ``tree``."""
    phases = {}
    if not cli_only:
        out = run([sys.executable, "chip_smoke.py", "--rows", str(rows)], tree,
                  log_stem.with_suffix(".smoke.log"))
        line = next(ln for ln in out.splitlines() if ln.startswith("[phase ms]"))
        phases = {k: float(v) for k, v in re.findall(r"([\w-]+)=([\d.]+)", line)}
    env = dict(os.environ, PYTHONPATH="src")
    out = run([sys.executable, "-m", "repro_torch.launch.train", *CLIS[cli]], tree,
              log_stem.with_suffix(f".{cli}.log"), env=env)
    steps = [ast.literal_eval(ln) for ln in out.splitlines() if ln.startswith("{'")]
    dts = [row["dt"] * 1e3 for row in steps if row["step"] >= 1]
    phases[f"{cli} CLI"] = sum(dts) / len(dts)
    return phases


def quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[0], q[2]


def summarize(results, a_name: str, b_name: str, pairs: int) -> None:
    print(f"{pairs} pairs; medians {a_name} -> {b_name} (ms), {b_name} faster in, "
          f"{a_name} IQR, verdict:")
    for phase in [p for p in results[a_name][0] if p in results[b_name][0]]:
        a = [r[phase] for r in results[a_name]]
        b = [r[phase] for r in results[b_name]]
        q1, q3 = quartiles(a)
        wins = sum(y < x for x, y in zip(a, b))
        gap = statistics.median(a) - statistics.median(b)
        if wins >= 0.9 * pairs and gap > q3 - q1:
            verdict = f"{b_name} faster: claimed"
        elif wins <= 0.1 * pairs and -gap > q3 - q1:
            verdict = f"{b_name} slower, beyond {a_name}'s spread"
        else:
            verdict = "not resolved"
        print(f"[ab {phase}] {statistics.median(a):.1f} -> {statistics.median(b):.1f} "
              f"({wins}/{pairs}; IQR {q3 - q1:.1f}) {verdict}")
    for name, other in ((a_name, b_name), (b_name, a_name)):
        for phase in results[name][0]:
            if phase not in results[other][0]:
                xs = [r[phase] for r in results[name]]
                q1, q3 = quartiles(xs)
                print(f"[only {name} {phase}] median {statistics.median(xs):.2f} "
                      f"(IQR {q3 - q1:.2f})")


def read_log(path: str):
    """The trees' names and each one's phases by pair, from the ``[pair i
    NAME] phase=ms, ...`` lines of a run's output."""
    results = {}
    for line in open(path):
        m = re.match(r"\[pair \d+ (\S+)\] (.*)", line)
        if m:
            results.setdefault(m.group(1), []).append(
                {k: float(v) for k, v in (kv.rsplit("=", 1) for kv in m.group(2).split(", "))})
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="A=DIR B=DIR")
    ap.add_argument("--from-log", help="summarize an earlier run's output instead")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--out", default=str(ROOT / "build" / "phase_ab"))
    ap.add_argument("--cli", choices=sorted(CLIS), default="bisect")
    ap.add_argument("--cli-only", action="store_true", help="leave out chip_smoke.py")
    args = ap.parse_args()
    if args.from_log:
        results = read_log(args.from_log)
        a_name, b_name = results
        summarize(results, a_name, b_name, len(results[a_name]))
        return 0
    (a_name, a_dir), (b_name, b_dir) = (t.split("=", 1) for t in args.trees)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    results = {a_name: [], b_name: []}
    for i in range(1, args.pairs + 1):
        order = [(a_name, a_dir), (b_name, b_dir)]
        for name, tree in (order if i % 2 else order[::-1]):
            phases = one_run(Path(tree).resolve(), args.rows, out / f"{i}_{name}", args.cli,
                             args.cli_only)
            results[name].append(phases)
            print(f"[pair {i} {name}] " + ", ".join(f"{k}={v:.1f}" for k, v in phases.items()),
                  flush=True)
    summarize(results, a_name, b_name, args.pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
