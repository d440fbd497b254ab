"""The spreads that set the end-to-end bounds, from the log of a call that
ran a cell's two sets (not part of a benchmark run).

Each run in the log is a ``=== <set> seed <n> trace <0|1>`` line followed,
some lines later, by the run's result line.  For every end-to-end metric
and each set of untraced runs: the median and the spread, the distance
between the first and the third quartile as Python's
``statistics.quantiles(values, n=4)`` gives them, as a share of the
median; and the bound the widest spread suggests (5x, at least 1%).

    python3 perfbench/tools/spread.py chiprun_out/<log> [more logs]
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def runs(lines):
    """(set, seed, trace, result) of every run in a log."""
    head = None
    for line in lines:
        if line.startswith("=== "):
            parts = line.split()
            head = (parts[1], int(parts[3]), int(parts[5]))
        elif line.startswith("{") and head is not None:
            try:
                yield head + (json.loads(line),)
            except json.JSONDecodeError:
                pass
            head = None


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv) -> int:
    lines = [ln.rstrip("\n") for path in argv for ln in open(path)]
    found = list(runs(lines))
    sets = defaultdict(lambda: defaultdict(list))
    for name, seed, trace, res in found:
        if not res.get("correct"):
            print(f"NOT CORRECT: set {name} seed {seed} trace {trace}: {res.get('checks')}")
        if trace == 0 and name != "T":
            for metric, v in res["metrics"].items():
                sets[name][metric].append(v["value"])
    print(f"{len(found)} runs, {sum(bool(r[3].get('correct')) for r in found)} correct, "
          f"{len({r[1] for r in found})} seeds")
    metrics = sorted({m for s in sets.values() for m in s})
    for metric in metrics:
        widest = 0.0
        for name in sorted(sets):
            vals = sets[name][metric]
            if len(vals) >= 2:
                sp = spread(vals)
                widest = max(widest, sp)
                print(f"{metric} set {name}: n={len(vals)} median {statistics.median(vals)!r} "
                      f"spread {sp:.5f} values {vals}")
        print(f"{metric}: widest spread {widest:.5f} -> bound {max(0.01, 5 * widest):.4f}")
    for name, seed, trace, res in found:
        if trace == 1:
            print(f"traced seed {seed}: {json.dumps(res['metrics'])} device "
                  f"{json.dumps({k: res['device'][k] for k in ('busy_s', 'window_s')})}")
    checks = defaultdict(list)
    for _, _, _, res in found:
        for k, c in res.get("checks", {}).items():
            checks[k].append(c["value"])
    for k, vals in checks.items():
        print(f"check {k}: max {max(vals)!r} over {len(vals)} runs")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
