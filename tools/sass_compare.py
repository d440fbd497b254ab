"""Compare the SASS of the port's kernels as built from two source trees,
kernel by kernel, on a machine with the CUDA toolkit.

    python3 tools/sass_compare.py A=CSRC_DIR B=CSRC_DIR [--sources a.cu,b.cu] [--out FILE]

Each source (default: every ``*.cu`` of B) is compiled from both trees with
the port's nvcc flags into ``build/sass_compare/<NAME>/``
(``kernel_trees.build_all``, which prints the ptxas lines).  Kernels are
matched by their demangled names without parameter lists (a trailing
``false`` template argument is dropped, so a kernel that gained a ``bool``
mode is matched with its earlier self).  For each source it prints how many
kernels have the same instructions in both trees, and for each that does
not, how many instruction lines differ; kernels of one tree only are
listed.  ``--out`` writes both trees' SASS of the differing kernels there.
"""

from __future__ import annotations

import argparse
import difflib
import sys
from pathlib import Path

from kernel_trees import build_all, library_path, sass

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "sass_compare"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2, help="NAME=CSRC_DIR")
    ap.add_argument("--sources", default=None, help="comma-separated; default every *.cu of B")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    trees = dict(t.split("=", 1) for t in args.trees)
    (a, a_dir), (b, b_dir) = trees.items()
    sources = (args.sources.split(",") if args.sources
               else sorted(p.name for p in Path(b_dir).glob("*.cu")))
    build_all(trees, sources, OUT)
    report = []
    for source in sources:
        code_a = sass(library_path(OUT, a, source))
        code_b = sass(library_path(OUT, b, source))
        same, differ = 0, []
        for name in sorted(set(code_a) & set(code_b)):
            ins_a = [ins for _, ins in code_a[name]]
            ins_b = [ins for _, ins in code_b[name]]
            if ins_a == ins_b:
                same += 1
                continue
            changed = sum(1 for line in difflib.unified_diff(ins_a, ins_b, lineterm="", n=0)
                          if line[:1] in "+-" and line[:3] not in ("+++", "---"))
            differ.append(name)
            print(f"[sass {source}] {name}: {changed} of {len(ins_a)} / {len(ins_b)} "
                  "instruction lines differ")
            report += [f"=== {name}", f"--- {a}", *ins_a, f"+++ {b}", *ins_b]
        print(f"[sass {source}] {same} kernels identical, {len(differ)} differ; only in {a}: "
              f"{len(set(code_a) - set(code_b))}, only in {b}: {len(set(code_b) - set(code_a))}")
        for name in sorted(set(code_b) - set(code_a))[:4]:
            print(f"[sass {source}]   only in {b}: {name}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
