"""Hold the ``train`` phase of ``chip_smoke.py`` bitwise across checkouts.

    python3 tools/train_parity.py parent=build/parent final=.

Each NAME=DIR is the root of a checkout (an earlier commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, such as
``build/``).  For each, in a process of its own and in the order given, it
builds that checkout's kernels and runs that checkout's ``chip_smoke.py``
``train`` phase (gemma2_2b full width, 4 layers, 3 compressed_dp EF steps,
sequenced, 64 MB buckets, backend and selector ``auto``) and prints its
losses and the sha256 of every final parameter and of the residual.  Exits
1 unless every checkout gives the same losses and digests.  Needs one GPU;
about 40 s a checkout with its build.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import torch
sys.path[:0] = [ROOT, ROOT + "/src"]
import chip_smoke as cs
from repro_torch.kernels import all_kernels, build
from repro_torch.launch import train as train_cli
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels = all_kernels()
build.build(sorted({k.source for k in kernels}))
fused = ("fused_compress", "fused_decompress", "sampled_threshold")
cs.train_phase(lambda: train_cli.main(cs.TRAIN_ARGS + cs.SEQUENCED + ["--steps", "3"]),
               kernels, "train", fused, digest=True)
losses, digests = cs.DIGESTS["train"]
print("TRAIN_PARITY " + json.dumps({"losses": losses, "digests": digests}), flush=True)
"""


def main(argv) -> int:
    trees = dict(arg.split("=", 1) for arg in argv)
    if not trees:
        print(__doc__)
        return 2
    results = {}
    for name, root in trees.items():
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", f"ROOT = {root!r}\n" + CHILD],
                              capture_output=True, text=True, cwd=root)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN_PARITY ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            print(f"{name}: the train phase failed (rc {proc.returncode})")
            return 1
        results[name] = json.loads(lines[-1][len("TRAIN_PARITY "):])
        print(f"[{name}] losses {results[name]['losses']}; "
              f"{len(results[name]['digests'])} final tensors", flush=True)
    first = next(iter(results))
    same = True
    for name, res in results.items():
        differ = sorted(k for k in res["digests"]
                        if res["digests"][k] != results[first]["digests"].get(k))
        equal = res["losses"] == results[first]["losses"] and not differ and (
            set(res["digests"]) == set(results[first]["digests"]))
        same &= equal
        print(f"[{name}] against {first}: losses and digests "
              f"{'bitwise equal' if equal else 'DIFFER in ' + str(differ[:5])}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
