"""How many sweeps B1 (``csrc/topk_threshold.cu``) runs on the main path's
rows, read off the numpy walk of its warp routine
(``tests/test_torch_compress_threshold_design.py``: ``b1_walk``).

    python3 tools/b1_sweeps.py [--sample 4096] [--device cuda] [--rows N]

Makes ``chip_smoke.py``'s kernel-phase magnitudes (the rfft of N(0, 1e-6)
chunks of 4096 at 221,184 rows of 2049 bins, the stacked layout's 1,146
padding rows all zero; on the GPU by default, which gives the same numbers
as the kernel phase), walks ``--sample`` evenly spaced rows that are not
padding and the first 16 padding rows with k = 615, and prints the mean and
largest number of sweeps and the sweep from which the candidates served,
and the mean over all rows with the padding rows' share.  ``--rows`` makes
fewer rows (the first rows of the layout), for a short run on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sample", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None, help="default: the main path's")
    args = ap.parse_args()
    for sub in ("src", "tests", ""):
        sys.path.insert(0, str(ROOT / sub))
    import chip_smoke
    from repro_torch.core import sparsify
    from test_torch_compress_threshold_design import b1_walk

    dev = torch.device(args.device)
    rows = args.rows or chip_smoke.main_path_rows()
    cols = 2049
    k = sparsify.keep_count(cols, chip_smoke.KEEP_THETA)
    *_, mag, n_zero = chip_smoke.spectrum(rows, 4096, dev)
    zero = torch.zeros(rows, dtype=torch.bool, device=dev)
    zero[chip_smoke.padding_rows(rows, dev)] = True
    live = torch.nonzero(~zero).reshape(-1)
    sample = min(args.sample, live.numel())
    pick = live[torch.linspace(0, live.numel() - 1, sample, device=dev).long()]
    walks = {}
    for kind, idx in (("spectrum", pick), ("padding", torch.nonzero(zero).reshape(-1)[:16])):
        if idx.numel():
            walks[kind] = [b1_walk(row, k) for row in mag[idx].cpu().numpy()]
    for kind, w in walks.items():
        sweeps = np.array([x[2] for x in w])
        compact = np.array([x[3] if x[3] is not None else 0 for x in w])
        print(f"[b1 sweeps {kind}] {len(w)} rows: sweeps mean {sweeps.mean():.3f} max "
              f"{sweeps.max()} min {sweeps.min()}; candidates from sweep mean "
              f"{compact.mean():.3f} max {compact.max()} (0: never)")
    mean_live = np.mean([x[2] for x in walks["spectrum"]])
    mean_zero = np.mean([x[2] for x in walks.get("padding", [(0, 0, 0)])])
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    mean = ((rows - n_zero) * mean_live + n_zero * mean_zero) / rows
    print(f"[b1 sweeps all] {rows} rows made on {where}, {n_zero} of them padding: "
          f"mean {mean:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
