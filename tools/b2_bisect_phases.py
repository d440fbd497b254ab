"""Where a row's time goes in B2's bisecting kernel (``fused_compress_bisect``,
the ``kBisect`` instantiation of ``csrc/fused_compress.cu``), as built from
several source trees, in one run on one NVIDIA GPU.

    python3 tools/b2_bisect_phases.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]
        [--rows N] [--cols 2049|1025] [--iters N]

Each tree's ``fused_compress.cu`` is compiled with ``-DREPRO_PHASE_CLOCKS``
into ``build/b2_bisect_phases/<NAME>/`` (``kernel_trees.build_all``), which
makes thread 0 of every CTA add ``clock64()`` at nine points of its row to
device counters; trees whose source has no such counters are skipped.  The
inputs are ``chip_smoke.py``'s kernel phase (the rfft of N(0, 1e-6) chunks
at the main path's rows, its padding rows all zero, one quantizer fit a
row).  For each tree it prints the kernel's time with the stamps (CUDA
events, mean of ``--iters`` launches after one) and the mean cycles a row
spends from one point to the next: the loads and magnitudes, count(>= 0)
and the maximum, the sweeps over the row, the compaction, the sweeps over
the candidates, warp 0's rank and replay (with the barrier after it),
phases 1 and 2, and phase 3.  The stamps
cost registers and atomics, so the time is not the kernel's own: compare
trees within one run.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from kernel_trees import build_all, time_ms

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "b2_bisect_phases"
PHASES = ("loads and magnitudes", "count(>= 0) and maximum", "sweeps over the row",
          "compaction", "sweeps over the candidates", "rank and replay", "phases 1-2", "phase 3")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rows", type=int, default=None, help="default: the main path's")
    ap.add_argument("--cols", type=int, default=2049, choices=(2049, 1025))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_bisect_phases: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import selection, sparsify
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
    from repro_torch.kernels import _checks, fused_compress

    trees = dict(t.split("=", 1) for t in args.trees)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_all(trees, ["fused_compress.cu"], OUT, extra_flags=["-DREPRO_PHASE_CLOCKS"])
    dev = torch.device("cuda", 0)
    cols = args.cols
    chunk = 2 * (cols - 1)
    rows = args.rows or chip_smoke.main_path_rows(chunk)
    k = sparsify.keep_count(cols, chip_smoke.KEEP_THETA)
    k_pad = fused_compress.pad_k(k)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    re, im, w, mag, n_zero = chip_smoke.spectrum(rows, chunk, dev)
    del mag
    q = fit_quantizer(torch.minimum(re.amin(dim=-1), im.amin(dim=-1)),
                      torch.maximum(re.amax(dim=-1), im.amax(dim=-1)), RangeQuantConfig(8, 3))
    eps, p_codes, n_neg = _checks.encode_row_params(q.eps, q.p_codes, 8, rows, dev)
    rec = torch.empty((rows, k_pad), dtype=torch.uint8, device=dev)
    imc = torch.empty_like(rec)
    idx = torch.empty((rows, k_pad), dtype=torch.int32, device=dev)
    tau = torch.empty((rows,), device=dev)
    print(f"rows={rows} ({n_zero} all zero), cols={cols}, k={k}, k_pad={k_pad}")

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    for name, lib in ((n, libs[n]["fused_compress.cu"]) for n in trees):
        if not hasattr(lib, "fused_compress_phase_clocks"):
            print(f"[phases {name}] no phase clocks in this tree: skipped")
            continue

        def launch(lib=lib):
            rc = lib.fused_compress_bisect(
                p(re), p(im), p(w), p(eps), p(p_codes), p(n_neg), rows, cols, k_pad,
                ctypes.c_float(8.0), 1, p(rec), p(imc), p(idx), k, selection.BISECT_ITERS,
                p(tau), stream)
            if rc:
                raise SystemExit(f"{name}: launch failed ({rc})")

        ms = time_ms(launch, args.iters)
        torch.cuda.synchronize()
        lib.fused_compress_phase_clocks(sums)  # back to 0
        launch()
        torch.cuda.synchronize()
        if lib.fused_compress_phase_clocks(sums):
            raise SystemExit(f"{name}: reading the clocks failed")
        per_row = [(sums[i + 1] - sums[i]) / rows for i in range(len(PHASES))]
        print(f"[phases {name}] {ms:.3f} ms with the stamps; cycles a row, "
              f"{(sums[len(PHASES)] - sums[0]) / rows:.0f} in all: "
              + ", ".join(f"{label} {c:.0f}" for label, c in zip(PHASES, per_row)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
