"""Time the port's compress-side kernels, B2 (``fused_compress``), B4
(``sampled_threshold``), B1 (``topk_threshold``) and B6a (``pack``), as
built from several source trees, in one run on one NVIDIA GPU.

    python3 tools/compress_kernels_bench.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]
        [--rows N] [--iters N] [--cols C] [--b4-sweeps N,..] [--b1-sweeps N,..]

Each ``NAME=CSRC_DIR`` is a directory holding ``fused_compress.cu``,
``sampled_threshold.cu``, ``topk_threshold.cu`` and ``pack.cu`` with their
headers: ``src/repro_torch/kernels/csrc``, or that directory of an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists (``build/``).  Each tree is compiled with the port's nvcc flags into
``build/compress_kernels_bench/<NAME>/`` (``kernel_trees.build_all``: one
nvcc per source, all at once); its ptxas register and spill lines are
printed.

The inputs are ``chip_smoke.py``'s kernel phase: the rfft of N(0, 1e-6)
chunks of 4096 at the main path's rows (221,184 by default, the stacked
layout's 1,146 padding rows all zero), k = 615 of 2049 bins, B4 whole
(the sample's bracket, the refinement and the mid-gap; a tree from before
the bracket moved into B4 is given the plain bracket and timed as "B4
bracket given"), B2's mid-gap tau and one
quantizer fit per row, B6a's tau from B1 on the same magnitudes (k_pad =
640 slots).  ``--cols 1025`` runs the ``chunk=2048`` route's shapes instead
(chunks of 2048, 442,368 rows by default, k = 308); ``--rows 4096`` one
bucket's rows, as the per-bucket loop launches them.  Every tree's kernels
are first held bitwise to the plain PyTorch versions, then timed with CUDA
events (mean of ``--iters`` launches after one warm-up) in turns, trees in
order and then in reverse, so a drift of the card's clock shows as a gap
between the two readings of one tree.  B4 is also timed at the sweep counts
of ``--b4-sweeps`` (default 0: its loads, the sample's bracket, the clamp
and the mid-gap alone) and B1 at
those of ``--b1-sweeps`` (default 0: its loads and the maximum pass), each
checked against the plain version with that many sweeps, which splits a
kernel's time between the row's pass over device memory and the sweeps; B2
is also timed with tau = +inf (nothing kept, so nothing encoded: the loads,
the compaction and the zero stores alone), and with no tau (its own
bisection, ``fused_compress_bisect``) in the trees that have that entry.  Last, B1 and B4 run on rows
that hold a NaN or +inf, and the rows where they disagree with their plain
versions are counted; the run exits with 1 if any tree disagrees on one.
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
OUT = ROOT / "build" / "compress_kernels_bench"
SOURCES = ("fused_compress.cu", "sampled_threshold.cu", "topk_threshold.cu", "pack.cu")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rows", type=int, default=None, help="default: the main path's")
    ap.add_argument("--cols", type=int, default=2049, choices=(2049, 1025))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--b4-sweeps", type=lambda v: [int(x) for x in v.split(",") if x],
                    default=[0], help="B4 also timed at these sweep counts (default 0)")
    ap.add_argument("--b1-sweeps", type=lambda v: [int(x) for x in v.split(",") if x],
                    default=[0], help="B1 also timed at these sweep counts (default 0)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compress_kernels_bench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import selection, sparsify
    from repro_torch.kernels import (_checks, fused_compress, pack, sampled_threshold,
                                     topk_threshold)

    trees = dict(t.split("=", 1) for t in args.trees)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_all(trees, SOURCES, OUT)
    dev = torch.device("cuda", 0)
    cols = args.cols
    chunk = 2 * (cols - 1)
    rows = args.rows or chip_smoke.main_path_rows(chunk)
    k = sparsify.keep_count(cols, chip_smoke.KEEP_THETA)
    k_pad = fused_compress.pad_k(k)
    iters = selection.DEFAULT_REFINE_ITERS
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    re, im, w, mag, n_zero = chip_smoke.spectrum(rows, chunk, dev)
    lo, hi = selection.sample_bracket(selection.strided_sample(mag), k, cols)
    lo, hi = lo.float().contiguous(), hi.float().contiguous()
    layout = selection._sample_layout(cols, selection.DEFAULT_SAMPLE_RATE, 0)
    ranks = selection.sample_ranks(k, layout[0], cols)
    want_b4 = sampled_threshold.sampled_select_plain(mag, k=k)
    want_b4_sweeps = {n: sampled_threshold.sampled_select_plain(mag, k=k, refine_iters=n)
                      for n in args.b4_sweeps}
    want_b1 = topk_threshold.threshold_plain(mag, k)
    want_b1_sweeps = {}
    for n in args.b1_sweeps:
        t = selection.bisect_tau(mag, k, n)[:, None]
        want_b1_sweeps[n] = (t, (mag >= t).sum(dim=-1, keepdim=True, dtype=torch.int32))
    pack_tau = want_b1[0].reshape(rows).contiguous()
    want_b6a = pack.pack_plain(mag, pack_tau, k=k_pad)
    tau, q_eps, q_p = chip_smoke.compress_params(mag, re, im, want_b4[0])
    tau = tau.reshape(rows).contiguous()
    eps, p_codes, n_neg = _checks.encode_row_params(q_eps, q_p, 8, rows, dev)
    want_b2 = fused_compress.fused_compress_plain(re, im, w, q_eps, q_p, tau, k_keep=k)
    tau_none = torch.full_like(tau, float("inf"))  # B2 with nothing kept: no encode
    want_b2_none = fused_compress.fused_compress_plain(re, im, w, q_eps, q_p, tau_none,
                                                       k_keep=k)
    want_b2_bisect = fused_compress.fused_compress_plain(re, im, w, q_eps, q_p, k_keep=k)
    print(f"rows={rows} ({n_zero} all zero), cols={cols}, k={k}, k_pad={k_pad}")

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    tau_out = torch.empty((rows, 1), device=dev)
    cnt_out = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    mid_out = torch.empty((rows, 1), device=dev)
    rec = torch.empty((rows, k_pad), dtype=torch.uint8, device=dev)
    imc = torch.empty_like(rec)
    idx = torch.empty((rows, k_pad), dtype=torch.int32, device=dev)
    vals = torch.empty((rows, k_pad), device=dev)
    calls = {}
    for name in trees:
        b1, b4, b2, b6 = (libs[name][s] for s in ("topk_threshold.cu", "sampled_threshold.cu",
                                                 "fused_compress.cu", "pack.cu"))
        calls[(name, "B1")] = (lambda b1=b1: b1.topk_threshold(
            p(mag), rows, cols, k, selection.BISECT_ITERS, p(tau_out), p(cnt_out), stream),
            lambda: (tau_out, cnt_out), want_b1)
        for n in args.b1_sweeps:
            calls[(name, f"B1 sweeps={n}")] = (lambda b1=b1, n=n: b1.topk_threshold(
                p(mag), rows, cols, k, n, p(tau_out), p(cnt_out), stream),
                lambda: (tau_out, cnt_out), want_b1_sweeps[n])
        calls[(name, "B6a")] = (lambda b6=b6: b6.pack(
            p(mag), p(pack_tau), rows, cols, k_pad, p(vals), p(idx), stream),
            lambda: (vals, idx), want_b6a)
        for n in [iters] + args.b4_sweeps:
            label = "B4" if n == iters else f"B4 sweeps={n}"
            want = want_b4 if n == iters else want_b4_sweeps[n]
            if hasattr(b4, "sampled_select"):
                calls[(name, label)] = (lambda b4=b4, n=n: b4.sampled_select(
                    p(mag), rows, cols, k, *layout, *ranks, selection.BISECT_ITERS, n,
                    p(tau_out), p(cnt_out), p(mid_out), None, stream),
                    lambda: (tau_out, cnt_out, mid_out), want)
            else:  # before the sample's bracket and the mid-gap moved into B4
                calls[(name, label + " bracket given")] = (lambda b4=b4, n=n: b4.sampled_threshold(
                    p(mag), p(lo), p(hi), rows, cols, k, n, p(tau_out), p(cnt_out), stream),
                    lambda: (tau_out, cnt_out), want[:2])
        calls[(name, "B2")] = (lambda b2=b2: b2.fused_compress(
            p(re), p(im), p(w), p(tau), p(eps), p(p_codes), p(n_neg), rows, cols, k_pad,
            ctypes.c_float(8.0), 1, p(rec), p(imc), p(idx), stream),
            lambda: (rec, imc, idx), want_b2[:3])
        calls[(name, "B2 none kept")] = (lambda b2=b2: b2.fused_compress(
            p(re), p(im), p(w), p(tau_none), p(eps), p(p_codes), p(n_neg), rows, cols, k_pad,
            ctypes.c_float(8.0), 1, p(rec), p(imc), p(idx), stream),
            lambda: (rec, imc, idx), want_b2_none[:3])
        if hasattr(b2, "fused_compress_bisect"):
            calls[(name, "B2 tau=None")] = (lambda b2=b2: b2.fused_compress_bisect(
                p(re), p(im), p(w), p(eps), p(p_codes), p(n_neg), rows, cols, k_pad,
                ctypes.c_float(8.0), 1, p(rec), p(imc), p(idx), k, selection.BISECT_ITERS,
                p(tau_out), stream), lambda: (rec, imc, idx, tau_out), want_b2_bisect)
    for key, (fn, got, want) in calls.items():
        rc = fn()
        if rc != 0:
            raise SystemExit(f"{key}: launch failed ({rc})")
        torch.cuda.synchronize()
        mism = sum(int((a.reshape(b.shape).view(torch.int32) != b.view(torch.int32)).sum())
                   if a.dtype == torch.float32 else int((a.reshape(b.shape) != b).sum())
                   for a, b in zip(got(), want))
        print(f"[check {key[0]} {key[1]}] mismatches={mism} (tolerance 0: bitwise)")
        if mism:
            raise SystemExit(f"{key}: disagrees with the plain version")
    times = {}
    for key in list(calls) + list(calls)[::-1]:
        times.setdefault(key, []).append(time_ms(calls[key][0], args.iters))
    print(f"rows={rows}, cols={cols}, mean of {args.iters} launches, in turns "
          "(first, second reading):")
    for (name, kernel), (first, second) in sorted(times.items(), key=lambda kv: kv[0][1]):
        print(f"[time {name}] {kernel}: {first:.3f} {second:.3f} ms")
    return 1 if edge_rows(libs, mag, k, stream) else 0


def edge_rows(libs, mag, k, stream, n=256):
    """B1 and B4 of every tree on ``n`` rows that each hold a NaN and ``n``
    that each hold a +inf, the rest of those scaled by 1e30 (in half of
    each the sample's columns 0, so B4's clamp falls back to
    nextafter(max)), against their plain versions: the rows that disagree
    are counted; returns how many disagreed in all.  A tree whose B4 takes
    the bracket (before the sample's bracket moved into it) is given the
    plain one."""
    from repro_torch.core import selection
    from repro_torch.kernels import sampled_threshold, topk_threshold

    mag = torch.cat([mag[:n], mag[:n] * 1e30])  # the +inf rows' rest far from 0
    mag[:n, 7] = float("nan")
    mag[n:, -1] = float("inf")
    rows, cols = mag.shape
    layout = selection._sample_layout(cols, selection.DEFAULT_SAMPLE_RATE, 0)
    mag[::2, layout[2]::layout[1]][:, :layout[0]] = 0.0
    ranks = selection.sample_ranks(k, layout[0], cols)
    lo, hi = selection.sample_bracket(selection.strided_sample(mag), k, cols)
    lo, hi = lo.contiguous(), hi.contiguous()
    want = {"B1": topk_threshold.threshold_plain(mag, k),
            "B4": sampled_threshold.sampled_select_plain(mag, k=k)[:2]}
    tau = torch.empty((rows, 1), device=mag.device)
    cnt = torch.empty((rows, 1), dtype=torch.int32, device=mag.device)
    mid = torch.empty((rows, 1), device=mag.device)
    ptr = ctypes.c_void_p
    total = 0
    for name, trees in libs.items():
        for kernel in ("B1", "B4"):
            if kernel == "B1":
                rc = trees["topk_threshold.cu"].topk_threshold(
                    ptr(mag.data_ptr()), rows, cols, k, selection.BISECT_ITERS,
                    ptr(tau.data_ptr()), ptr(cnt.data_ptr()), stream)
            elif hasattr(trees["sampled_threshold.cu"], "sampled_select"):
                rc = trees["sampled_threshold.cu"].sampled_select(
                    ptr(mag.data_ptr()), rows, cols, k, *layout, *ranks, selection.BISECT_ITERS,
                    selection.DEFAULT_REFINE_ITERS, ptr(tau.data_ptr()), ptr(cnt.data_ptr()),
                    ptr(mid.data_ptr()), None, stream)
            else:
                rc = trees["sampled_threshold.cu"].sampled_threshold(
                    ptr(mag.data_ptr()), ptr(lo.data_ptr()), ptr(hi.data_ptr()), rows, cols, k,
                    selection.DEFAULT_REFINE_ITERS, ptr(tau.data_ptr()), ptr(cnt.data_ptr()),
                    stream)
            torch.cuda.synchronize()
            w_tau, w_cnt = want[kernel]
            bad = ((tau.view(torch.int32) != w_tau.view(torch.int32)) | (cnt != w_cnt)).reshape(-1)
            total += int(bad.sum()) + (rc != 0)
            print(f"[edge rows {name}] {kernel} (rc {rc}): {int(bad[:n].sum())} of {n} rows "
                  f"holding a NaN and {int(bad[n:].sum())} of {n} holding a +inf disagree "
                  "with the plain version")
    return total


if __name__ == "__main__":
    sys.exit(main())
