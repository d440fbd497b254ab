"""Time B5a (range-quant ``encode``) and B5b (``decode``), as built from
several source trees, in one run on one NVIDIA GPU.

    python3 tools/range_quant_bench.py NAME=CSRC_DIR [NAME=CSRC_DIR ...] [--iters N]
        [--rows N]

Each ``NAME=CSRC_DIR`` is a directory holding ``range_quant.cu`` with its
headers: ``src/repro_torch/kernels/csrc``, or that directory of an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists (``build/``).  Each tree is compiled with the port's nvcc flags into
``build/range_quant_bench/<NAME>/`` (``kernel_trees.build_all``); its ptxas
lines are printed, and for each kernel instantiation the SASS instructions
of its storing loop per value (``kernel_trees.loop_per_value``: a loop
nested in it, such as the encode's exact path for the values its shortcut
leaves, is counted apart).

Two shapes, uint8 codes (8/3 bits):

* ``ops``: 221,184 rows of 640 slots, one fit per row -- what the
  kernel-composed pipeline's 220,038 chunks and ``chip_smoke.py``'s
  standalone phase give B5 (k = 615 kept of 2049 bins, padded to 640);
* ``chunk2048``: 442,368 rows of 384 slots, one fit per bucket over its
  8,192 rows -- the ``chunk=2048`` route's per-stage decode (k = 308, padded
  to 384).

The values are N(0, 1e-6) with each row's slots past the keep count zero,
as the pack leaves them; ``--rows`` cuts both shapes to that many rows.
Every tree's kernels are first held bitwise to the plain PyTorch versions
(the encode also on a row of ``chip_smoke.b5_edge_values``: NaN, -NaN,
+-inf, +-0, denormals, +-1e30, +-eps, +-eps/2 and the segment bounds, where
the count of values that disagree is printed), then timed with CUDA events (mean of ``--iters``
launches after one warm-up) in turns, trees in order and then in reverse,
so a drift of the card's clock shows as a gap between the two readings of
one tree.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from kernel_trees import build_all, library_path, loop_per_value, sass, time_ms

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "range_quant_bench"
SOURCE = "range_quant.cu"
N_BITS, M_BITS = 8, 3
SHAPES = ("ops", "chunk2048")


def print_sass(trees) -> None:
    """Each tree's B5 kernels: the storing loop's SASS instructions per
    value."""
    for name in trees:
        for kernel, code in sorted(sass(library_path(OUT, name, SOURCE)).items()):
            if "rq_" not in kernel:
                continue
            code_bytes = 2 if "unsigned short" in kernel else 1
            out_bytes = code_bytes if "encode" in kernel else 4
            loop = loop_per_value(code, out_bytes)
            if loop is None:
                print(f"[sass {name}] {kernel}: {len(code)} instructions, no storing loop found")
                continue
            n, values, nested = loop
            print(f"[sass {name}] {kernel}: {len(code)} instructions; storing loop {n} for "
                  f"{values:g} values = {n / values:.1f} a value (nested loops apart: {nested})")


def shape_inputs(shape, rows, dev):
    """(x, eps, p_codes) of one shape, cut to ``rows`` rows if given: the
    ``chunk=2048`` route's from ``chip_smoke.b5_chunk2048_inputs``, the ops
    shape's as N(0, 1e-6) values with slots past k = 615 zero and one fit
    per row."""
    import chip_smoke
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer

    if shape == "chunk2048":
        x, eps, p = chip_smoke.b5_chunk2048_inputs(dev)
        return x[:rows], eps[:rows], p[:rows]
    rows = rows or chip_smoke.main_path_rows()
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((rows, 640), generator=gen, device=dev) * 1e-3
    x[:, 615:] = 0.0
    q = fit_quantizer(x.amin(dim=-1), x.amax(dim=-1), RangeQuantConfig(N_BITS, M_BITS))
    return x, q.eps, q.p_codes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rows", type=int, default=None, help="default: each shape's")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("range_quant_bench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _checks, range_quant

    trees = dict(t.split("=", 1) for t in args.trees)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_all(trees, (SOURCE,), OUT)
    print_sass(trees)
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    m_scale = ctypes.c_float(float(1 << M_BITS))

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    calls = {}
    bad = 0
    for shape in SHAPES:
        x, q_eps, q_p = shape_inputs(shape, args.rows, dev)
        rows, cols = x.shape
        eps, p_codes, n_neg = _checks.encode_row_params(q_eps, q_p, N_BITS, rows, dev)
        want_codes = range_quant.encode_plain(x, q_eps, q_p)
        want_y = range_quant.decode_plain(want_codes, q_eps, q_p)
        codes = torch.empty_like(want_codes)
        y = torch.empty_like(want_y)
        edge = torch.zeros((1, 96), device=dev)
        chip_smoke.b5_edge_values(edge, eps[:1], 1)
        want_edge = range_quant.encode_plain(edge, eps[:1], p_codes[:1])
        edge_codes = torch.empty_like(want_edge)
        print(f"[{shape}] rows={rows} cols={cols}")
        for name in trees:
            lib = libs[name][SOURCE]
            enc = (lambda lib=lib, x=x, eps=eps, p_codes=p_codes, n_neg=n_neg, codes=codes:
                   lib.range_quant_encode(p(x), p(eps), p(p_codes), p(n_neg), x.shape[0],
                                          x.shape[1], m_scale, 1, p(codes), stream))
            dec = (lambda lib=lib, codes=want_codes, eps=eps, p_codes=p_codes, y=y:
                   lib.range_quant_decode(p(codes), p(eps), p(p_codes), codes.shape[0],
                                          codes.shape[1], m_scale, 1, p(y), stream))
            for fn in (enc, dec):
                if fn() != 0:
                    raise SystemExit(f"{name} {shape}: launch failed")
            torch.cuda.synchronize()
            mism = int((codes != want_codes).sum()) + int(
                (y.view(torch.int32) != want_y.view(torch.int32)).sum())
            rc = lib.range_quant_encode(p(edge), p(eps), p(p_codes), p(n_neg), 1, edge.shape[1],
                                        m_scale, 1, p(edge_codes), stream)
            torch.cuda.synchronize()
            edge_bad = int((edge_codes != want_edge).sum()) + (rc != 0)
            bad += mism
            print(f"[check {name} {shape}] mismatches={mism} (tolerance 0: bitwise); edge row: "
                  f"{edge_bad} of {edge.shape[1]} codes disagree (NaN: kernel "
                  f"{int(edge_codes[0, 0])}, plain {int(want_edge[0, 0])})")
            calls[(name, f"B5a encode {shape}")] = enc
            calls[(name, f"B5b decode {shape}")] = dec
    times = {}
    for key in list(calls) + list(calls)[::-1]:
        times.setdefault(key, []).append(time_ms(calls[key], args.iters))
    print(f"mean of {args.iters} launches, in turns (first, second reading):")
    for (name, kernel), (first, second) in sorted(times.items(), key=lambda kv: kv[0][1]):
        print(f"[time {name}] {kernel}: {first:.4f} {second:.4f} ms")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
