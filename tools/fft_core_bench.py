"""Time the port's FFT kernels, B7 (``fft4096``) and B3 (``fused_decompress``),
as built from several source trees, in one run on one NVIDIA GPU.

    python3 tools/fft_core_bench.py NAME=CSRC_DIR [NAME=CSRC_DIR ...] [--rows N]

Each ``NAME=CSRC_DIR`` is a directory holding ``fft4096.cu`` and
``fused_decompress.cu`` with their headers: ``src/repro_torch/kernels/csrc``,
or that directory of an earlier commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``).  Each tree is compiled with
the port's nvcc flags into ``build/fft_core_bench/<NAME>/``; its ptxas
register and spill lines are printed.  At the main path's rows (221,184 by
default), every tree's B7 forward, B7 inverse and B3 are first held to the
plain PyTorch versions (max abs error <= 2e-6 * max per row; B7 on the
first 32,768 rows, where the plain four-step fits beside the rest), then
timed with CUDA events (mean of ``--iters`` launches after one warm-up) in
turns, trees in order and then in reverse, so a drift of the card's clock
shows as a gap between the two readings of one tree.  ``torch.fft.fft`` of
B7's planes and ``torch.fft.irfft`` of a (rows, 2049) spectrum are timed
beside them.

B3's payload: k = 615 distinct bins per row (uint8 codes, int16 indices),
one quantizer fit per row; the imaginary codes at DC and Nyquist are 0, as
in the spectrum of a real signal (cuFFT's C2R, which the plain version
calls, does not ignore an imaginary part there).  A tree whose
``fft4096.cuh`` has ``fft4096_bitrev`` (the radix-2 kernels) takes their
2048-entry twiddle table; the others take ``fft4step.twiddles()``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from kernel_trees import build_all, time_ms

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "fft_core_bench"
KEEP_K = 615


def radix2_twiddles(dev):
    ang = 2.0 * np.pi * np.arange(2048, dtype=np.float64) / 4096
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rows", type=int, default=221184)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fft_core_bench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
    from repro_torch.kernels import fft4step, fused_decompress

    trees = dict(t.split("=", 1) for t in args.trees)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_all(trees, ("fft4096.cu", "fused_decompress.cu"), OUT)
    dev = torch.device("cuda", 0)
    rows = args.rows
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    radix2 = {name for name, src in trees.items()
              if "fft4096_bitrev" in (Path(src) / "fft4096.cuh").read_text()}
    tables = {name: radix2_twiddles(dev) if name in radix2 else fft4step.twiddles(dev)
              for name in trees}

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    def checked(label, rc):
        if rc != 0:
            raise SystemExit(f"{label}: launch failed ({rc})")

    gen = torch.Generator(device=dev).manual_seed(0)
    x_re = torch.randn((rows, 4096), generator=gen, device=dev)
    x_im = torch.randn((rows, 4096), generator=gen, device=dev)
    y_re, y_im = torch.empty_like(x_re), torch.empty_like(x_im)
    calls = {}
    for name in trees:
        lib, tw = libs[name]["fft4096.cu"], tables[name]
        for inverse in (0, 1):
            calls[(name, "B7 inverse" if inverse else "B7 forward")] = (
                lambda lib=lib, tw=tw, inverse=inverse: lib.fft4096(
                    p(x_re), p(x_im), rows, inverse, p(tw), p(y_re), p(y_im), stream))
    m = min(rows, 32768)
    for key, fn in calls.items():
        checked(key, fn())
        w_re, w_im = fft4step.fft4096_plain(x_re[:m], x_im[:m], inverse=key[1] == "B7 inverse")
        scale = torch.maximum(w_re.abs().amax(-1), w_im.abs().amax(-1))
        err = torch.maximum((y_re[:m] - w_re).abs().amax(-1), (y_im[:m] - w_im).abs().amax(-1))
        worst = float((err / scale).max())
        print(f"[check {key[0]} {key[1]}] worst row err/max|X| = {worst:.3e} (tolerance 2e-6)")
        if not worst <= 2e-6:
            raise SystemExit(f"{key}: disagrees with the plain version")
        del w_re, w_im
    times = {}
    for key in list(calls) + list(calls)[::-1]:
        times.setdefault(key, []).append(time_ms(calls[key], args.iters))
    z = torch.complex(x_re, x_im)
    fft_ms = time_ms(lambda: torch.fft.fft(z, dim=-1), args.iters)
    del z, x_re, x_im, y_re, y_im
    torch.cuda.empty_cache()

    idx = torch.rand((rows, 2049), generator=gen, device=dev).argsort(dim=-1)[:, :KEEP_K]
    idx = idx.sort(dim=-1).values.to(torch.int16).contiguous()
    rec = torch.randint(0, 256, (rows, KEEP_K), generator=gen, device=dev, dtype=torch.uint8)
    imc = torch.randint(0, 256, (rows, KEEP_K), generator=gen, device=dev, dtype=torch.uint8)
    imc[(idx == 0) | (idx == 2048)] = 0
    hi = torch.rand((rows,), generator=gen, device=dev) * 0.02 + 0.005
    q = fit_quantizer(-hi, hi, RangeQuantConfig(8, 3))
    eps, pc = q.eps.float().contiguous(), q.p_codes.float().contiguous()
    out = torch.empty((rows, 4096), device=dev)
    want = fused_decompress.fused_decompress_plain(rec, imc, idx, eps, pc)
    b3 = {}
    for name in trees:
        lib, tw = libs[name]["fused_decompress.cu"], tables[name]
        b3[(name, "B3")] = (lambda lib=lib, tw=tw: lib.fused_decompress(
            p(rec), p(imc), p(idx), p(eps), p(pc), rows, KEEP_K, ctypes.c_float(8.0), 1, 2,
            p(tw), p(out), stream))
    for key, fn in b3.items():
        checked(key, fn())
        worst = float(((out - want).abs().amax(-1) / want.abs().amax(-1)).max())
        print(f"[check {key[0]} {key[1]}] worst row err/max|x| = {worst:.3e} (tolerance 2e-6)")
        if not worst <= 2e-6:
            raise SystemExit(f"{key}: disagrees with the plain version")
    for key in list(b3) + list(b3)[::-1]:
        times.setdefault(key, []).append(time_ms(b3[key], args.iters))
    spec = torch.complex(torch.randn((rows, 2049), generator=gen, device=dev),
                         torch.randn((rows, 2049), generator=gen, device=dev))
    irfft_ms = time_ms(lambda: torch.fft.irfft(spec, n=4096, dim=-1), args.iters)

    print(f"rows={rows}, mean of {args.iters} launches, in turns (first, second reading):")
    for (name, kernel), (first, second) in times.items():
        print(f"[time {name}] {kernel}: {first:.3f} {second:.3f} ms")
    print(f"[time library] torch.fft.fft (B7's work): {fft_ms:.3f} ms; torch.fft.irfft "
          f"(B3's transform only): {irfft_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
