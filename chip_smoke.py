"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; the last line is printed only on success):

1. the card's name and power limit; build every kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once); B7,
   B3, B2, B4, B1, B5 and B6 must build without spills and within the
   registers of the CTAs per SM that PTXAS_LIMITS names;
2. each kernel (B1..B7) on the card at the main path's shapes -- the rows
   that gemma2_2b at full width and 4 layers gives the 64 MB bucketed
   exchange, the layout's all-zero padding rows among them, for B1 and the
   bisecting B2 also rows holding a NaN or +inf, for B5a rows holding NaN,
   -NaN, +-inf, denormals and the segment bounds -- against its plain
   PyTorch version on the same inputs, with
   its time, the plain version's time, the library yardstick's time where
   one PyTorch call computes the same function, and the bound; B7's inverse
   time beside ``torch.fft.ifft``'s, and for B3, which no single call
   computes, cuFFT's irfft of the same spectrum as a yardstick of its
   transform alone; B4 and B2 also at
   the ``chunk=2048`` route's 442,368 rows of 1025 bins, and B5 at its
   442,368 rows of 384 slots, bitwise; B2 with ``tau=None`` (its own
   bisection, launched once through its API with the counts set to 0) also
   against B1's tau on the same magnitudes, and on rows holding a NaN or
   +inf and on tied, all-zero, all-FLT_MAX rows and rows with fewer than k
   non-NaN values; and B1, B4, B2 (both modes) and B3 at the keep counts a
   theta schedule gives them, k = 1332 (theta 0.35) and k = 2049 (theta 0,
   every bin of a row), beside k = 615, on the main path's rows of its
   spectrum, bitwise (B3 within 2e-6);
3. the engine's cuda and reference backends on a small ragged layout (codes,
   fits and reconstructions agree);
4. the kernel-composed pipeline ``ops.compress_chunks`` ->
   ``decompress_chunks`` (B7, B1, B6, B5) on a gradient the size of
   gemma2_2b at 4 layers, against ``FFTCompressor`` with the same fixed
   quantizer range on the reference backend;
5. the port's training CLI in-process: gemma2_2b full width, 4 layers,
   3 compressed_dp EF steps (sequenced transport, 64 MB buckets,
   backend auto, selector auto), with the kernels' launch counts; one step
   of the same with ``--selector bisect`` (B1's path); 3 steps with
   ``--transport allgather`` (one monolithic payload); 3 steps with
   ``--no-stacked`` (the per-bucket loop);
6. 3 steps each through the Python API (ReducerConfig -> StepConfig ->
   train_loop) on the cuda backend's per-stage routes: ``quantize=False``
   (B6 pack) and ``chunk=2048`` (B5 decode);
7. the dense baseline and the comparison paths through the CLI: 3 steps of
   its defaults (``--mode pjit``: AdamW, no reducer) and 3 of
   ``compressed_dp`` with the ``dense`` reducer, neither launching any of
   the nine kernels; 3 steps over the ``psum`` transport; 4 steps of the
   main path under ``--theta-schedule step`` (theta 0.7, 0.7, 0.0, 0.0),
   launching B4, B2 and B3 at both; 3 steps each of the ``timedomain``
   (sequenced) and ``qsgd`` (psum) reducers, which run no kernel, as in
   the reference;
8. 3 steps each of ``--schedule streamed --stream-groups 6`` over
   ``sequenced`` and ``psum``: B4, B2 and B3 launched 6x as often as in
   ``train`` and ``train-psum``, whose losses and final parameters and
   residual (sha256 digests) they must equal bitwise;
9. ``--schedule auto --calibrate --calibration-path P``, one step, twice:
   the first run fits alpha-beta over a one-rank NCCL group, measures the
   compression throughput through the fused kernels' roundtrip and the
   backward pass and writes P, the second loads P without profiling; both
   print the same decision, ``stacked``;
10. the two-level exchange on a ``--nodes 1`` mesh (one card: a (1, 1)
   ``("node", "local")`` mesh, where no collective moves bytes but the
   whole two-level data flow runs), EF, 64 MB buckets: 3 steps of
   ``--transport hierarchical`` (the dense rfft, the island's mean, one
   irfft, then the node mean compressed), losses within
   ``HIER_LOSS_ATOL`` of ``train-psum``'s (step 0 bitwise); 3 steps of
   ``--transport reduce_scatter``, losses and final parameters and
   residual bitwise ``train-psum``'s (with one worker it runs psum's ops on
   the same shapes); each launching B4 2, B2 2 and B3 1 a step; then one
   step of ``--transport auto --calibrate``: per-axis fits over the
   one-rank ``node`` and ``local`` groups beside the flat ones, and
   ``psum`` for the degenerate topology, unpriced (its calibration's
   roundtrips launch B4, B2, B3 4 more times).  The main path's
   ``StackedPayload`` also goes through ``to_bytes``/``from_bytes`` on the
   card, bitwise.  Runs over several ranks need two or more cards: the CPU
   tests run them over gloo;
11. the resilient loop through the API at 2 layers: 6 steps with
   ``validate="full"``, a poisoned gradient (step 1) and a corrupted
   payload (step 2) skipped, a crash at step 5 rolled back to the step-4
   checkpoint, bitwise an uninterrupted run; then 8 steps with a gradient
   poisoned at every step from 1, where the ladder takes exactly one rung,
   ``kind:fft->dense`` (on the card it never trades the kernels for their
   plain versions).

Every training phase fails on a skipped step or a ladder transition it did
not plan.

Then each training phase's mean steady step (``train-dense`` beside
``train``) and the ops phase's time, one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package.  ``--rows`` and ``--skip-train`` (which skips phases 4 to 6)
shorten a run while a kernel is being brought up; ``--profile`` traces the
first training phase with ``torch.profiler`` and prints device time by
kernel, by op and per step.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, an FMA counted as 2
# compares, adds, counts and multiplies that are not fused issue one per lane
# per clock, at half the FMA-counted rate
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
KEEP_THETA = 0.7
N_LAYERS = 4
BATCH, SEQ = 4, 512
BUCKET_MB = 64
TRAIN_ARGS = ["--arch", "gemma2_2b", "--n-layers", str(N_LAYERS), "--batch", str(BATCH),
              "--seq", str(SEQ), "--mode", "compressed_dp", "--reducer", "fft",
              "--error-feedback", "--backend", "auto", "--selector", "auto"]
SEQUENCED = ["--transport", "sequenced", "--bucket-mb", str(BUCKET_MB)]
# the CLI's defaults (--mode pjit: the dense baseline) at the same model and batch
DENSE_ARGS = TRAIN_ARGS[:8]
PSUM = ["--transport", "psum", "--bucket-mb", str(BUCKET_MB)]
# readiness groups of the streamed phases: 54 buckets in 6 groups of 9
STREAM_GROUPS = 6
# the two-level phases: one card is a (1, 1) mesh
TWO_LEVEL = ["--nodes", "1", "--bucket-mb", str(BUCKET_MB)]
# B4, B2 and B3 launches a step of the main path and of each two-level
# transport: the EF roundtrip and the exchange's compress each launch B4
# and B2, the roundtrip's decompress B3 (the exchange decodes to spectra)
LAUNCHES_PER_STEP = {"sampled_threshold": 2, "fused_compress": 2, "fused_decompress": 1}
# train-hierarchical's losses against train-psum's (the loss is ~12.9): the
# node mean is irfft(rfft(g)), within ~1e-7 relative of g, which moves a few
# kept bins and codes, and AdamW's first step moves every parameter by about
# +-lr whatever its gradient's size, so rounding-level changes to small
# entries move the next losses by ~1e-3 (train-allgather's one quantizer
# fit moves step 1 by 9e-4 against train's; the first chip run of this
# phase read 1.2e-3 at step 1, against a limit of 1e-3 set before it)
HIER_LOSS_ATOL = 5e-3
# one exchange of the main path's gradient size on the (1, 1) mesh:
# hierarchical's mean against psum's, within the reference's envelope
# (tests/test_transports.py), relative L2
HIER_MEAN_REL = 0.05
# the chaos phase's depth: gemma2's local/global pattern is 2 layers long
CHAOS_LAYERS = 2
# the thetas whose keep counts B1, B4, B2 and B3 run at on the main path's
# rows (KEEP_THETA's k = 615 again on the same data, as the yardstick of the
# others' times)
KEEP_COUNT_THETAS = (KEEP_THETA, 0.35, 0.0)
# the kernel-composed pipeline against FFTCompressor: the two differ in the
# forward FFT (B7 against cuFFT, ~1e-6 relative), which moves a few codes
# across a quantizer bin edge and swaps a few bins across the kept-set
# threshold.  The kept set may differ on at most 1% of chunks and the codes
# on at most 0.5% of the other chunks' slots (as tests/test_torch_ops.py
# holds the plain versions to the reference); chunks whose kept set and
# codes agree must reconstruct within the reference pipeline's own 1e-5
# (tests/test_kernels.py), and the whole buffer within relative L2 1e-3.
OPS_RANGE = (-3.0, 3.0)
OPS_MAX_SET_ROWS, OPS_MAX_CODE_SLOTS = 0.01, 0.005
OPS_ROW_ATOL, OPS_MAX_REL_L2 = 1e-5, 1e-3
# No single PyTorch call computes B3's function (library_ms is null); its
# transform alone has one, printed beside it as fft_library_ms
B3_FFT_LIBRARY = "transform only: torch.fft.irfft of the (rows, 2049) spectrum"
# register budgets read off ptxas: per source, (threads per CTA, the fewest
# CTAs an SM's 65,536 registers must hold) for every kernel of the source;
# none may spill
PTXAS_LIMITS = {"fft4096.cu": (256, 3), "fused_decompress.cu": (256, 3),
                "fused_compress.cu": (256, 3), "sampled_threshold.cu": (128, 3),
                "topk_threshold.cu": (128, 3), "pack.cu": (256, 4),
                "range_quant.cu": (256, 3)}
# kernels that state more CTAs per SM than their source's budget, by a
# pattern of their mangled names: B2 up to 2303 columns (J <= 8 items a
# lane), with a tau (Lb0E) and without (Lb1E, its own bisection)
PTXAS_KERNEL_CTAS = {"fused_compress.cu": {r"fused_compress_kernelILi[0-8]E[ht]Lb[01]E": 6}}
# B1's bound prices the passes over the whole row that no design avoids:
# the maximum and count(>= 0), then the sweeps until the bracket's values fit
# the candidate registers (6 on spectrum rows by the numpy walk of
# tests/test_torch_compress_threshold_design.py, which compacts from sweep
# 7.3 on average); the later sweeps touch a handful of candidates a row
B1_ROW_PASSES = 1 + 6
# rows of the kernel phase's data that B1 also runs with a NaN or +inf put in
B1_EDGE_ROWS = 384
# rows of B5a's input given the edge values of b5_edge_values
B5_EDGE_ROWS = 64


# each training phase's mean steady step (ms, steps after the first) and the
# ops phase's compress + decompress (ms), printed together at the end
PHASE_MS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_instr: float, n_flops: float = 0.0):
    """Least time (ms) and what sets it: ``n_bytes`` over the HBM rate, or
    ``n_instr`` unfused fp32/int operations plus ``n_flops`` FMA-countable
    flops over the card's rates for them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_instr / FP32_INSTR_PER_S + n_flops / FP32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b2_bound(rows: int, cols: int, k: int, k_pad: int):
    """B2 with a tau: re, im, the weights, tau and the fit read, 6 bytes a
    slot written; the magnitude and compare a value, the encode a kept one."""
    return bound(rows * cols * 8 + cols * 4 + rows * 16 + rows * k_pad * 6,
                 rows * cols * 6 + 2 * rows * k * 30)


def b2_bisect_bound(rows: int, cols: int, k: int, k_pad: int):
    """B2 with ``tau=None``: as B2, no tau read, its tau written, and B1's
    passes over each row."""
    return bound(rows * cols * 8 + cols * 4 + rows * 12 + rows * k_pad * 6 + rows * 4,
                 rows * cols * (6 + B1_ROW_PASSES) + 2 * rows * k * 30)


def b3_bound(rows: int, k: int, chunk: int = 4096):
    """B3: 4 bytes a kept slot and the fit read, the chunk written; the
    decode a slot and the irfft's flops."""
    return bound(rows * k * 4 + rows * 8 + rows * chunk * 4,
                 rows * 2 * k * 30, rows * 5 * chunk * 12)


def model_config():
    """gemma2_2b at full width, cut to N_LAYERS layers."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config("gemma2_2b"), n_layers=N_LAYERS)


def main_path_layout(chunk: int = 4096):
    """The stacked layout of gemma2_2b, 4 layers, 64 MB buckets, in chunks
    of ``chunk``."""
    from repro_torch.comms.bucketing import build_layout

    return build_layout(model_config().param_count(), int(BUCKET_MB * (1 << 20)), chunk)


def main_path_rows(chunk: int = 4096) -> int:
    """Chunk rows one exchange compresses (221,184 at 4096, 442,368 at 2048)."""
    layout = main_path_layout(chunk)
    return layout.n_buckets * layout.max_chunks


def log_result(r) -> None:
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
    extra = "".join(f" {key}={r[key]:.3f}" for key in ("inverse_ms", "inverse_library_ms",
                                                        "fft_library_ms") if key in r)
    log(f"[{r['kernel'].name}] kernel_ms={r['ms']:.3f} plain_ms={r['plain_ms']:.3f} "
        f"library_ms={lib} bound_ms={r['bound_ms']:.3f} ({r['bound_by']}){extra}")


def check_bitwise(label: str, pairs) -> None:
    """Each (got, want) pair of tensors must be equal; logs the counts."""
    pairs = list(pairs)
    mism = sum(int((a != b).sum()) for a, b in pairs)
    total = sum(a.numel() for a, _ in pairs)
    log(f"[{label}] mismatches={mism} of {total} (tolerance 0: bitwise)")
    if mism:
        raise AssertionError(f"{label} disagrees with its plain version on {mism} values")


def check_ptxas(ptxas) -> None:
    """Every kernel of the sources in PTXAS_LIMITS must not spill and must
    fit its CTAs per SM by registers (allocated in units of 8 a thread): its
    source's, or PTXAS_KERNEL_CTAS's where a pattern names it; read off the
    ptxas output of a fresh build, kernel by kernel."""
    import re

    for source, (threads, min_ctas) in PTXAS_LIMITS.items():
        text = ptxas.get(source)
        if text is None:
            log(f"[ptxas {source}] library reused from an earlier build: not rechecked")
            continue
        stated = PTXAS_KERNEL_CTAS.get(source, {})
        kernels = re.split(r"Compiling entry function '(\S+)'", text)[1:]
        worst, spills, bad = 0, 0, []
        for name, info in zip(kernels[::2], kernels[1::2]):
            regs = int(re.search(r"Used (\d+) registers", info).group(1))
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", info))
            want = max([min_ctas] + [c for pat, c in stated.items() if re.search(pat, name)])
            if spill or 65536 // (threads * (-(-regs // 8) * 8)) < want:
                bad.append(f"{name}: {regs} registers, {spill} spill bytes, {want} CTAs stated")
            worst, spills = max(worst, regs), spills + spill
        ctas = 65536 // (threads * (-(-max(worst, 1) // 8) * 8))
        log(f"[ptxas {source}] {len(kernels) // 2} kernels, at most {worst} registers a thread: "
            f"{ctas} CTAs of {threads} threads per SM; spill bytes {spills} (limits: >= "
            f"{min_ctas} CTAs, {', '.join(f'{c} for {p}' for p, c in stated.items()) or 'no other'}"
            "; 0 spills)")
        if not kernels or bad:
            raise AssertionError(f"{source}: spills or too many registers: {bad}")


def padding_rows(rows: int, dev, chunk: int = 4096) -> torch.Tensor:
    """Indices, below ``rows``, of the all-zero padding rows of the main
    path's stacked layout (the rows ``valid_chunk_mask`` leaves out)."""
    from repro_torch.core.compressor import valid_chunk_mask

    layout = main_path_layout(chunk)
    valid = valid_chunk_mask(layout.sizes(), layout.max_chunks, layout.chunk, dev).reshape(-1)
    return torch.nonzero(~valid[:rows]).reshape(-1)


def spectrum(rows: int, chunk: int, dev, seed: int = 0):
    """B2's and B4's inputs as the main path gives them: the rfft of
    ``rows`` N(0, 1e-6) chunks of ``chunk`` samples, the stacked layout's
    padding rows (B4's denormal bracket, B2's truncation at k_pad) all
    zero.  Returns re, im (rows, chunk/2 + 1), the Hermitian weights, the
    weighted magnitude and the number of zero rows."""
    from repro_torch.core import fft as cfft

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, chunk), generator=gen, device=dev) * 1e-3
    zero_rows = padding_rows(rows, dev, chunk)
    x[zero_rows] = 0.0
    freqs = torch.fft.rfft(x, dim=-1)
    del x
    re, im = freqs.real.contiguous(), freqs.imag.contiguous()
    del freqs
    w = cfft.hermitian_weights(chunk, dev)
    return re, im, w, torch.sqrt(re * re + im * im) * w, zero_rows.numel()


def compress_params(mag, re, im, s_tau):
    """B2's tau and quantizer fits: the engine's mid-gap tau below B4's
    threshold ``s_tau``, and one fit per row (the engine repeats one fit per
    bucket over its rows).  Returns tau (rows, 1), eps, p_codes (rows,)."""
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer

    below = torch.where(mag < s_tau, mag, 0.0).amax(dim=-1, keepdim=True)
    quant = fit_quantizer(torch.minimum(re.amin(dim=-1), im.amin(dim=-1)),
                          torch.maximum(re.amax(dim=-1), im.amax(dim=-1)),
                          RangeQuantConfig(8, 3))
    return 0.5 * (s_tau + below), quant.eps, quant.p_codes


def b5_edge_values(x, eps, rows: int) -> None:
    """The first ``rows`` rows of ``x`` (in place) start with the values the
    encode must get right besides plain ones, at each row's ``eps``: NaN,
    -NaN, +-inf, +-0, denormals, +-1e30, +-eps, +-eps/2 and the segment
    bounds +-eps * 2^q, q < 40."""
    e = eps.reshape(-1)[:rows, None].expand(rows, 1)
    fixed = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
                          1e-40, -1e-40, 1e30, -1e30], device=x.device).expand(rows, -1)
    scales = torch.cat([torch.tensor([1.0, 0.5], device=x.device),
                        2.0 ** torch.arange(1, 40, device=x.device)])
    bounds = e * scales
    vals = torch.cat([fixed, bounds, -bounds], dim=1)[:, : x.shape[1]]
    x[:rows, : vals.shape[1]] = vals


def b5_chunk2048_inputs(dev):
    """B5's input at the ``chunk=2048`` route's shape: 442,368 rows of 384
    slots (k = 308 of 1025 bins kept, the rest zero), N(0, 1e-6), one fit
    per bucket repeated over its 8,192 rows, as the engine's per-stage
    decode gets them.  Returns x, eps, p_codes (rows,)."""
    from repro_torch.core import sparsify
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
    from repro_torch.kernels import ops

    layout = main_path_layout(2048)
    n, per = layout.n_buckets, layout.max_chunks
    k = sparsify.keep_count(1025, KEEP_THETA)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((n * per, ops.pad_k(k)), generator=gen, device=dev) * 1e-3
    x[:, k:] = 0.0
    q = fit_quantizer(x.amin(dim=-1).reshape(n, per).amin(-1),
                      x.amax(dim=-1).reshape(n, per).amax(-1), RangeQuantConfig(8, 3))
    return x, q.eps.repeat_interleave(per), q.p_codes.repeat_interleave(per)


def kernel_phase(rows: int, dev, counted) -> list:
    """Each kernel against its plain version at ``rows`` rows."""
    from repro_torch.core import selection, sparsify
    from repro_torch.kernels import (fused_compress, fused_decompress, sampled_threshold,
                                     topk_threshold)

    chunk, cols = 4096, 2049
    k = sparsify.keep_count(cols, KEEP_THETA)
    re, im, w, mag, n_zero = spectrum(rows, chunk, dev)
    log(f"[kernels] rows={rows}, of which {n_zero} all-zero padding rows")
    results = []

    # B1
    tau_k, cnt_k = topk_threshold.threshold(mag, k=k)
    tau_p, cnt_p = topk_threshold.threshold_plain(mag, k)
    torch.cuda.synchronize()
    mism = int((tau_k != tau_p).sum() + (cnt_k != cnt_p).sum())
    err = float((tau_k - tau_p).abs().max())
    log(f"[B1 topk_threshold] rows={rows} tau/count mismatches={mism} (tolerance 0: bitwise)")
    if mism:
        raise AssertionError(f"B1 disagrees with its plain version on {mism} values")
    # rows holding a NaN, a +inf (the rest scaled up to 1e29, where a finite
    # bracket would not come down to 0) or both: the plain version's
    # bracket is NaN, so tau is 0
    edge = mag[:B1_EDGE_ROWS].clone()
    edge[0::3, 7] = float("nan")
    edge[1::3] *= 1e30
    edge[1::3, cols - 1] = float("inf")
    edge[2::3, 0] = float("inf")
    edge[2::3, cols // 2] = float("nan")
    got = topk_threshold.threshold(edge, k=k)
    check_bitwise(f"B1 topk_threshold, {edge.shape[0]} rows holding a NaN or +inf",
                  ((a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, topk_threshold.threshold_plain(edge, k))))
    del edge, got
    b_ms, b_by = bound(rows * cols * 4 + rows * 8, rows * cols * B1_ROW_PASSES)
    results.append(dict(
        kernel=topk_threshold.KERNEL, max_abs_err=err,
        ms=time_ms(lambda: topk_threshold.threshold(mag, k=k), 5),
        plain_ms=time_ms(lambda: topk_threshold.threshold_plain(mag, k), 2),
        library_ms=time_ms(lambda: torch.topk(mag, k, dim=-1).values[:, -1], 2),
        bound_ms=b_ms, bound_by=b_by))

    # B4
    sample = selection.strided_sample(mag)
    lo, hi = selection.sample_bracket(sample, k, cols)
    s_tau_k, s_cnt_k = sampled_threshold.sampled_threshold(mag, lo, hi, k=k)
    s_tau_p, s_cnt_p = sampled_threshold.sampled_threshold_plain(mag, lo, hi, k=k)
    torch.cuda.synchronize()
    mism = int((s_tau_k != s_tau_p).sum() + (s_cnt_k != s_cnt_p).sum())
    err = float((s_tau_k - s_tau_p).abs().max())
    log(f"[B4 sampled_threshold] rows={rows} tau/count mismatches={mism} "
        f"(tolerance 0: bitwise); rows over k: {int((s_cnt_k > k).sum())}")
    if mism:
        raise AssertionError(f"B4 disagrees with its plain version on {mism} values")
    iters = selection.DEFAULT_REFINE_ITERS
    b_ms, b_by = bound(rows * cols * 4 + rows * 16, rows * cols * (iters + 4))
    results.append(dict(
        kernel=sampled_threshold.KERNEL, max_abs_err=err,
        ms=time_ms(lambda: sampled_threshold.sampled_threshold(mag, lo, hi, k=k), 5),
        plain_ms=time_ms(lambda: sampled_threshold.sampled_threshold_plain(mag, lo, hi, k=k), 2),
        library_ms=time_ms(lambda: torch.topk(mag, k, dim=-1).values[:, -1], 2),
        bound_ms=b_ms, bound_by=b_by))

    # B2: the engine's mid-gap tau, a quantizer fit per row
    tau, eps_rows, p_rows = compress_params(mag, re, im, s_tau_k)
    del mag, tau_p, cnt_p, s_tau_p, s_cnt_p
    out_k = fused_compress.fused_compress(re, im, w, eps_rows, p_rows, tau, k_keep=k)
    out_p = fused_compress.fused_compress_plain(re, im, w, eps_rows, p_rows, tau, k_keep=k)
    torch.cuda.synchronize()
    code_mism = int((out_k[0] != out_p[0]).sum() + (out_k[1] != out_p[1]).sum())
    idx_mism = int((out_k[2] != out_p[2]).sum())
    err = float(max((out_k[0].int() - out_p[0].int()).abs().max(),
                    (out_k[1].int() - out_p[1].int()).abs().max()))
    log(f"[B2 fused_compress] rows={rows} code mismatches={code_mism} of "
        f"{2 * out_k[0].numel()}, index mismatches={idx_mism} (tolerance 0: bitwise)")
    if code_mism or idx_mism:
        raise AssertionError(f"B2 disagrees with its plain version: codes {code_mism}, "
                             f"indices {idx_mism}")
    k_pad = fused_compress.pad_k(k)
    b_ms, b_by = b2_bound(rows, cols, k, k_pad)
    results.append(dict(
        kernel=fused_compress.KERNEL, max_abs_err=err,
        ms=time_ms(lambda: fused_compress.fused_compress(re, im, w, eps_rows, p_rows, tau,
                                                         k_keep=k), 5),
        plain_ms=time_ms(lambda: fused_compress.fused_compress_plain(
            re, im, w, eps_rows, p_rows, tau, k_keep=k), 2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by))
    results.append(bisect_compress(re, im, w, eps_rows, p_rows, k, tau_k, counted))

    # B3 on the payload B2 produced, as the engine slices it; its transform
    # alone is timed as cuFFT's irfft of the (rows, 2049) spectrum
    spec = torch.complex(re, im)
    del re, im
    rec = out_k[0][:, :k].contiguous()
    imc = out_k[1][:, :k].contiguous()
    idx16 = out_k[2][:, :k].to(torch.int16).contiguous()
    del out_k, out_p
    y_k = fused_decompress.fused_decompress(rec, imc, idx16, eps_rows, p_rows)
    y_p = fused_decompress.fused_decompress_plain(rec, imc, idx16, eps_rows, p_rows)
    torch.cuda.synchronize()
    row_err = (y_k - y_p).abs().amax(dim=-1)
    row_max = y_p.abs().amax(dim=-1)
    ratio = float((row_err / torch.clamp_min(row_max, 1e-30)).max())
    err = float(row_err.max())
    log(f"[B3 fused_decompress] rows={rows} max abs err={err:.3e}, worst row "
        f"err/max|x|={ratio:.3e} (tolerance 2e-6)")
    if not ratio <= 2e-6:
        raise AssertionError(f"B3 disagrees with its plain version: {ratio:.3e} > 2e-6")
    del y_k, y_p
    b_ms, b_by = b3_bound(rows, k, chunk)
    results.append(dict(
        kernel=fused_decompress.KERNEL, max_abs_err=err,
        ms=time_ms(lambda: fused_decompress.fused_decompress(rec, imc, idx16, eps_rows,
                                                             p_rows), 5),
        plain_ms=time_ms(lambda: fused_decompress.fused_decompress_plain(
            rec, imc, idx16, eps_rows, p_rows), 2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        fft_library_ms=time_ms(lambda: torch.fft.irfft(spec, n=chunk, dim=-1), 2),
        fft_library_covers=B3_FFT_LIBRARY))
    del spec
    for r in results:
        log_result(r)
    return results


def bisect_compress(re, im, w, eps_rows, p_rows, k: int, tau_b1, counted) -> dict:
    """B2 with ``tau=None``: one call through its API with every count set
    to 0 just before (its launches), then its codes, indices and tau against
    its plain version, bitwise, its tau against B1's (``tau_b1``, on the same
    magnitudes), and the same on two sets of B1_EDGE_ROWS edge rows
    (bisect_edge_rows)."""
    from repro_torch.kernels import fused_compress, topk_threshold

    rows, cols = re.shape
    for kern in counted:
        kern.launches = 0
    got = fused_compress.fused_compress(re, im, w, eps_rows, p_rows, k_keep=k)
    torch.cuda.synchronize()
    launches = fused_compress.BISECT_KERNEL.launches
    others = {kern.name: kern.launches for kern in counted if kern.launches}
    log(f"[B2 fused_compress tau=None] one call through its API: launches={others}")
    if others != {fused_compress.BISECT_KERNEL.name: 1}:
        raise AssertionError(f"fused_compress(tau=None) launched {others}")
    want = fused_compress.fused_compress_plain(re, im, w, eps_rows, p_rows, k_keep=k)
    check_bitwise(f"B2 fused_compress tau=None, {rows} rows", zip(
        (got[0], got[1], got[2], got[3].view(torch.int32)),
        (want[0], want[1], want[2], want[3].view(torch.int32))))
    check_bitwise("B2 fused_compress tau=None: its tau against B1's",
                  [(got[3].view(torch.int32), tau_b1.view(torch.int32))])
    err = float(max((got[0].int() - want[0].int()).abs().max(),
                    (got[1].int() - want[1].int()).abs().max()))
    del got, want
    n = B1_EDGE_ROWS
    for label, (re_e, im_e, w_e) in bisect_edge_rows(re[:n], im[:n], w, k).items():
        mag_e = torch.sqrt(re_e * re_e + im_e * im_e) * w_e
        got = fused_compress.fused_compress(re_e, im_e, w_e, eps_rows[:n], p_rows[:n], k_keep=k)
        want = fused_compress.fused_compress_plain(re_e, im_e, w_e, eps_rows[:n], p_rows[:n],
                                                   k_keep=k)
        check_bitwise(f"B2 fused_compress tau=None, {n} rows {label}", zip(
            (got[0], got[1], got[2], got[3].view(torch.int32)),
            (want[0], want[1], want[2], want[3].view(torch.int32))))
        check_bitwise(f"B2 fused_compress tau=None, {n} rows {label}: its tau against B1's",
                      [(got[3].view(torch.int32),
                        topk_threshold.threshold(mag_e, k=k)[0].view(torch.int32))])
        del got, want, re_e, im_e, mag_e
    k_pad = fused_compress.pad_k(k)
    b_ms, b_by = b2_bisect_bound(rows, cols, k, k_pad)
    return dict(
        kernel=fused_compress.BISECT_KERNEL, max_abs_err=err, launches=launches,
        ms=time_ms(lambda: fused_compress.fused_compress(re, im, w, eps_rows, p_rows, k_keep=k),
                   5),
        plain_ms=time_ms(lambda: fused_compress.fused_compress_plain(re, im, w, eps_rows, p_rows,
                                                                     k_keep=k), 1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def bisect_edge_rows(re, im, w, k: int) -> dict:
    """Two sets of rows for B2's own bisection, from copies of ``re`` and
    ``im``: {label: (re, im, w)}.  "holding a NaN or +inf": a third hold a
    NaN, a third a +inf (the rest of the row scaled by 1e18), a third both;
    their maximum's bracket is NaN.  "tied, zero, FLT_MAX or with fewer than
    k non-NaN": with every weight FLT_MAX, a quarter all tied (re = 0.5:
    FLT_MAX / 2, more ties than B1's 64 candidates), a quarter all zero, a
    quarter all FLT_MAX (re = 1, so lo + hi overflows), a quarter NaN past
    k - 1 columns."""
    rows, cols = re.shape
    re_e, im_e = re.clone(), im.clone()
    re_e[0::3, 7] = float("nan")
    re_e[1::3] *= 1e18
    im_e[1::3] *= 1e18
    re_e[1::3, cols - 1] = float("inf")
    re_e[2::3, 0] = float("inf")
    re_e[2::3, cols // 2] = float("nan")
    re_t, im_t = re.clone(), im.clone()
    q = rows // 4
    for part, value in ((slice(0, q), 0.5), (slice(q, 2 * q), 0.0), (slice(2 * q, 3 * q), 1.0)):
        re_t[part], im_t[part] = value, 0.0
    re_t[3 * q:, k - 1:] = float("nan")
    w_t = torch.full_like(w, torch.finfo(torch.float32).max)
    return {"holding a NaN or +inf": (re_e, im_e, w),
            "tied, zero, FLT_MAX or with fewer than k non-NaN": (re_t, im_t, w_t)}


def keep_count_phase(rows: int, dev) -> None:
    """B1, B4, B2 (with a tau and with ``tau=None``) and B3 at the keep
    counts a theta schedule gives them (KEEP_COUNT_THETAS: k = 615, 1332,
    and 2049 = every bin, k_pad = 2176 slots past the row's 2049 columns),
    on ``rows`` rows of the main path's spectrum, against their plain
    versions: bitwise (B3 within 2e-6 * max|x| per row); with each one's
    time at that k."""
    from repro_torch.core import selection, sparsify
    from repro_torch.kernels import (fused_compress, fused_decompress, sampled_threshold,
                                     topk_threshold)

    cols = 2049
    re, im, w, mag, _ = spectrum(rows, 4096, dev, seed=7)
    for theta in KEEP_COUNT_THETAS:
        k = sparsify.keep_count(cols, theta)
        label = f"theta={theta} k={k} k_pad={fused_compress.pad_k(k)}"
        b1 = topk_threshold.threshold(mag, k=k)
        check_bitwise(f"B1 topk_threshold, {label}", zip(
            (t.view(torch.int32) for t in b1),
            (t.view(torch.int32) for t in topk_threshold.threshold_plain(mag, k))))
        lo, hi = selection.sample_bracket(selection.strided_sample(mag), k, cols)
        s_tau, s_cnt = sampled_threshold.sampled_threshold(mag, lo, hi, k=k)
        check_bitwise(f"B4 sampled_threshold, {label}", zip(
            (s_tau, s_cnt), sampled_threshold.sampled_threshold_plain(mag, lo, hi, k=k)))
        tau, eps, p_codes = compress_params(mag, re, im, s_tau)
        got = fused_compress.fused_compress(re, im, w, eps, p_codes, tau, k_keep=k)
        check_bitwise(f"B2 fused_compress, {label}", zip(
            got[:3], fused_compress.fused_compress_plain(re, im, w, eps, p_codes, tau,
                                                         k_keep=k)[:3]))
        bis = fused_compress.fused_compress(re, im, w, eps, p_codes, k_keep=k)
        want = fused_compress.fused_compress_plain(re, im, w, eps, p_codes, k_keep=k)
        check_bitwise(f"B2 fused_compress tau=None, {label}", zip(
            (bis[0], bis[1], bis[2], bis[3].view(torch.int32)),
            (want[0], want[1], want[2], want[3].view(torch.int32))))
        check_bitwise(f"B2 fused_compress tau=None, {label}: its tau against B1's",
                      [(bis[3].view(torch.int32), b1[0].view(torch.int32))])
        del bis, want
        rec, imc = got[0][:, :k].contiguous(), got[1][:, :k].contiguous()
        idx16 = got[2][:, :k].to(torch.int16).contiguous()
        y_k = fused_decompress.fused_decompress(rec, imc, idx16, eps, p_codes)
        y_p = fused_decompress.fused_decompress_plain(rec, imc, idx16, eps, p_codes)
        ratio = float(((y_k - y_p).abs().amax(dim=-1)
                       / torch.clamp_min(y_p.abs().amax(dim=-1), 1e-30)).max())
        log(f"[B3 fused_decompress, {label}] worst row err/max|x|={ratio:.3e} "
            "(tolerance 2e-6)")
        if not ratio <= 2e-6:
            raise AssertionError(f"B3 disagrees with its plain version at k={k}: {ratio:.3e}")
        del y_k, y_p
        ms = {
            "B1": time_ms(lambda: topk_threshold.threshold(mag, k=k), 5),
            "B4": time_ms(lambda: sampled_threshold.sampled_threshold(mag, lo, hi, k=k), 5),
            "B2": time_ms(lambda: fused_compress.fused_compress(re, im, w, eps, p_codes, tau,
                                                                k_keep=k), 5),
            "B2 tau=None": time_ms(lambda: fused_compress.fused_compress(
                re, im, w, eps, p_codes, k_keep=k), 5),
            "B3": time_ms(lambda: fused_decompress.fused_decompress(rec, imc, idx16, eps,
                                                                    p_codes), 5)}
        k_pad = fused_compress.pad_k(k)
        bounds = {"B2": b2_bound(rows, cols, k, k_pad)[0],
                  "B2 tau=None": b2_bisect_bound(rows, cols, k, k_pad)[0],
                  "B3": b3_bound(rows, k)[0]}
        log(f"[keep count {label}] kernel_ms at {rows} rows: "
            + ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
            + "; bound_ms: " + ", ".join(f"{name} {t:.4f}" for name, t in bounds.items()))
        del got, rec, imc, idx16


def chunk2048_phase(rows: int, dev) -> None:
    """B4 and B2 at the ``chunk=2048`` route's width, 1025 bins (k = 308,
    k_pad = 384), where each runs code of its own (B2's stretches of 128
    columns with column 1024 on warp 7's last lane, B4's instantiation for
    33 values a lane), against their plain versions, bitwise, at that
    route's ``rows`` with its layout's padding rows all zero; then B5a and
    B5b at its 384 slots with one fit per bucket (b5_chunk2048_inputs), edge
    values in B5a's first rows."""
    from repro_torch.core import selection, sparsify
    from repro_torch.kernels import fused_compress, range_quant, sampled_threshold

    chunk = 2048
    cols = chunk // 2 + 1
    k = sparsify.keep_count(cols, KEEP_THETA)
    re, im, w, mag, n_zero = spectrum(rows, chunk, dev, seed=5)
    log(f"[chunk 2048] rows={rows} of {cols} bins, of which {n_zero} all-zero padding "
        f"rows; k={k}")
    lo, hi = selection.sample_bracket(selection.strided_sample(mag), k, cols)
    s_tau, s_cnt = sampled_threshold.sampled_threshold(mag, lo, hi, k=k)
    check_bitwise(f"B4 sampled_threshold, {cols} columns",
                  zip((s_tau, s_cnt), sampled_threshold.sampled_threshold_plain(mag, lo, hi, k=k)))
    b4_ms = time_ms(lambda: sampled_threshold.sampled_threshold(mag, lo, hi, k=k), 5)
    tau, eps, p_codes = compress_params(mag, re, im, s_tau)
    del mag, lo, hi
    got = fused_compress.fused_compress(re, im, w, eps, p_codes, tau, k_keep=k)
    want = fused_compress.fused_compress_plain(re, im, w, eps, p_codes, tau, k_keep=k)
    check_bitwise(f"B2 fused_compress, {cols} columns", zip(got[:3], want[:3]))
    del got, want
    b2_ms = time_ms(lambda: fused_compress.fused_compress(re, im, w, eps, p_codes, tau,
                                                          k_keep=k), 5)
    del re, im, w, tau, eps, p_codes
    x, eps, p_codes = b5_chunk2048_inputs(dev)
    x = x[:rows]
    eps, p_codes = eps[:rows], p_codes[:rows]
    b5_edge_values(x, eps, B5_EDGE_ROWS)
    codes = range_quant.encode(x, eps, p_codes)
    check_bitwise(f"B5a encode, {x.shape[0]} x {x.shape[1]}, {B5_EDGE_ROWS} rows of edge values",
                  [(codes, range_quant.encode_plain(x, eps, p_codes))])
    y = range_quant.decode(codes, eps, p_codes)
    check_bitwise(f"B5b decode, {x.shape[0]} x {x.shape[1]}",
                  [(y.view(torch.int32),
                    range_quant.decode_plain(codes, eps, p_codes).view(torch.int32))])
    b5a_ms = time_ms(lambda: range_quant.encode(x, eps, p_codes), 5)
    b5b_ms = time_ms(lambda: range_quant.decode(codes, eps, p_codes), 5)
    log(f"[chunk 2048] kernel_ms at {cols} columns: B4 {b4_ms:.3f}, B2 {b2_ms:.3f}; at "
        f"{x.shape[1]} slots: B5a {b5a_ms:.3f}, B5b {b5b_ms:.3f}")


def standalone_phase(rows: int, dev) -> list:
    """B6 pack/unpack and B5 encode/decode at ``rows`` rows, as the
    kernel-composed pipeline calls them (k = pad_k(615) = 640 slots,
    unpack width 2560), against their plain versions: bitwise."""
    from repro_torch.core import fft as cfft
    from repro_torch.core import sparsify
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
    from repro_torch.kernels import ops, pack, range_quant, topk_threshold

    chunk, cols = 4096, 2049
    k = sparsify.keep_count(cols, KEEP_THETA)
    k_pad = ops.pad_k(k)
    cols_pad = cols + (-cols) % pack.F_TILE
    gen = torch.Generator(device=dev).manual_seed(3)
    freqs = torch.fft.rfft(torch.randn((rows, chunk), generator=gen, device=dev) * 1e-3, dim=-1)
    re, im = freqs.real.contiguous(), freqs.imag.contiguous()
    del freqs
    mag = torch.sqrt(re * re + im * im) * cfft.hermitian_weights(chunk, dev)
    tau, _ = topk_threshold.threshold(mag, k=k)
    mag[0] = 0.0  # an all-zero row: tau 0 keeps all 2049 columns, cut at k_pad
    tau[0] = 0.0
    tau[1] = 0.0  # a row whose count (2049) exceeds k_pad
    results = []

    # B6a
    vals, idx = pack.pack(mag, tau, k=k_pad)
    check_bitwise("B6a pack", zip((vals, idx), pack.pack_plain(mag, tau, k=k_pad)))
    n_bytes = rows * cols * 4 + rows * 4 + rows * k_pad * 8
    b_ms, b_by = bound(n_bytes, rows * cols * 2)
    results.append(dict(
        kernel=pack.PACK_KERNEL, max_abs_err=0.0,
        ms=time_ms(lambda: pack.pack(mag, tau, k=k_pad), 5),
        plain_ms=time_ms(lambda: pack.pack_plain(mag, tau, k=k_pad), 2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by))
    del mag

    # B6b on the pair B6a produced
    dense = pack.unpack(vals, idx, cols=cols_pad)
    check_bitwise("B6b unpack", [(dense, pack.unpack_plain(vals, idx, cols=cols_pad))])
    del dense
    b_ms, b_by = bound(rows * k_pad * 8 + rows * cols_pad * 4, rows * k_pad)
    # its library yardstick: one scatter_add_ of the k slots into zeros,
    # the int64 index made outside the timed call
    idx64 = idx.long()
    lib = torch.zeros((rows, cols_pad), device=dev).scatter_add_(-1, idx64, vals)
    log(f"[B6b unpack] library scatter_add_ against the kernel: "
        f"{int((lib != pack.unpack(vals, idx, cols=cols_pad)).sum())} values differ")
    del lib
    results.append(dict(
        kernel=pack.UNPACK_KERNEL, max_abs_err=0.0,
        ms=time_ms(lambda: pack.unpack(vals, idx, cols=cols_pad), 5),
        plain_ms=time_ms(lambda: pack.unpack_plain(vals, idx, cols=cols_pad), 2),
        library_ms=time_ms(lambda: torch.zeros((rows, cols_pad), device=dev).scatter_add_(
            -1, idx64, vals), 2),
        bound_ms=b_ms, bound_by=b_by))
    del idx64

    # B5a/B5b on the gathered real parts, one fit per row
    valid = vals != 0
    x = torch.gather(re, -1, idx.long()) * valid
    del re, im, vals, idx, valid
    q = fit_quantizer(x.amin(dim=-1), x.amax(dim=-1), RangeQuantConfig(8, 3))
    edge = x[:B5_EDGE_ROWS].clone()
    b5_edge_values(edge, q.eps, B5_EDGE_ROWS)
    check_bitwise(f"B5a encode, {B5_EDGE_ROWS} rows of edge values", [(
        range_quant.encode(edge, q.eps[:B5_EDGE_ROWS], q.p_codes[:B5_EDGE_ROWS]),
        range_quant.encode_plain(edge, q.eps[:B5_EDGE_ROWS], q.p_codes[:B5_EDGE_ROWS]))])
    nan_row = edge[:1, :16]
    log(f"[B5a encode] NaN and -NaN encode to "
        f"{range_quant.encode(nan_row, q.eps[:1], q.p_codes[:1])[0, :2].tolist()} (kernel), "
        f"{range_quant.encode_plain(nan_row, q.eps[:1], q.p_codes[:1])[0, :2].tolist()} (plain)")
    del edge
    codes = range_quant.encode(x, q.eps, q.p_codes)
    check_bitwise("B5a encode", [(codes, range_quant.encode_plain(x, q.eps, q.p_codes))])
    b_ms, b_by = bound(rows * k_pad * 5 + rows * 12, rows * k_pad * 30)
    results.append(dict(
        kernel=range_quant.ENCODE_KERNEL, max_abs_err=0.0,
        ms=time_ms(lambda: range_quant.encode(x, q.eps, q.p_codes), 5),
        plain_ms=time_ms(lambda: range_quant.encode_plain(x, q.eps, q.p_codes), 2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by))
    y = range_quant.decode(codes, q.eps, q.p_codes)
    check_bitwise("B5b decode", [(y.view(torch.int32),
                                  range_quant.decode_plain(codes, q.eps, q.p_codes).view(
                                      torch.int32))])
    b_ms, b_by = bound(rows * k_pad * 5 + rows * 8, rows * k_pad * 20)
    results.append(dict(
        kernel=range_quant.DECODE_KERNEL, max_abs_err=0.0,
        ms=time_ms(lambda: range_quant.decode(codes, q.eps, q.p_codes), 5),
        plain_ms=time_ms(lambda: range_quant.decode_plain(codes, q.eps, q.p_codes), 2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by))
    for r in results:
        log_result(r)
    return results


def fft_phase(rows: int, dev, stretch: int = 32768) -> dict:
    """B7 forward and inverse at ``rows`` rows against the plain four-step
    version, compared stretch by stretch (``stretch`` rows at a time, every
    row covered; the plain version's intermediates would not fit at once
    beside the rest): max abs error <= 2e-6 * max|X| per row and plane."""
    from repro_torch.kernels import fft4step

    chunk = fft4step.CHUNK
    gen = torch.Generator(device=dev).manual_seed(4)
    x_re = torch.randn((rows, chunk), generator=gen, device=dev) * 1e-2
    x_im = torch.randn((rows, chunk), generator=gen, device=dev) * 1e-2
    errs = {}
    for inverse in (False, True):
        y_re, y_im = fft4step.fft4096(x_re, x_im, inverse=inverse)
        worst, err = 0.0, 0.0
        for lo in range(0, rows, stretch):
            hi = min(rows, lo + stretch)
            w_re, w_im = fft4step.fft4096_plain(x_re[lo:hi], x_im[lo:hi], inverse=inverse)
            scale = torch.maximum(w_re.abs().amax(-1), w_im.abs().amax(-1))
            e = torch.maximum((y_re[lo:hi] - w_re).abs().amax(-1),
                              (y_im[lo:hi] - w_im).abs().amax(-1))
            worst = max(worst, float((e / torch.clamp_min(scale, 1e-30)).max()))
            err = max(err, float(e.max()))
        del y_re, y_im
        name = "inverse" if inverse else "forward"
        log(f"[B7 fft4096 {name}] rows={rows} (plain compared in stretches of {stretch} "
            f"rows) max abs err={err:.3e}, worst row err/max|X|={worst:.3e} "
            "(tolerance 2e-6)")
        if not worst <= 2e-6:
            raise AssertionError(f"B7 {name} disagrees with its plain version: {worst:.3e}")
        errs[name] = err
    inv_ms = time_ms(lambda: fft4step.fft4096(x_re, x_im, inverse=True), 5)
    fwd_ms = time_ms(lambda: fft4step.fft4096(x_re, x_im, inverse=False), 5)
    plain_ms = time_ms(lambda: fft4step.fft4096_plain(x_re, x_im, inverse=False), 2)
    z = torch.complex(x_re, x_im)
    del x_re, x_im
    library_ms = time_ms(lambda: torch.fft.fft(z, dim=-1), 2)
    inv_library_ms = time_ms(lambda: torch.fft.ifft(z, dim=-1), 2)
    log(f"[B7 fft4096] forward {fwd_ms:.3f} ms, inverse {inv_ms:.3f} ms per launch")
    b_ms, b_by = bound(rows * chunk * 16, 0, rows * 5 * chunk * 12)
    r = dict(kernel=fft4step.KERNEL, max_abs_err=max(errs.values()), ms=fwd_ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
             inverse_ms=inv_ms, inverse_library_ms=inv_library_ms)
    log_result(r)
    return r


def engine_phase(dev) -> None:
    """cuda vs reference backend on a small ragged 3-bucket layout."""
    from repro_torch.comms import bucketing
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig

    gen = torch.Generator(device=dev).manual_seed(1)
    n = 5 * 4096 + 1234
    flat = torch.randn((n,), generator=gen, device=dev) * 0.05
    layout = bucketing.build_layout(n, 2 * 4096 * 4)
    stacked = bucketing.stack_buckets(flat, layout)
    out = {}
    for backend in ("reference", "cuda"):
        comp = FFTCompressor(FFTCompressorConfig(backend=backend, selector="sampled"))
        payload = comp.compress_stacked(stacked, layout.sizes())
        out[backend] = (payload, comp.decompress_stacked(payload))
    (p_r, y_r), (p_c, y_c) = out["reference"], out["cuda"]
    same = all(torch.equal(a, b) for a, b in ((p_r.re, p_c.re), (p_r.im, p_c.im),
                                               (p_r.idx, p_c.idx), (p_r.quant.eps, p_c.quant.eps),
                                               (p_r.quant.p_codes, p_c.quant.p_codes)))
    err = float((y_r - y_c).abs().max() / y_r.abs().max())
    log(f"[engine] cuda vs reference: payload bitwise equal={same}, "
        f"roundtrip rel err={err:.3e} (tolerance 2e-6)")
    if not same or not err <= 2e-6:
        raise AssertionError("cuda and reference backends disagree")


def _busy_us(spans, start: float, end: float) -> float:
    """Length of the union of ``spans`` (device intervals, us) inside
    ``[start, end)``."""
    busy, reach = 0.0, start
    for s0, s1 in sorted((max(a, start), min(b, end)) for a, b in spans if a < end and b > start):
        if s1 > reach:
            busy += s1 - max(s0, reach)
            reach = s1
    return busy


def _print_profile(prof, label: str) -> None:
    """Device time by kernel and by the PyTorch op that launched it, and per
    step (the loop's ``train_step`` ranges) the device's busy share of that
    step's own wall time."""
    def dev_us(e):  # the attribute's name before torch 2.4 was self_cuda_time_total
        value = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if value is None else value

    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.events()
    # device work only: kernels and copies, not the device-side copies of
    # record_function ranges
    spans = [(e.time_range.start, e.time_range.end) for e in raw
             if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
             and e.name != "train_step"]
    steps = sorted((e.time_range.start, e.time_range.end) for e in raw
                   if e.name == "train_step" and e.device_type != cuda)
    if not spans or not steps:
        raise AssertionError(f"{label} profile: no device activity or no step ranges traced")
    for i, (t0, t1) in enumerate(steps):
        busy = _busy_us(spans, t0, t1)
        log(f"[{label} profile step {i}] wall {(t1 - t0) / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / (t1 - t0):.1f}%)")
    if len(steps) > 1:
        wall = sum(t1 - t0 for t0, t1 in steps[1:])
        busy = sum(_busy_us(spans, t0, t1) for t0, t1 in steps[1:])
        log(f"[{label} profile steady steps] wall {wall / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / wall:.1f}%)")
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda and e.key != "train_step"]
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and dev_us(e) > 0]
    for kind, rows in (("kernel", kernels), ("op", ops)):
        for e in sorted(rows, key=lambda e: -dev_us(e))[:20]:
            log(f"[{label} profile {kind}] {dev_us(e) / 1e3:9.2f} ms  x{e.count:<5d} "
                f"{e.key[:90]}")


def ops_phase(dev, counted) -> dict:
    """The kernel-composed pipeline on a gradient the size of gemma2_2b at
    4 layers (220,038 chunks of 4096), with the kernels' counts set to 0
    just before; held against FFTCompressor(range_mode="fixed") on the
    reference backend.  Returns each kernel's launches in that run."""
    from repro_torch.core import fft as cfft
    from repro_torch.core import sparsify
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig
    from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
    from repro_torch.kernels import ops

    n = model_config().param_count()
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.randn((n,), generator=gen, device=dev) * 0.05
    x2d, _ = cfft.pad_to_chunks(g, 4096)
    k = sparsify.keep_count(ops.RFFT_BINS, KEEP_THETA)
    q = fit_quantizer(*OPS_RANGE, RangeQuantConfig(8, 3), device=dev)
    for kern in counted:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    re_c, im_c, idx, _ = ops.compress_chunks(x2d, k, q)
    del x2d
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g_hat = ops.decompress_chunks(re_c, im_c, idx, q, n)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {kern.name: kern.launches for kern in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    PHASE_MS["ops"] = 1e3 * (t2 - t0)
    log(f"[ops] {-(-n // 4096)} chunks: compress_chunks {1e3 * (t1 - t0):.1f} ms, "
        f"decompress_chunks {1e3 * (t2 - t1):.1f} ms, peak_memory={peak_gb:.2f} GB "
        f"launches={launches}")
    comp = FFTCompressor(FFTCompressorConfig(theta=KEEP_THETA, range_mode="fixed",
                                             fixed_range=OPS_RANGE))
    payload = comp.compress(g)
    ref = comp.decompress(payload)
    # the reference packs magnitude-descending (sort selector), the pipeline
    # index-ascending: compare kept sets and codes in index order
    ref_idx, order = torch.sort(payload.idx.long(), dim=-1)
    same_set = (ref_idx == idx[:, :k].long()).all(dim=-1)
    code_diff = torch.zeros_like(ref_idx, dtype=torch.bool)
    for ref_c, ops_c in ((payload.re, re_c), (payload.im, im_c)):
        code_diff |= torch.gather(ref_c, -1, order) != ops_c[:, :k]
    del payload, ref_idx, order, re_c, im_c, idx
    set_rows = float(1.0 - same_set.float().mean())
    code_slots = float(code_diff[same_set].float().mean())
    agree = same_set & ~code_diff.any(dim=-1)
    diff = g_hat - ref
    rel = float(diff.norm() / ref.norm())
    row_err = cfft.pad_to_chunks(diff.abs(), 4096)[0].amax(dim=-1)
    agree_err = float(row_err[agree].max())
    log(f"[ops] against FFTCompressor(range_mode='fixed', backend='reference'): kept set "
        f"differs on {100 * set_rows:.4f}% of chunks (tolerance {100 * OPS_MAX_SET_ROWS}%), "
        f"codes on {100 * code_slots:.4f}% of the other chunks' slots (tolerance "
        f"{100 * OPS_MAX_CODE_SLOTS}%); chunks that agree fully "
        f"{100 * float(agree.float().mean()):.3f}%, their max abs err {agree_err:.3e} "
        f"(tolerance {OPS_ROW_ATOL}); rel L2 {rel:.3e} (tolerance {OPS_MAX_REL_L2}), max "
        f"abs {float(row_err.max()):.3e}; reconstruction rel L2 to the gradient "
        f"{float((ref - g).norm() / g.norm()):.4f}")
    if not (set_rows <= OPS_MAX_SET_ROWS and code_slots <= OPS_MAX_CODE_SLOTS
            and agree_err <= OPS_ROW_ATOL and rel <= OPS_MAX_REL_L2):
        raise AssertionError("the kernel-composed pipeline disagrees with FFTCompressor")
    for name in ("fft4096", "topk_threshold", "pack", "range_quant_encode",
                 "range_quant_decode", "unpack"):
        if launches[name] <= 0:
            raise AssertionError(f"the ops pipeline never launched {name}")
    return launches


def api_train(dev, steps: int, n_layers: int = N_LAYERS, loop=None, **reducer_kwargs):
    """Training through the port's Python API, built as the CLI builds it:
    ReducerConfig -> StepConfig -> train_loop (sequenced, 64 MB buckets,
    EF, selector auto); ``loop`` holds more TrainLoopConfig fields."""
    import dataclasses

    from repro_torch.comms.reducers import ReducerConfig
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, init_state, train_loop
    from repro_torch.train.step import StepConfig

    cfg = dataclasses.replace(model_config(), n_layers=n_layers)
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    reducer = ReducerConfig(**{**dict(kind="fft", theta=KEEP_THETA, error_feedback=True,
                                      bucket_bytes=int(BUCKET_MB * (1 << 20)),
                                      transport="sequenced", selector="auto"),
                               **reducer_kwargs})
    opt = OptConfig(kind="adamw", lr=3e-4)
    stream = SyntheticStream(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                             global_batch=BATCH, seed=0), device=dev)
    state = init_state(model, opt, error_feedback=reducer.error_feedback)
    return train_loop(model, opt, StepConfig(mode="compressed_dp", reducer=reducer), state,
                      stream, TrainLoopConfig(total_steps=steps, log_every=1, **(loop or {})))


def state_digests(state) -> dict:
    """sha256 of every final parameter and of the residual, by name (the
    card's state of a 4-layer phase is ~7 GB: digests stand in for a copy)."""
    import hashlib

    tensors = dict(state["model"].leaves())
    if "residual" in state:
        tensors["residual"] = state["residual"]
    return {name: hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy())
            .hexdigest() for name, t in tensors.items()}


# each digest-keeping phase's (losses, state digests), for the phases held
# bitwise against it
DIGESTS = {}


def train_phase(run, counted, label: str, must_launch, profile: bool = False,
                must_not_launch: bool = False, digest: bool = False, skips=(),
                transitions=()):
    """Run one training phase (``run()`` returns the loop's result) with the
    kernels' counts set to 0 just before; checks finite losses, that the
    guard skipped exactly the steps in ``skips`` and the degradation ladder
    took exactly the rungs in ``transitions`` (none unless planned), a
    launch of each kernel in ``must_launch`` and, with ``must_not_launch``,
    no launch of any kernel; with ``digest`` keeps the losses and the final
    state's digests in ``DIGESTS``; returns each kernel's launches in that
    run and the history."""
    import contextlib

    for kern in counted:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                               torch.profiler.ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
    t0 = time.perf_counter()
    with prof:
        result = run()
    wall = time.perf_counter() - t0
    if profile:
        _print_profile(prof, label)
    launches = {kern.name: kern.launches for kern in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    history, health = result["history"], result["health"]
    losses = [row["loss"] for row in history]
    if digest:
        DIGESTS[label] = (losses, state_digests(result["state"]))
    del result
    for row in history:
        log(f"[{label}] step {row['step']}: theta={row['theta']} loss={row['loss']:.4f} "
            f"step_ms={row['dt'] * 1e3:.1f} skipped={row.get('skipped', 0.0)}")
    steady = [row["dt"] * 1e3 for row in history[1:]] or [row["dt"] * 1e3 for row in history]
    PHASE_MS[label] = sum(steady) / max(len(steady), 1)
    log(f"[{label}] wall={wall:.1f}s peak_memory={peak_gb:.2f} GB launches={launches} "
        f"steady step ms={PHASE_MS[label]:.1f} health={health}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if health["skip_steps"] != list(skips):
        raise AssertionError(f"{label}: the guard skipped steps {health['skip_steps']}, "
                             f"planned {list(skips)}")
    rungs = [t["rung"] for t in health["transitions"]]
    if rungs != list(transitions):
        raise AssertionError(f"{label}: the ladder took {rungs}, planned {list(transitions)}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    if must_not_launch and any(launches.values()):
        raise AssertionError(f"{label} launched kernels: {launches}")
    torch.cuda.empty_cache()
    return launches, history


def dense_phases(kernels, fused, main_counts) -> None:
    """Phase 7: the dense baseline (the CLI's defaults, ``--mode pjit``, and
    ``compressed_dp`` with the ``dense`` reducer), neither launching a
    kernel; ``psum``; the main path under ``--theta-schedule step``, whose
    4 steps at theta 0.7, 0.7, 0.0, 0.0 launch B4, B2 and B3 4/3 as often
    as ``train``'s 3 steps (each step launches them; a wrapper on a CUDA
    tensor launches or raises); the ``timedomain`` and ``qsgd`` reducers,
    plain as in the reference."""
    from repro_torch.launch import train as train_cli

    def cli(*args):
        return lambda: train_cli.main(list(args))

    train_phase(cli(*DENSE_ARGS, "--steps", "3"), kernels, "train-dense", (),
                must_not_launch=True)
    train_phase(cli(*DENSE_ARGS, "--mode", "compressed_dp", "--reducer", "dense", "--steps",
                    "3"), kernels, "train-dense-dp", (), must_not_launch=True)
    train_phase(cli(*TRAIN_ARGS, *PSUM, "--steps", "3"), kernels, "train-psum", fused,
                digest=True)
    counts, history = train_phase(
        cli(*TRAIN_ARGS, *SEQUENCED, "--theta-schedule", "step", "--steps", "4"), kernels,
        "train-theta-step", fused)
    thetas = [row["theta"] for row in history]
    if not all(math.isclose(a, b, abs_tol=1e-9) for a, b in zip(thetas, (0.7, 0.7, 0.0, 0.0))):
        raise AssertionError(f"train-theta-step ran at theta {thetas}")
    for name in fused:
        if 3 * counts[name] != 4 * main_counts[name]:
            raise AssertionError(f"train-theta-step launched {name} {counts[name]} times in 4 "
                                 f"steps, train {main_counts[name]} in 3")
    train_phase(cli(*TRAIN_ARGS, "--reducer", "timedomain", *SEQUENCED, "--steps", "3"),
                kernels, "train-timedomain", (), must_not_launch=True)
    train_phase(cli(*TRAIN_ARGS, "--reducer", "qsgd", *PSUM, "--steps", "3"), kernels,
                "train-qsgd", (), must_not_launch=True)


def two_level_phases(kernels, fused) -> None:
    """Phase 10: the two-level exchange on one card's (1, 1) mesh, each
    phase held to B4 2, B2 2 and B3 1 launches a step; ``train-psum``'s
    losses and digests (phase 7) are the yardstick."""
    from repro_torch.launch import train as train_cli

    log("[two-level] one card is a (1, 1) mesh: no collective moves bytes here; runs over "
        "several ranks need two or more cards (the CPU tests run them over 4 gloo workers)")
    psum_losses, psum_digests = DIGESTS["train-psum"]
    for label, transport in (("train-hierarchical", "hierarchical"),
                             ("train-reduce-scatter", "reduce_scatter")):
        counts, _ = train_phase(
            lambda: train_cli.main(TRAIN_ARGS + TWO_LEVEL + ["--transport", transport,
                                                             "--steps", "3"]),
            kernels, label, fused, digest=True)
        if {k: counts[k] for k in LAUNCHES_PER_STEP} != {
                k: 3 * v for k, v in LAUNCHES_PER_STEP.items()}:
            raise AssertionError(f"{label} launched {counts} in 3 steps, not 3 x "
                                 f"{LAUNCHES_PER_STEP}")
        losses, digests = DIGESTS.pop(label)
        if transport == "reduce_scatter":
            differ = sorted(k for k in psum_digests if digests.get(k) != psum_digests[k])
            if losses != psum_losses or differ or set(digests) != set(psum_digests):
                raise AssertionError(f"{label}: losses {losses} / train-psum {psum_losses}, "
                                     f"final state differs in {differ[:5]}")
            log(f"[{label}] losses and {len(digests)} final tensors bitwise train-psum's")
        else:
            gap = max(abs(a - b) for a, b in zip(losses, psum_losses))
            if losses[0] != psum_losses[0] or gap > HIER_LOSS_ATOL:
                raise AssertionError(f"{label}: losses {losses} / train-psum {psum_losses}")
            log(f"[{label}] losses within {gap:.3e} of train-psum's (limit {HIER_LOSS_ATOL})")
    _two_level_mean_check()
    runs = []

    def auto():
        result = train_cli.main(TRAIN_ARGS + TWO_LEVEL + ["--transport", "auto",
                                                          "--calibrate", "--steps", "1"])
        runs.append(result)
        return result

    counts, _ = train_phase(auto, kernels, "train-transport-auto", fused)
    result = runs.pop()
    # the calibration's throughput runs the roundtrip 4 times (warm-up + 3)
    if {k: counts[k] for k in LAUNCHES_PER_STEP} != {
            k: v + 4 for k, v in LAUNCHES_PER_STEP.items()}:
        raise AssertionError(f"train-transport-auto launched {counts}")
    prof = result["calibration"]["profile"]
    axes = sorted((f["family"], f["axis"]) for f in prof["fits"] if f["axis"] is not None)
    if axes != [(f, a) for f in ("gather", "psum") for a in ("local", "node")]:
        raise AssertionError(f"train-transport-auto: per-axis fits {axes}")
    if result["reducer_config"].transport != "psum" or result["transport_decision"] is not None:
        raise AssertionError(f"train-transport-auto resolved "
                             f"{result['reducer_config'].transport} "
                             f"({result['transport_decision']})")
    log(f"[train-transport-auto] key {prof['key']}")
    for fit in prof["fits"]:
        log(f"[train-transport-auto] {fit['family']} over {fit['axis'] or 'flat'}: "
            f"alpha={fit['alpha_s'] * 1e6:.3f} us beta={fit['beta_s_per_byte']:.6e} s/B")
    log("[train-transport-auto] (1, 1) topology -> psum, unpriced")


def _two_level_mean_check() -> None:
    """hierarchical's and psum's means of one exchange of a gradient the
    main path's size (N(0, 0.05^2)) on the (1, 1) mesh, fused kernels."""
    from repro_torch.comms.transport import get_transport
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig
    from repro_torch.launch.mesh import make_two_level_mesh

    layout, mesh = main_path_layout(), make_two_level_mesh(1)
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn((layout.total,), generator=gen, device="cuda") * 0.05
    comp = FFTCompressor(FFTCompressorConfig(theta=KEEP_THETA, backend="cuda",
                                             selector="auto"))
    psum = get_transport("psum").run(g, comp=comp, layout=layout, group=mesh)
    hier = get_transport("hierarchical").run(g, comp=comp, layout=layout, group=mesh)
    rel = float((hier - psum).norm() / psum.norm())
    del g, psum, hier
    torch.cuda.empty_cache()
    if not rel <= HIER_MEAN_REL:
        raise AssertionError(f"hierarchical's mean is {rel:.3e} from psum's (relative L2)")
    log(f"[two-level] hierarchical's mean within {rel:.3e} of psum's (relative L2, limit "
        f"{HIER_MEAN_REL})")


def bytecodec_phase(dev) -> None:
    """The main path's StackedPayload (gemma2_2b, 4 layers, 64 MB buckets,
    the fused kernels) through ``to_bytes`` and ``from_bytes`` on the card:
    every plane bitwise."""
    from repro_torch.comms import bucketing
    from repro_torch.core.compressor import (FFTCompressor, FFTCompressorConfig,
                                             StackedPayload)

    layout = main_path_layout()
    gen = torch.Generator(device=dev).manual_seed(3)
    flat = torch.randn((layout.total,), generator=gen, device=dev) * 0.05
    comp = FFTCompressor(FFTCompressorConfig(theta=KEEP_THETA, backend="cuda",
                                             selector="auto"))
    payload = comp.compress_stacked(bucketing.stack_buckets(flat, layout), layout.sizes())
    del flat
    t0 = time.perf_counter()
    blob = payload.to_bytes()
    t1 = time.perf_counter()
    back = StackedPayload.from_bytes(blob, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    planes = [(name, getattr(payload, name), getattr(back, name)) for name in ("re", "im", "idx")]
    planes += [(f"quant.{leaf}", getattr(payload.quant, leaf), getattr(back.quant, leaf))
               for leaf in ("eps", "p_codes", "vmax", "vmin")]
    for name, a, b in planes:
        if b.device != a.device or b.dtype != a.dtype or not torch.equal(a.reshape(b.shape), b):
            raise AssertionError(f"bytecodec: plane {name} differs after the round trip")
    if back.sizes != payload.sizes or back.chunk != payload.chunk:
        raise AssertionError("bytecodec: the payload's static fields differ")
    log(f"[bytecodec] {layout.n_buckets} buckets x {payload.re.shape[1]} chunks x "
        f"{payload.re.shape[2]} slots: blob {len(blob)} bytes, to_bytes "
        f"{1e3 * (t1 - t0):.1f} ms, from_bytes {1e3 * (t2 - t1):.1f} ms, planes bitwise")


def streamed_phases(kernels, fused, main_counts) -> None:
    """Phase 8: ``--schedule streamed --stream-groups 6`` over ``sequenced``
    and ``psum``: 54 buckets in 6 groups of 9, each group's compress,
    exchange and EF roundtrip on its own, so B4, B2 and B3 launch 6x as
    often as in the stacked ``train`` (and ``train-psum``), with losses and
    final parameters and residual bitwise theirs."""
    from repro_torch.launch import train as train_cli

    for label, base, transport in (("train-streamed", "train", SEQUENCED),
                                   ("train-streamed-psum", "train-psum", PSUM)):
        counts, _ = train_phase(
            lambda: train_cli.main(TRAIN_ARGS + transport + [
                "--schedule", "streamed", "--stream-groups", str(STREAM_GROUPS),
                "--steps", "3"]), kernels, label, fused, digest=True)
        for name in fused:
            if counts[name] != STREAM_GROUPS * main_counts[name]:
                raise AssertionError(f"{label} launched {name} {counts[name]} times, "
                                     f"{STREAM_GROUPS} x train's {main_counts[name]}")
        (losses, digests), (base_losses, base_digests) = DIGESTS.pop(label), DIGESTS.pop(base)
        if losses != base_losses:
            raise AssertionError(f"{label} losses {losses} != {base}'s {base_losses}")
        differ = sorted(k for k in base_digests if digests.get(k) != base_digests[k])
        if differ or set(digests) != set(base_digests):
            raise AssertionError(f"{label}: final state differs from {base}'s in {differ[:5]}")
        log(f"[{label}] losses and {len(digests)} final tensors bitwise {base}'s")


def auto_phase(kernels, fused) -> None:
    """Phase 9: ``--schedule auto --calibrate --calibration-path P``, one
    step: the pass fits alpha-beta over a one-rank NCCL group (its launch
    cost: one rank has no link), measures the compression throughput through
    the exchange's own roundtrip (the fused kernels) and the model's backward
    pass and writes P; the policy decides from them, and must pick
    ``stacked``: the streamed step here has no overlap with the backward
    pass, so it costs a launch per group more.  A second run with the same
    flags loads P and does not profile again."""
    import tempfile

    from repro_torch.launch import train as train_cli

    tmp = tempfile.mkdtemp(prefix="chip-smoke-calibration-")
    path = os.path.join(tmp, "h100.calibration.json")
    args = TRAIN_ARGS + SEQUENCED + ["--schedule", "auto", "--calibrate",
                                     "--calibration-path", path, "--steps", "1"]
    runs = []
    try:
        def run():
            result = train_cli.main(list(args))
            runs.append((result["calibration"], result["schedule_decision"]))
            return result

        for label in ("train-auto", "train-auto-reload"):
            train_phase(run, kernels, label, ())
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    (first, decision), (second, decision2) = runs
    if not first["profiled"] or second["profiled"]:
        raise AssertionError(f"train-auto profiled {first['profiled']}, "
                             f"the reload {second['profiled']}")
    if decision is None or decision2 is None or decision2 != decision:
        raise AssertionError(f"train-auto decisions {decision} / {decision2}")
    if decision.schedule != "stacked":
        raise AssertionError(f"train-auto chose {decision.schedule}: with no overlap the "
                             f"streamed step cannot be faster ({decision.to_dict()})")
    if second["profile"] != first["profile"]:
        raise AssertionError("the reloaded calibration differs from the one written")
    prof = first["profile"]
    log(f"[train-auto] key {prof['key']}")
    for fit in prof["fits"]:
        log(f"[train-auto] {fit['family']}: alpha={fit['alpha_s'] * 1e6:.3f} us "
            f"beta={fit['beta_s_per_byte']:.6e} s/B (1/beta {fit['t_comm_bytes_per_s']:.6e} B/s, "
            f"{fit['n_points']} points)")
    log(f"[train-auto] throughputs (B/s) {prof['throughputs']}")
    log(f"[train-auto] backprop {prof['backprop_flops_per_s']:.6e} FLOP/s")
    log(f"[train-auto] decision {decision.to_dict()}")


def chaos_phase(dev, kernels, fused) -> None:
    """Phase 11: the resilient loop through the API at full width, 2 layers
    (one of gemma2's local/global pairs), ``validate="full"``, sequenced,
    stacked, EF.  (a) 6 steps with checkpoints every 4 (keep 1, ~12 GB on
    the host) of a plan with
    ``nan_grad`` at step 1 and ``payload_corrupt`` (values) at step 2 on
    worker 0, both skipped, and a ``step_crash`` at 5: the loop rolls back
    to the step-4 checkpoint and runs 4 and 5 again; its final parameters
    and residual are bitwise those of the same plan without the crash.
    (b) No checkpoint, 8 steps with ``nan_grad`` at every step from 1: after
    3 skips in a row the ladder takes ``kind:fft->dense`` (which drops the
    residual) and no other rung: on the card it has no ``backend`` rung."""
    import shutil
    import tempfile

    from repro_torch.comms import faults

    clean = (faults.NanGrad(1, 0), faults.PayloadCorrupt(2, 0, "values"))
    crash = faults.FaultPlan(clean + (faults.StepCrash(5),))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        _, history = train_phase(
            lambda: api_train(dev, 6, n_layers=CHAOS_LAYERS, backend="auto", validate="full",
                              faults=crash,
                              loop=dict(faults=crash, ckpt_dir=tmp, ckpt_every=4, ckpt_keep=1)),
            kernels, "train-chaos", fused, digest=True, skips=(1, 2))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if [row["step"] for row in history] != [0, 1, 2, 3, 4, 4, 5]:
        raise AssertionError(f"train-chaos ran steps {[row['step'] for row in history]}")
    plan = faults.FaultPlan(clean)
    train_phase(lambda: api_train(dev, 6, n_layers=CHAOS_LAYERS, backend="auto",
                                  validate="full", faults=plan, loop=dict(faults=plan)),
                kernels, "train-chaos-uninterrupted", fused, digest=True, skips=(1, 2))
    (_, digests), (_, clean_digests) = (DIGESTS.pop("train-chaos"),
                                        DIGESTS.pop("train-chaos-uninterrupted"))
    if digests != clean_digests:
        differ = sorted(k for k in clean_digests if digests.get(k) != clean_digests[k])
        raise AssertionError(f"train-chaos: rollback's final state differs in {differ[:5]}")
    log(f"[train-chaos] rolled back to step 4; {len(digests)} final tensors bitwise "
        f"the uninterrupted run's")
    nan = faults.FaultPlan(tuple(faults.NanGrad(s, 0) for s in range(1, 8)))
    train_phase(lambda: api_train(dev, 8, n_layers=CHAOS_LAYERS, backend="auto",
                                  validate="full", faults=nan, loop=dict(faults=nan)),
                kernels, "train-chaos-ladder", fused, skips=tuple(range(1, 8)),
                transitions=("kind:fft->dense",))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=None,
                    help="kernel-phase rows (default: the main path's)")
    ap.add_argument("--skip-train", action="store_true",
                    help="skip the ops and training phases")
    ap.add_argument("--profile", action="store_true",
                    help="trace the first training phase with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import all_kernels, build
    from repro_torch.launch import train as train_cli

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = all_kernels()
    sources = sorted({k.source for k in kernels})
    t0 = time.perf_counter()
    ptxas = {}
    build.build(sources, log=ptxas)
    log(f"[build] {len(kernels)} kernels from {len(sources)} sources in "
        f"{time.perf_counter() - t0:.1f}s")
    for source, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {source}] {line.strip()}")
    check_ptxas(ptxas)

    rows = args.rows or main_path_rows()
    results = kernel_phase(rows, dev, kernels)
    torch.cuda.empty_cache()
    keep_count_phase(rows, dev)
    torch.cuda.empty_cache()
    chunk2048_phase(args.rows or main_path_rows(2048), dev)
    torch.cuda.empty_cache()
    results += standalone_phase(rows, dev)
    torch.cuda.empty_cache()
    results.append(fft_phase(rows, dev))
    torch.cuda.empty_cache()
    engine_phase(dev)

    launches = {k.name: None for k in kernels}
    launches.update({r["kernel"].name: r["launches"] for r in results if "launches" in r})
    if not args.skip_train:
        ops_counts = ops_phase(dev, kernels)
        for name in ("fft4096", "pack", "unpack", "range_quant_encode", "range_quant_decode"):
            launches[name] = ops_counts[name]
        torch.cuda.empty_cache()

        def cli(*extra):
            return lambda: train_cli.main(TRAIN_ARGS + list(extra))

        fused = ("fused_compress", "fused_decompress", "sampled_threshold")
        main_counts, _ = train_phase(cli(*SEQUENCED, "--steps", "3"), kernels, "train", fused,
                                     profile=args.profile, digest=True)
        for name in fused:
            launches[name] = main_counts[name]
        bisect_counts, _ = train_phase(cli(*SEQUENCED, "--selector", "bisect", "--steps", "1"),
                                       kernels, "train-bisect", ("topk_threshold",))
        launches["topk_threshold"] = bisect_counts["topk_threshold"]
        train_phase(cli("--transport", "allgather", "--steps", "3"), kernels,
                    "train-allgather", fused)
        train_phase(cli(*SEQUENCED, "--no-stacked", "--steps", "3"), kernels,
                    "train-no-stacked", fused)
        train_phase(lambda: api_train(dev, 3, backend="cuda", quantize=False), kernels,
                    "train-api-unquantized", ("pack",))
        train_phase(lambda: api_train(dev, 3, backend="cuda", chunk=2048), kernels,
                    "train-api-chunk2048", ("fused_compress", "range_quant_decode"))
        dense_phases(kernels, fused, main_counts)
        two_level_phases(kernels, fused)
        streamed_phases(kernels, fused, main_counts)
        auto_phase(kernels, fused)
        chaos_phase(dev, kernels, fused)
        torch.cuda.empty_cache()
        bytecodec_phase(dev)

    if PHASE_MS:
        order = [k for k in ("train", "train-dense") if k in PHASE_MS]
        order += [k for k in PHASE_MS if k not in order]
        log("[phase ms] " + ", ".join(f"{k}={PHASE_MS[k]:.1f}" for k in order))
    line = {"kernels": []}
    for r in results:
        kern = r["kernel"]
        line["kernels"].append({
            "name": kern.name, "route": "cuda", "source": kern.source_path,
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{key: r[key] for key in ("inverse_ms", "inverse_library_ms", "fft_library_ms",
                                       "fft_library_covers") if key in r}})
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
