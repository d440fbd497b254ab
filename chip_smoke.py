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
   plain versions);
12. serving at gemma2_2b's full width and full depth (26 layers, ~2.61 B
   parameters), through ``launch.serve``: ``serve``, batch 8 x prompt 512
   + 32 greedy tokens, and ``serve-long``, batch 2 x prompt 4608 + 64,
   past the 4096 window, so the 13 local layers' caches are rings; each
   prints prefill ms, decode ms a step, tokens/s and the peak, gives equal
   tokens on a second run, and holds ``decode_step``'s logits along the
   generated tokens to one ``forward`` over them (``SERVE_LOGITS_REL``);
13. ``train-publish``: the ``train`` phase's flags for 5 steps with
   ``--publish-dir`` (a theta-0 delta every step, a snapshot every 2, 2
   buffered): B4 and B2 launch once a publish beside the step's own; then,
   the trainer freed, ``serve-follow``: ``launch.serve --follow`` loads the
   v4 snapshot and folds v5, and its weights must be bitwise the
   publisher's mirror and within ``STALENESS`` of the last delta from the
   trainer's; bytes a delta against ``publish_wire_account``, write and
   sync times and the disk's usage are printed, and the ring deleted;
14. ``serve-publish-api``: the catch-up ladder through the API at 4 layers,
   a dense trainer publishing at theta 0.7: a subscriber syncs once over
   3 deltas with a local rebase and one decompress, and once after the
   ring wrapped past it (the snapshot, then a delta), bitwise the mirror
   each time; B4 and B2 launch once a publish and nothing else launches;
15. ``theory``: one backward pass of gemma2_2b (full width, 4 layers) for a
   live gradient, through the cuda backend's stacked compress and
   decompress (B4, B2, B3) at theta 0.7 and 0.9: Assumption 3.1's ratios
   held to the lab evaluator's bound; then Algorithm 1's quantizer fit
   (``method="heuristic"``) beside the closed form (``"solve"``) on each of
   the 54 buckets' kept coefficients, with eps, P and each fit's relative
   L2 error through the plain encode and decode;
16. ``lab``: the convergence lab's smoke matrix at one worker, in process
   (24 rows of 50 steps: the tiny LM and the convnet, dense, theta 0.7 and
   0.9, mixed, every transport, the ``cuda`` backend, the sampled
   selector, stacked and streamed dispatch), each row's final loss, steps
   a second and kernel launches (B1, B2 and B3 in each ``_cuda`` row, none
   in any other), then the lab's 20 claims, whose verdicts must be
   ``LAB_VERDICTS``;
17. the model zoo's training at full width, under each config's
   ``remat="full"`` (every group of the stack, and each encoder layer,
   checkpointed): ``train-hymba`` (hymba_1_5b, all 32 layers),
   ``train-xlstm`` (xlstm_1_3b, one group: 7 mLSTM and 1 sLSTM layers) and
   ``train-seamless`` (seamless_m4t_large_v2, ``SEAMLESS_LAYERS`` decoder
   and as many encoder layers, 512 audio frames a row), each the ``train``
   phase's flags for 3 steps, launching B4, B2 and B3 2, 2 and 1 times a
   step, the losses finite, then the same 3 steps on the dense baseline
   (``-dense``, no kernel): step 0's batch's loss lower after the 3 steps
   on both, the compressed drop at least ``ZOO_DROP_RATIO`` of the dense
   one; ``train-moe``: mixtral_8x22b at one layer, 2 steps of the dense
   baseline at batch 2 x 256 (a full-width MoE backward pass; compression
   at this size does not fit the card), a finite loss and aux, no kernel;
   ``train-vision``: llama3_2_vision_11b at one group (4 self-attention
   layers and the cross layer), 2 dense steps at batch 2 x 256 over 1601
   patches a row: step 0's ``cross.*`` gradients exactly zero (its gate
   starts at zero) and the gate's not, step 1's ``cross.*`` gradients
   non-zero, no kernel;
18. ``serve-hymba``, ``serve-xlstm``, ``serve-seamless`` and
   ``serve-vision``: phase 12 at hymba's 32, xlstm's 48, seamless's 24 +
   24 and llama-vision's 40 layers, batch 8 x prompt 512 + 32 (seamless
   over the prompt's 512 audio frames, vision over 1601 patches), every
   cache leaf after the prefill of the reference's shape
   (``SERVE_CACHE_SHAPES``; the cross caches as long as the memory), each
   recurrent layer's decode path held to its full path, and decode held to
   ``forward`` within ``SERVE_LOGITS_REL`` end to end (xlstm's printed at
   48 layers and at one group, and held at one group and the width the
   reference was read at: ``XLSTM_GROUP``; llama-vision's also printed
   with the model computing in f32);
19. ``zoo``: internlm2_20b, phi3_medium_14b, qwen1_5_110b (QKV bias),
   mixtral_8x22b and qwen3_moe_235b_a22b at full width and one group, each
   built on the card, prefilling batch 2 x 256 and decoding 8 tokens, decode
   held to ``forward`` (for the MoE archs, at the configured capacity and
   at one that drops nothing, on the positions whose experts agree on both
   sides, at least half of those not dropped; the flipped and dropped ones
   counted, a flip only at a near-tie of the router: ``FLIP_MARGIN``),
   with its parameters, prefill and decode ms and peak;
20. ``train-tp-kinds`` (``TP_CASES``): tensor parallelism for the layer
   kinds beyond the dense ones, over two processes on the one card in a gloo group
   (NCCL refuses two ranks on one device) forming a ``(1, 2)`` ``("data",
   "model")`` mesh: one full-width layer or group each of qwen3-moe
   (expert-parallel), mixtral (ff-parallel), hymba, xlstm, seamless (with
   an encoder layer) and llama-vision (its cross layer), each rank holding
   its model-local blocks, the loss and every gradient block held against
   the unsplit model on rank 0 (xlstm also in f32), their times and peaks
   printed; the split times are gloo's host round trips, not NCCL's;
21. ``publish-sharded``: the sharded (FSDP, ``DTensor``) state of a one-card
   ``(1, 1)`` ``("data", "model")`` mesh trains 3 dense steps with the
   CLI's publisher, each leaf gathered whole for the ring's snapshot and
   every delta, B4 and B2 once a publish; then ``publish-replicated``, the
   same on the replicated state: the two rings bitwise, and a subscriber
   that follows the sharded ring bitwise its publisher's mirror;
22. ``train-sp``: the stream between groups sequence-parallel over the
   ``model`` axis, gemma2_2b at full width and depth under ``remat="full"``,
   batch 2 x 4096, over two processes on the one card in a gloo group:
   each rank's checkpointed stream bytes halved (counted by a
   ``saved_tensors_hooks`` pack hook), its loss and gradients bitwise
   those of the stream kept replicated, and the split held against the
   unsplit model on rank 0 (in bf16, and in f32 by accuracy).

23. ``dryrun-vs-card``: the dry-run (``launch/dryrun.py``) traces
   ``train-dense``'s and ``train``'s configurations (gemma2_2b, 4 layers,
   4 x 512, one process) on fake cuda tensors, and the same steps run on
   the card under the same counters: the matmul flops and the kernels'
   custom-op calls (B4 2, B2 2, B3 1 in ``train``) against the launches,
   exactly, and the traced peak within ``DRYRUN_PEAK_REL`` of the
   allocator's since a reset, the roofline's step time beside the
   measured one;
24. ``dryrun-production``: ``DRYRUN_CELLS`` (gemma2_2b ``train_4k``,
   ``prefill_32k`` and ``decode_32k`` on ``(16, 16)``, ``train_4k
   --multi-pod --mode hierarchical``, qwen1_5_110b and qwen3_moe_235b_a22b
   ``train_4k``) traced on
   the production meshes' fake worlds, in a process started before the
   training phases and read here: each ``ok``, with its memory a rank
   against the card's, its collectives and roofline;
25. ``serve-sharded``: two gloo processes on the one card, a ``(1, 2)``
   ``("data", "model")`` mesh (``SERVE_SHARDED_CASES``: gemma2_2b at 26
   layers, batch 8 x 512 + 32 and batch 1 x 512 + 16; one hymba layer at
   batch 8 and one xlstm group at batch 2, x 512 + 32, full width): the
   sharded engine's greedy tokens and logits, against the unsplit model on
   rank 0 along the same tokens, in f32 within ``SERVE_SHARDED_ATOL`` and
   in bf16 held by accuracy against the f32 logits; the cache bytes a rank
   printed.

Phase 10 also runs ``train-psum-noderound``: ``train-psum`` with its
exchange fed the island mean's irfft(rfft(g)), as ``train-hierarchical``
feeds its own; its losses must be bitwise ``train-hierarchical``'s, which
pins what moves those off ``train-psum``'s (``HIER_LOSS_ATOL``).

Every training phase fails on a skipped step or a ladder transition it did
not plan.

Then each training phase's mean steady step (``train-dense`` beside
``train``) and the ops phase's time, one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package.  ``--rows`` and ``--skip-train`` (which skips phases 4 to 6)
shorten a run while a kernel is being brought up; ``--only
theory,lab,zoo,tp,publish,sp,dry,serve`` runs only the named phases after
the kernel phases (``zoo``: phases 17-19; ``tp``: phase 20; ``publish``:
21; ``sp``: 22; ``dry``: 23-24; ``serve``: 25); ``--profile`` traces the
first training phase with ``torch.profiler`` and prints device time by
kernel, by op and per step.
"""

from __future__ import annotations

import argparse
import contextlib
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
# phase read 1.2e-3 at step 1, against a limit of 1e-3 set before it;
# train-psum-noderound, psum fed the same irfft(rfft(g)), gives
# train-hierarchical's losses bitwise, which confirms the cause)
HIER_LOSS_ATOL = 5e-3
# one exchange of the main path's gradient size on the (1, 1) mesh:
# hierarchical's mean against psum's, within the reference's envelope
# (tests/test_transports.py), relative L2
HIER_MEAN_REL = 0.05
# the lab's 20 claims and their verdicts at one worker.  The reference's
# smoke matrix at one worker on the CPU (python -m repro.lab.run --smoke
# --workers 1) passed 18 and failed the convnet's theta0.7_matches_dense
# (+140.29% against dense) and mixed_recovers (+56.49%); it passes all 20
# at 8 workers, where the mean of 8 compressions averages their error out.
# The port's own one-worker CPU run (python -m repro_torch.lab.run --smoke
# --workers 1 --device cpu) gives the same verdicts.
LAB_CLAIMS = ("theta0.7_matches_dense", "theta0.9_degrades", "mixed_recovers",
              "transports_identical", "hierarchical_matches_flat", "backends_identical",
              "sampled_selector_matches_sort", "streamed_identical", "assumption31",
              "thm34_envelope")
LAB_FAILS_AT_ONE_WORKER = ("convnet:theta0.7_matches_dense", "convnet:mixed_recovers")
LAB_VERDICTS = {f"{m}:{c}": f"{m}:{c}" not in LAB_FAILS_AT_ONE_WORKER
                for m in ("convnet", "lm") for c in LAB_CLAIMS}
# the kernels each _cuda row of the lab must launch: B1 and B2 in the
# compress (the sort selector), B3 in the probe's decompress
LAB_CUDA_KERNELS = ("topk_threshold", "fused_compress", "fused_decompress")
# the thetas of the theory phase, and the lab evaluator's Assumption 3.1
# bound for a quantized run (err <= 1.05 sqrt(theta) + 0.15, norm <= 1.08)
THEORY_THETAS = (KEEP_THETA, 0.9)
A31_SQRT_SLACK, A31_QUANT_MARGIN, A31_NORM_TOL = 1.05, 0.15, 0.08
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
# the phi3m-l3 cells' chunk rows, where B4 is timed besides the main path's
B4_CELL_ROWS = 329_929
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


def b4_bound(rows: int, cols: int):
    """B4: the magnitudes read once, 12 bytes a row written; the clamp, the
    refine sweeps and the mid-gap a value (the sample's sweeps touch one
    value a lane)."""
    from repro_torch.core import selection

    return bound(rows * cols * 4 + rows * 12,
                 rows * cols * (selection.DEFAULT_REFINE_ITERS + 5))


def b4_cell_rows(dev, k: int) -> None:
    """B4 at the phi3m-l3 cells' 329,929 rows (its 1,146-row stacked
    padding zero), against its plain chain, bitwise: the kernel's ms, its
    bound, the plain chain's ms, and the eager ops B4 took in, as the
    engine ran them around the refinement before (the sample's bracket,
    the mid-gap)."""
    from repro_torch.core import selection
    from repro_torch.kernels import sampled_threshold

    rows, cols = B4_CELL_ROWS, 2049
    *_, mag, n_zero = spectrum(rows, 4096, dev, seed=11)
    got = sampled_threshold.sampled_select(mag, k=k)
    check_bitwise(f"B4 sampled_threshold, {rows} rows ({n_zero} zero)",
                  zip((t.view(torch.int32) for t in got),
                      (t.view(torch.int32) for t in
                       sampled_threshold.sampled_select_plain(mag, k=k))))
    tau_k = got[0]
    ms = time_ms(lambda: sampled_threshold.sampled_select(mag, k=k), 5)
    b_ms, b_by = b4_bound(rows, cols)
    plain_ms = time_ms(lambda: sampled_threshold.sampled_select_plain(mag, k=k), 2)
    bracket_ms = time_ms(lambda: selection.sample_bracket(selection.strided_sample(mag), k,
                                                          cols), 2)
    mid_gap_ms = time_ms(lambda: selection.mid_gap(mag, tau_k), 2)
    log(f"[B4 at {rows} rows] kernel_ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"plain_chain_ms={plain_ms:.4f}; the eager ops it took in: "
        f"sample_bracket_ms={bracket_ms:.4f} mid_gap_ms={mid_gap_ms:.4f}")


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
    from repro_torch.core import sparsify
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

    # B4: the sample's bracket, the refinement and the mid-gap in one launch
    s_tau_k, s_cnt_k, s_mid_k = sampled_threshold.sampled_select(mag, k=k)
    s_tau_p, s_cnt_p, s_mid_p = sampled_threshold.sampled_select_plain(mag, k=k)
    torch.cuda.synchronize()
    mism = int((s_tau_k.view(torch.int32) != s_tau_p.view(torch.int32)).sum()
               + (s_cnt_k != s_cnt_p).sum()
               + (s_mid_k.view(torch.int32) != s_mid_p.view(torch.int32)).sum())
    err = float((s_tau_k - s_tau_p).abs().max())
    log(f"[B4 sampled_threshold] rows={rows} tau_k/count/tau mismatches={mism} "
        f"(tolerance 0: bitwise); rows over k: {int((s_cnt_k > k).sum())}")
    if mism:
        raise AssertionError(f"B4 disagrees with its plain chain on {mism} values")
    del s_mid_k, s_mid_p
    b_ms, b_by = b4_bound(rows, cols)
    results.append(dict(
        kernel=sampled_threshold.KERNEL, max_abs_err=err,
        ms=time_ms(lambda: sampled_threshold.sampled_select(mag, k=k), 5),
        plain_ms=time_ms(lambda: sampled_threshold.sampled_select_plain(mag, k=k), 2),
        library_ms=time_ms(lambda: torch.topk(mag, k, dim=-1).values[:, -1], 2),
        bound_ms=b_ms, bound_by=b_by))
    b4_cell_rows(dev, k)

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
    from repro_torch.core import sparsify
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
        b4 = sampled_threshold.sampled_select(mag, k=k)
        check_bitwise(f"B4 sampled_threshold, {label}", zip(
            (t.view(torch.int32) for t in b4),
            (t.view(torch.int32) for t in sampled_threshold.sampled_select_plain(mag, k=k))))
        tau, eps, p_codes = compress_params(mag, re, im, b4[0])
        check_bitwise(f"B4's mid-gap tau, {label}, against the engine's expression",
                      [(b4[2].view(torch.int32), tau.view(torch.int32))])
        del b4
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
            "B4": time_ms(lambda: sampled_threshold.sampled_select(mag, k=k), 5),
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
    from repro_torch.core import sparsify
    from repro_torch.kernels import fused_compress, range_quant, sampled_threshold

    chunk = 2048
    cols = chunk // 2 + 1
    k = sparsify.keep_count(cols, KEEP_THETA)
    re, im, w, mag, n_zero = spectrum(rows, chunk, dev, seed=5)
    log(f"[chunk 2048] rows={rows} of {cols} bins, of which {n_zero} all-zero padding "
        f"rows; k={k}")
    b4 = sampled_threshold.sampled_select(mag, k=k)
    check_bitwise(f"B4 sampled_threshold, {cols} columns",
                  zip((t.view(torch.int32) for t in b4),
                      (t.view(torch.int32) for t in sampled_threshold.sampled_select_plain(mag, k=k))))
    b4_ms = time_ms(lambda: sampled_threshold.sampled_select(mag, k=k), 5)
    tau, eps, p_codes = compress_params(mag, re, im, b4[0])
    del mag, b4
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


def api_train(dev, steps: int, n_layers: int = N_LAYERS, loop=None, mode: str = "compressed_dp",
              mesh=None, **reducer_kwargs):
    """Training through the port's Python API, built as the CLI builds it:
    ReducerConfig -> StepConfig -> train_loop (sequenced, 64 MB buckets,
    EF, selector auto); ``loop`` holds more TrainLoopConfig fields; ``mode``
    and ``mesh`` the step's (a mesh with a ``pod`` axis sets
    ``multi_pod``)."""
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
    step_cfg = StepConfig(mode=mode, reducer=reducer,
                          multi_pod=mesh is not None and "pod" in mesh.shape)
    state = init_state(model, opt, error_feedback=reducer.error_feedback, mesh=mesh,
                       step_cfg=step_cfg)
    return train_loop(model, opt, step_cfg, state, stream,
                      TrainLoopConfig(total_steps=steps, log_every=1, **(loop or {})),
                      group=mesh)


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
# every phase's losses and peak memory (GB)
LOSSES = {}
PEAK_GB = {}


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
    LOSSES[label], PEAK_GB[label] = losses, peak_gb
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


# train-fsdp against train-dense: the same model, batch and arithmetic on a
# (1, 1) mesh, where every gather and reduce-scatter spans one rank; the
# losses must be bitwise unless the card's backward is nondeterministic, and
# then within this relative bound
FSDP_LOSS_REL = 1e-4


def sharding_phases(dev, kernels, fused) -> None:
    """Phase 7b: ``--mode hierarchical`` and the sharded ``pjit`` state on
    one card.  ``train-hier-mode``: ``api_train``'s run (EF, sequenced 64
    MB, backend and selector ``auto``, 3 steps) in ``mode="hierarchical"``
    with the ``hierarchical`` kind on a ``(1, 1, 1)`` ``("pod", "data",
    "model")`` mesh: B4, B2 and B3 launch 2, 2 and 1 times a step, and with
    one pod the pod exchange is the one-worker exchange, so its losses and
    final parameters and residual are bitwise those of the same run in
    ``compressed_dp`` (``train-api-auto``).  ``train-fsdp``: ``DENSE_ARGS``'s
    model and batch in ``pjit`` with ``fsdp=True`` on a ``(1, 1)``
    ``("data", "model")`` mesh over a one-rank NCCL group, through the API
    (the CLI never sets ``fsdp``): DTensor leaves, the gather at use and the
    redistributed gradients, no kernel; its losses held against
    ``train-dense``'s, its step ms and peak memory printed beside them."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.comms import calibrate
    from repro_torch.data import SyntheticStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import stream_config
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, init_state, train_loop
    from repro_torch.train.step import StepConfig

    train_phase(lambda: api_train(dev, 3, backend="auto"), kernels, "train-api-auto", fused,
                digest=True)
    mesh = make_local_mesh((1, 1, 1), ("pod", "data", "model"))
    counts, _ = train_phase(lambda: api_train(dev, 3, mode="hierarchical", mesh=mesh,
                                              kind="hierarchical", backend="auto"),
                            kernels, "train-hier-mode", fused, digest=True)
    for name, per_step in LAUNCHES_PER_STEP.items():
        if counts[name] != 3 * per_step:
            raise AssertionError(f"train-hier-mode launched {name} {counts[name]} times in 3 "
                                 f"steps, not {per_step} a step")
    (losses, digests), (base_losses, base_digests) = (DIGESTS.pop("train-hier-mode"),
                                                      DIGESTS.pop("train-api-auto"))
    differ = sorted(k for k in base_digests if digests.get(k) != base_digests[k])
    if losses != base_losses or differ or set(digests) != set(base_digests):
        raise AssertionError(f"train-hier-mode losses {losses} vs {base_losses}; final state "
                             f"differs from train-api-auto's in {differ[:5]}")
    log(f"[train-hier-mode] losses and {len(digests)} final tensors bitwise train-api-auto's")

    def fsdp_run():
        cfg = dataclasses.replace(model_config(), n_layers=N_LAYERS)
        model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        opt = OptConfig(kind="adamw", lr=3e-4)
        stream = SyntheticStream(stream_config(cfg, SEQ, BATCH, 0), device=dev)
        step_cfg = StepConfig(mode="pjit", fsdp=True)
        with calibrate.process_group(dev):
            fsdp_mesh = make_local_mesh((1, 1), ("data", "model"), device=dev)
            state = init_state(model, opt, mesh=fsdp_mesh, step_cfg=step_cfg)
            leaves = state["model"].leaves()
            if not all(isinstance(v, DTensor) for v in leaves.values()):
                raise AssertionError("train-fsdp: the state is not DTensor leaves")
            sharded = sum(v.placements[0].is_shard() for v in leaves.values())
            log(f"[train-fsdp] {len(leaves)} DTensor leaves, {sharded} sharded over 'data'")
            result = train_loop(model, opt, step_cfg, state, stream,
                                TrainLoopConfig(total_steps=3, log_every=1), group=fsdp_mesh)
            result["state"] = None
            return result

    train_phase(fsdp_run, kernels, "train-fsdp", (), must_not_launch=True)
    got, want = LOSSES["train-fsdp"], LOSSES["train-dense"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    log(f"[train-fsdp] losses {got} vs train-dense {want}: bitwise={got == want} "
        f"max rel diff={rel:.3e} (bound {FSDP_LOSS_REL:g}, step 0 bitwise)")
    log(f"[train-fsdp] steady step ms {PHASE_MS['train-fsdp']:.1f} vs train-dense "
        f"{PHASE_MS['train-dense']:.1f}; peak memory {PEAK_GB['train-fsdp']:.2f} GB vs "
        f"{PEAK_GB['train-dense']:.2f} GB")
    if len(got) != len(want) or got[0] != want[0] or rel > FSDP_LOSS_REL:
        raise AssertionError(f"train-fsdp losses {got} against train-dense's {want}")


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
            hier_losses = losses
    _psum_noderound_phase(kernels, fused, hier_losses)
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


def _psum_noderound_phase(kernels, fused, hier_losses) -> None:
    """``train-psum-noderound``: ``train-psum`` with its exchange fed
    ``_node_mean`` of the corrected gradient -- the island's irfft(rfft(g))
    on the (1, 1) mesh, what ``train-hierarchical`` compresses -- while the
    EF roundtrip keeps the raw one, as hierarchical's does.  With one
    worker the two exchanges then differ only in a product by 1.0, so their
    losses must be bitwise equal: the node mean's rounding is what moves
    ``train-hierarchical``'s losses off ``train-psum``'s."""
    from repro_torch.comms import transport as transport_mod
    from repro_torch.launch import train as train_cli

    class NodeRoundPsum(transport_mod.SpectrumPsumTransport):
        def _exchange_flat(self, flat, layout, comp, group, stacked=True, monitor=None):
            return super()._exchange_flat(transport_mod._node_mean(flat, layout, comp, None),
                                          layout, comp, group, stacked, monitor)

    psum = transport_mod._TRANSPORTS["psum"]
    transport_mod._TRANSPORTS["psum"] = NodeRoundPsum()
    try:
        _, history = train_phase(lambda: train_cli.main(TRAIN_ARGS + PSUM + ["--steps", "3"]),
                                 kernels, "train-psum-noderound", fused)
    finally:
        transport_mod._TRANSPORTS["psum"] = psum
    losses = [row["loss"] for row in history]
    if losses != hier_losses:
        raise AssertionError(f"train-psum-noderound: losses {losses} differ from "
                             f"train-hierarchical's {hier_losses}")
    log(f"[train-psum-noderound] losses {losses} bitwise train-hierarchical's: the node "
        f"mean's irfft(rfft(g)) rounding is what moves them off train-psum's")


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


# the serving phases: batch x prompt + new tokens, and the arch each serves
# at its full depth (gemma2_2b 26 layers, hymba_1_5b 32, xlstm_1_3b 48,
# seamless_m4t_large_v2 24 + 24 encoder layers over the prompt's 512 audio
# frames, llama3_2_vision_11b 40 over 1601 patches)
SERVE_SHAPES = {"serve": (8, 512, 32), "serve-long": (2, 4608, 64),
                "serve-hymba": (8, 512, 32), "serve-xlstm": (8, 512, 32),
                "serve-seamless": (8, 512, 32), "serve-vision": (8, 512, 32)}
SERVE_ARCH = {"serve": "gemma2_2b", "serve-long": "gemma2_2b", "serve-hymba": "hymba_1_5b",
              "serve-xlstm": "xlstm_1_3b", "serve-seamless": "seamless_m4t_large_v2",
              "serve-vision": "llama3_2_vision_11b"}
# decode_step's logits against one forward over the same tokens (relative L2
# over every compared position): both run bf16 matmuls, but a one-token
# product rounds and accumulates otherwise than a whole sequence's, through
# 26 layers; the model tests' gradient tolerance.  The recurrent kinds'
# decode (hymba's SSM step, xlstm's mLSTM at one step and sLSTM) is another
# arrangement than their chunked forward: each layer's decode path is also
# held to its full-sequence path on the same inputs (``layerwise_gap``),
# within the same limit.  At reduced size on the CPU the reference's own
# decode-to-forward gap is 0.0 for both archs and the port's 3.0e-3 (hymba)
# and 0.0 (xlstm)
SERVE_LOGITS_REL = 5e-2
# xlstm's end-to-end gap is printed at its served depth and at one group
# (8 layers) at full width, and held at the one config the reference has
# been read at: one group, d_model 1024 and the reduced sizes otherwise,
# batch 2 x prompt 20 + 6 of seeded tokens (XLSTM_GROUP).  xlstm amplifies
# bf16 rounding through depth and width, so its decode and forward part by
# their rounding alone: the reference's own gap there (CPU, jitted) is
# XLSTM_GROUP_REF_GAP, as tests/test_torch_xlstm.py reads it (the port's
# there: 2.09e-2 on one CPU thread).  On the card the port's reads 0.106 at
# one group and full width (d_model 2048), 0.78 at 48 layers.  Held within
# SERVE_LOGITS_REL
# the cross layers' gate (tanh of a parameter that starts at zero) opened for
# serve-vision's per-layer check and its printed end-to-end gap
CROSS_GATE_OPEN = 0.5
XLSTM_GROUP = {"changes": {"n_layers": 8, "d_model": 1024, "n_heads": 4, "head_dim": 256},
               "shape": (2, 20, 6), "seed": 0}
XLSTM_GROUP_REF_GAP = 1.79e-2


def xlstm_group_tokens(cfg) -> torch.Tensor:
    """``XLSTM_GROUP``'s tokens, (batch, prompt + new) int64 on the CPU."""
    b, p, n = XLSTM_GROUP["shape"]
    return torch.randint(0, cfg.vocab_size, (b, p + n),
                         generator=torch.Generator().manual_seed(XLSTM_GROUP["seed"]))
# each cache leaf's shape at the zoo serve phases' batch 8 and max_seq 552
# (prompt 512 + 32 + 8) after the prefill: the reference's LM.init_caches, as
# tests/test_torch_zoo.py holds this table to it, and for the frontend archs
# the reference's prefill output, whose cross caches are as long as the
# memory (tests/test_torch_encdec.py)
_MLSTM_CACHE = {"c": (6, 8, 4, 1024, 1024), "n": (6, 8, 4, 1024), "m": (6, 8, 4),
                "conv": (6, 8, 3, 4096)}
SERVE_CACHE_SHAPES = {
    "serve-hymba": {"l0_hybrid": ({"k": (32, 8, 552, 5, 64), "v": (32, 8, 552, 5, 64),
                                   "pos": (32, 552)},
                                  {"conv": (32, 8, 3, 3200), "h": (32, 8, 3200, 16)})},
    "serve-xlstm": {**{f"l{i}_mlstm": _MLSTM_CACHE for i in range(7)},
                    "l7_slstm": {name: (6, 8, 2048) for name in ("c", "n", "h", "m")}},
    "serve-seamless": {"l0_dec_cross_mlp": (
        {"k": (24, 8, 552, 16, 64), "v": (24, 8, 552, 16, 64), "pos": (24, 552)},
        {"k": (24, 8, 512, 16, 64), "v": (24, 8, 512, 16, 64), "pos": (24, 512)})},
    "serve-vision": {**{f"l{i}_attn_mlp": {"k": (8, 8, 552, 8, 128), "v": (8, 8, 552, 8, 128),
                                           "pos": (8, 552)} for i in range(4)},
                     "l4_cross_attn_mlp": {"k": (8, 8, 1601, 8, 128),
                                           "v": (8, 8, 1601, 8, 128), "pos": (8, 1601)}},
}
# train-publish's ring: a delta every step, a snapshot every 2 deltas, 2
# buffered
PUBLISH_ARGS = ["--publish-every", "1", "--publish-snapshot-every", "2",
                "--publish-capacity", "2"]
PUBLISH_STEPS = 5
# a replica's distance from the trainer's final weights, over the norm of
# the ring's last delta: that delta's codec error (8-bit codes with 3
# mantissa bits round a kept value by at most 2^-4 of itself)
STALENESS = 0.1


def serve_max_seq(label: str) -> int:
    """The cache length a serve phase's engine allocates (``launch.serve``'s
    prompt + new + 8)."""
    _, prompt, new = SERVE_SHAPES[label]
    return prompt + new + 8


def cache_shapes(caches) -> dict:
    """``{"l{i}_{kind}": {field: shape}}`` (a pair of them for a hybrid
    layer) of either package's caches: every array field of each cache
    dataclass, KVCache's ``ring`` flag left out."""
    import dataclasses

    def one(cache):
        if isinstance(cache, tuple):
            return tuple(one(c) for c in cache)
        return {f.name: tuple(getattr(cache, f.name).shape) for f in dataclasses.fields(cache)
                if hasattr(getattr(cache, f.name), "shape")}

    return {key: one(c) for key, c in caches.items()}


def decode_and_forward(model, tokens, prompt: int, max_seq: int, frontend=None):
    """``decode_step``'s logits, teacher-forced along ``tokens`` after a
    prefill of ``prompt``, and one ``forward``'s over the same tokens, at
    every decoded position -> (stepped, full), each (B, new, V) f32; an arch
    with a frontend attends to ``frontend``'s memory on both sides."""
    new = tokens.shape[1] - prompt
    with torch.no_grad():
        memory = model.frontend_memory(frontend)
    logits, caches = model.prefill(tokens[:, :prompt], memory=memory, max_seq=max_seq,
                                   last_only=True)
    stepped = [logits[:, 0]]
    for i in range(new - 1):
        logits, caches = model.decode_step(caches, tokens[:, prompt + i:prompt + i + 1],
                                           prompt + i)
        stepped.append(logits[:, 0])
    del caches
    stepped = torch.stack(stepped, dim=1)
    with torch.no_grad():
        hidden, _ = model(tokens[:, :prompt + new - 1], memory=memory, return_hidden=True)
        full = model._logits(hidden[:, prompt - 1:])
    return stepped, full


def logits_gap(stepped, full) -> dict:
    """Relative L2, max abs and argmax agreement of ``stepped`` against
    ``full`` over every position they hold."""
    return {"rel": float(torch.linalg.vector_norm(stepped - full)
                         / torch.linalg.vector_norm(full)),
            "max_abs": float((stepped - full).abs().max()),
            "agree": float((stepped.argmax(-1) == full.argmax(-1)).float().mean()),
            "positions": stepped.shape[:-1].numel()}


def decode_vs_forward(model, tokens, prompt: int, max_seq: int, frontend=None) -> dict:
    """``logits_gap`` of ``decode_and_forward`` over every decoded position."""
    stepped, full = decode_and_forward(model, tokens, prompt, max_seq, frontend)
    out = logits_gap(stepped, full)
    del stepped, full
    return out


def moe_decode_vs_forward(model, tokens, prompt: int, max_seq: int) -> dict:
    """``decode_and_forward`` of a model with one MoE layer, with the experts
    each decoded position went to on either side: a position's logits
    depend on its own choices alone (the attention before the MoE block
    reads the layer's input, and only the head follows it).  The experts a
    position used are its kept choices (top-k within capacity).  ->
    ``logits_gap`` over the positions whose experts agree, and the counts
    of the others: ``flipped`` (the router's top-k differ) and ``dropped``
    (the same top-k, a choice over capacity on one side), with forward's
    k-th over (k+1)-th probability at each flipped position."""
    from repro_torch.models import moe as M

    cfg = model.cfg
    if sum(kind.endswith("moe") for kind in model.pattern) * model.n_groups != 1:
        raise AssertionError(f"{cfg.name}: the choice check takes one MoE layer")
    k, b = cfg.experts_per_token, tokens.shape[0]
    calls, route = [], M.route

    def recording(groups, router, cfg):
        r = route(groups, router, cfg)
        calls.append(r)
        return r

    M.route = recording
    try:
        stepped, full = decode_and_forward(model, tokens, prompt, max_seq)
    finally:
        M.route = route
    new = tokens.shape[1] - prompt
    if len(calls) != new + 1:
        raise AssertionError(f"{cfg.name}: {len(calls)} MoE calls, not {new + 1}")

    def per_token(r, n, field):
        value = getattr(r, field)
        return value.reshape(-1, *value.shape[2:])[: b * n].reshape(b, n, *value.shape[2:])

    def experts(r, n):
        kept = torch.where(per_token(r, n, "slot") < r.cap, per_token(r, n, "top_e"), -1)
        return (torch.sort(kept, dim=-1).values,
                torch.sort(per_token(r, n, "top_e"), dim=-1).values)

    dec = [tuple(t[:, -1:] for t in experts(calls[0], prompt))]
    dec += [experts(r, 1) for r in calls[1:new]]
    dec_kept, dec_top = (torch.cat([d[j] for d in dec], dim=1) for j in (0, 1))
    fwd_kept, fwd_top = (t[:, prompt - 1:] for t in experts(calls[new], prompt + new - 1))
    same = torch.all(dec_kept == fwd_kept, dim=-1)
    flipped = ~torch.all(dec_top == fwd_top, dim=-1)
    probs = per_token(calls[new], prompt + new - 1, "probs")[:, prompt - 1:]
    top = torch.sort(probs, dim=-1, descending=True).values
    margins = (top[..., k - 1] - top[..., k])[flipped]
    del calls
    out = logits_gap(stepped[same], full[same]) if bool(same.any()) else {
        "rel": float("nan"), "max_abs": float("nan"), "agree": float("nan"), "positions": 0}
    out.update(all=logits_gap(stepped, full), flipped=int(flipped.sum()),
               dropped=int((~same & ~flipped).sum()), margins=margins.tolist())
    del stepped, full
    return out


def layerwise_gap(model, tokens, prompt: int, max_seq: int, frontend=None) -> float:
    """Each layer's decode path against its full-sequence path on the same
    inputs: the inputs of every layer along ``tokens`` come from one
    forward; the full path runs the layer over all of them, the decode path
    prefills the layer's cache over the prompt and steps it one position at
    a time through the rest (a cross layer attends to ``frontend``'s
    memory, through its cache when decoding).  -> the largest relative L2,
    over layers, of the layer's update (its output less its input) at the
    decoded positions."""
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import _group_cache

    with torch.no_grad():
        memory = model.frontend_memory(frontend)
    caches = model.init_caches(tokens.shape[0], max_seq,
                               memory_len=None if memory is None else memory.shape[1])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(model.embed["table"], tokens)
    worst = 0.0
    with torch.no_grad():
        for g in range(model.n_groups):
            for i, kind in enumerate(model.pattern):
                cache = _group_cache(caches[f"l{i}_{kind}"], g)
                full, _ = model._layer(i, kind, g, x, positions, memory=memory)
                model._layer(i, kind, g, x[:, :prompt], positions[:prompt], cache,
                             memory=memory)
                stepped = torch.cat([
                    model._layer(i, kind, g, x[:, t:t + 1], positions[t:t + 1], cache, t,
                                 memory)[0]
                    for t in range(prompt, tokens.shape[1])], dim=1)
                want = (full[:, prompt:] - x[:, prompt:]).float()
                got = (stepped - x[:, prompt:]).float()
                worst = max(worst, float(torch.linalg.vector_norm(got - want)
                                         / torch.linalg.vector_norm(want)))
                x = full
    del caches
    return worst


def serve_phase(dev, counted, label: str) -> None:
    """``launch.serve`` standalone at its arch's full width and depth
    (gemma2_2b: 26 layers, ~2.61 B parameters; hymba_1_5b: 32, ~0.80 B;
    xlstm_1_3b: 48, ~4.39 B; seamless_m4t_large_v2: 24 + 24, ~1.63 B;
    llama3_2_vision_11b: 40, ~9.78 B): batch x prompt, then the new tokens
    greedily; the tokens again through ``Engine`` (equal); then
    ``decode_step``'s logits along the generated sequence, teacher-forced,
    against one ``forward`` over it (``SERVE_LOGITS_REL``; xlstm's printed
    at 48 layers and at one group, and held at ``XLSTM_GROUP``).  The
    frontend archs get the CLI's frontend (seamless: 512 audio frames
    through its encoder; vision: 1601 patches) on every side.  No kernel
    launches.  gemma2: with a prompt past the 4096 window, the 13 local
    layers' caches are rings and the global layers' are not; the others:
    every cache leaf after the prefill has the reference's shape
    (``SERVE_CACHE_SHAPES``; the cross caches as long as the memory), and
    for the recurrent and cross kinds each layer's decode path is held to
    its full path (``layerwise_gap``); llama-vision's gates, which start at
    zero, are opened to ``CROSS_GATE_OPEN`` for that check, and its
    end-to-end gap with them open is printed."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build
    from repro_torch.models.transformer import CROSS_KINDS
    from repro_torch.serve import Engine, ServeConfig

    arch = SERVE_ARCH[label]
    batch, prompt, new = SERVE_SHAPES[label]
    for kern in counted:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = serve_cli.main(["--arch", arch, "--batch", str(batch), "--prompt-len",
                             str(prompt), "--new-tokens", str(new)])
    wall = time.perf_counter() - t0
    model, cfg, tokens, prompts, frontend = (result[k] for k in ("model", "config", "tokens",
                                                                   "prompts", "frontend"))
    tm = result["timings"]
    del result
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {kern.name: kern.launches for kern in counted}
    if any(launches.values()):
        raise AssertionError(f"{label} launched kernels: {launches}")
    depth = configs.get_config(arch).n_layers
    if cfg.n_layers != depth:
        raise AssertionError(f"{label} served {cfg.n_layers} layers, not {depth}")
    params = sum(p.numel() for p in model.parameters())
    max_seq = serve_max_seq(label)
    warm = {}  # the second run's times: the first's include the card's first launches
    again = Engine(model, ServeConfig(max_seq=max_seq, batch=batch)).generate(
        prompts, new, timings=warm, frontend=frontend)
    if not torch.equal(again, tokens):
        raise AssertionError(f"{label}: a second run gave other tokens")
    if tuple(tokens.shape) != (batch, prompt + new) or not torch.equal(tokens[:, :prompt],
                                                                      prompts):
        raise AssertionError(f"{label}: tokens of shape {tuple(tokens.shape)}")
    with torch.no_grad():
        memory = model.frontend_memory(frontend)
    _, caches = model.prefill(tokens[:, :prompt], memory=memory, max_seq=max_seq,
                              last_only=True)
    del memory
    if arch == "gemma2_2b":
        got = {key: (c.ring, c.k.shape[2]) for key, c in caches.items()}
        want = {key: (("local" in key) and max_seq > cfg.sliding_window,
                      min(max_seq, cfg.sliding_window) if "local" in key else max_seq)
                for key in caches}
        what = "caches (ring, slots)"
    else:
        got, want = cache_shapes(caches), SERVE_CACHE_SHAPES[label]
        what = "cache leaf shapes"
    del caches
    if got != want:
        raise AssertionError(f"{label}: {what} {got}, expected {want}")
    gap = decode_vs_forward(model, tokens, prompt, max_seq, frontend)
    checks = ""
    if arch == "llama3_2_vision_11b":
        # ROADMAP §3 fault 13: the gap's stated cause is bf16 rounding; the
        # same model computing in f32 (as fault 12 reads the gate's gradient)
        with compute_dtype(torch.float32):
            f32 = decode_vs_forward(model, tokens, prompt, max_seq, frontend)
        checks += (f"; in f32: decode vs forward {f32['rel']:.3e} relative L2 (printed), max "
                   f"abs {f32['max_abs']:.3e}, argmax agreement {f32['agree']:.4f}")
    gates = [p for name, p in model.named_parameters() if name.endswith("cross_gate")]
    if gates:
        # the gates start at zero: open them, so the cross layers' decode
        # path (queries against the cached memory K/V) moves the logits
        with torch.no_grad():
            for p in gates:
                p.fill_(CROSS_GATE_OPEN)
        opened = decode_vs_forward(model, tokens, prompt, max_seq, frontend)
        checks += (f"; with cross_gate at {CROSS_GATE_OPEN}: decode vs forward "
                   f"{opened['rel']:.3e} relative L2 (printed), max abs "
                   f"{opened['max_abs']:.3e}, argmax agreement {opened['agree']:.4f}")
    if any(kind in ("hybrid", "mlstm", "slstm") or kind in CROSS_KINDS
           for kind in model.pattern):
        worst = layerwise_gap(model, tokens, prompt, max_seq, frontend)
        if not math.isfinite(worst) or worst > SERVE_LOGITS_REL:
            raise AssertionError(f"{label}: a layer's decode path is {worst:.3e} (relative L2) "
                                 f"from its full-sequence path, limit {SERVE_LOGITS_REL}")
        checks += (f"; each layer's decode path against its full-sequence path on the same "
                   f"inputs{' (gates open)' if gates else ''}: at most {worst:.3e} (limit "
                   f"{SERVE_LOGITS_REL})")
    held = gap
    if arch == "xlstm_1_3b":
        del model
        torch.cuda.empty_cache()
        group = dataclasses.replace(cfg, n_layers=XLSTM_GROUP["changes"]["n_layers"])
        model = build(group, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        one = decode_vs_forward(model, tokens, prompt, max_seq)
        del model
        b, p, n = XLSTM_GROUP["shape"]
        small = dataclasses.replace(cfg.reduced(), **XLSTM_GROUP["changes"])
        model = build(small, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        seeded = xlstm_group_tokens(small).to(dev)
        held = decode_vs_forward(model, seeded, p, p + n + 8)
        checks += (f"; at one group and full width: {one['rel']:.3e} relative L2 (printed), "
                   f"max abs {one['max_abs']:.3e}, argmax agreement {one['agree']:.4f}; at "
                   f"one group and d_model {small.d_model} (the reference's reading "
                   f"{XLSTM_GROUP_REF_GAP}): {held['rel']:.3e} relative L2 (limit "
                   f"{SERVE_LOGITS_REL}), argmax agreement {held['agree']:.4f}")
    steps = warm["decode_steps"]
    decode_ms = warm["decode_s"] * 1e3 / steps
    PHASE_MS[label] = decode_ms
    log(f"[{label}] {arch}, {params} parameters, batch {batch} x prompt {prompt} + {new} new, "
        f"second run: prefill {warm['prefill_s'] * 1e3:.1f} ms, decode {decode_ms:.2f} ms a "
        f"step, {batch * steps / warm['decode_s']:.1f} decoded tokens/s (first run: prefill "
        f"{tm['prefill_s'] * 1e3:.1f} ms, decode {tm['decode_s'] * 1e3 / steps:.2f} ms a "
        f"step); wall {wall:.1f}s, "
        f"peak_memory={peak_gb:.2f} GB; two runs equal; decode vs forward over "
        f"{gap['positions']} positions: {gap['rel']:.3e} relative L2 ("
        f"{f'limit {SERVE_LOGITS_REL}' if held is gap else 'printed, not held'}), max "
        f"abs {gap['max_abs']:.3e}, argmax agreement {gap['agree']:.4f}{checks}; {what} "
        f"{got if arch == 'gemma2_2b' else 'as the reference'}")
    del model
    torch.cuda.empty_cache()
    if not math.isfinite(gap["rel"]) or not math.isfinite(held["rel"]) or \
            held["rel"] > SERVE_LOGITS_REL:
        raise AssertionError(f"{label}: decode logits {held['rel']:.3e} (relative L2) from "
                             f"forward's, limit {SERVE_LOGITS_REL}")


def _flat_host(leaves) -> torch.Tensor:
    from repro_torch.comms.reducers import flatten_tree

    with torch.no_grad():
        return flatten_tree({k: v.detach() for k, v in leaves.items()})[0].cpu()


def _last_delta_norm(sub) -> float:
    """Norm of the subscriber's ring's newest delta, decoded on its own."""
    from repro_torch.core.compressor import StackedPayload
    from repro_torch.serve import SpectrumReplicaState

    manifest = sub.reader.manifest()
    state = SpectrumReplicaState(torch.zeros(sub.layout.total, device=sub.device), sub.layout,
                                 sub.comp)
    blob = sub.reader.read_delta(manifest, int(manifest["latest_version"]))
    state.fold(StackedPayload.from_bytes(blob, sub.device))
    return float(torch.linalg.vector_norm(state.materialize().double()))


def _log_publishes(label: str, timings) -> None:
    """One line a publish: ``WeightDeltaPublisher.timings``."""
    for rec in timings:
        log(f"[{label}] v{rec['version']}: {rec['bytes']} bytes, encode "
            f"{rec['encode_s'] * 1e3:.1f} ms, write {rec['write_s'] * 1e3:.1f} ms, snapshot "
            f"{rec['snapshot_s'] * 1e3:.1f} ms")


def publish_phases(kernels, fused) -> None:
    """The CLI end to end at full width, 4 layers.  ``train-publish``: the
    ``train`` phase's flags, ``PUBLISH_STEPS`` steps, ``--publish-dir`` with
    a delta every step at the default publish theta 0, a snapshot every 2
    and 2 buffered; B4 and B2 launch once a publish beside the step's 2
    each.  Then, with the trainer freed, ``serve-follow``: ``launch.serve
    --follow`` loads the v4 snapshot and folds v5 (one decompress), and the
    served weights must be bitwise the publisher's mirror and within
    ``STALENESS`` of the last delta from the trainer's final weights."""
    import shutil
    import tempfile

    from repro_torch.comms import cost_model
    from repro_torch.launch import serve as serve_cli, train as train_cli

    ring = tempfile.mkdtemp(prefix="chip-smoke-ring-")
    disk0 = shutil.disk_usage(ring)
    keep = {}

    def run():
        result = train_cli.main(TRAIN_ARGS + SEQUENCED + ["--steps", str(PUBLISH_STEPS),
                                                          "--publish-dir", ring, *PUBLISH_ARGS])
        pub = result["publisher"]
        keep.update(true=_flat_host(result["state"]["model"].leaves()),
                    mirror=pub.state.materialize().cpu(), version=pub.version,
                    delta_bytes=pub.delta_bytes_total, snapshot_bytes=pub.snapshot_bytes_total,
                    layout=pub.layout, timings=list(pub.timings),
                    account=cost_model.publish_wire_account(
                        pub.layout.total, pub.comp.wire_bits, pub.layout.sizes(),
                        steps=PUBLISH_STEPS, publish_every=1, snapshot_every=2))
        return result

    try:
        counts, _ = train_phase(run, kernels, "train-publish", fused)
        disk1 = shutil.disk_usage(ring)
        want = {"sampled_threshold": 3 * PUBLISH_STEPS, "fused_compress": 3 * PUBLISH_STEPS,
                "fused_decompress": PUBLISH_STEPS}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"train-publish launched {counts}, expected {want} (the "
                                 "steps' 2, 2, 1 and one B4 and B2 a publish)")
        acct, layout = keep["account"], keep["layout"]
        per_delta = keep["delta_bytes"] / keep["version"]
        log(f"[train-publish] v{keep['version']}: {layout.n_buckets} buckets of "
            f"{layout.max_chunks} chunks; {per_delta:.0f} bytes a delta "
            f"(publish_wire_account: {acct.delta_bits / 8 / acct.n_publishes:.0f}), "
            f"snapshots {keep['snapshot_bytes']} bytes ({acct.snapshot_bits / 8:.0f} "
            f"modeled); disk used {disk0.used} -> {disk1.used} bytes, free {disk1.free}")
        _log_publishes("train-publish", keep["timings"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        served = serve_cli.main(["--follow", ring])
        wall = time.perf_counter() - t0
        sub, model = served["subscriber"], served["model"]
        if any(kern.launches for kern in kernels):
            raise AssertionError("serve-follow launched a kernel")
        weights = _flat_host(model.leaves())
        if sub.version != keep["version"] or sub.state.decompress_count != 1:
            raise AssertionError(f"serve-follow: v{sub.version}, "
                                 f"{sub.state.decompress_count} decompress")
        if not torch.equal(weights, keep["mirror"]):
            raise AssertionError("serve-follow: the served weights differ from the mirror")
        stale = float(torch.linalg.vector_norm((keep["true"] - weights).double()))
        last = _last_delta_norm(sub)
        if not stale <= STALENESS * last:
            raise AssertionError(f"serve-follow: {stale:.3e} from the trainer, last delta "
                                 f"{last:.3e}, limit {STALENESS} of it")
        log(f"[serve-follow] v{sub.version}, decompress_count {sub.state.decompress_count}: "
            f"follow and load {served['timings']['follow_s'] * 1e3:.1f} ms, wall {wall:.1f}s, "
            f"peak_memory={torch.cuda.max_memory_allocated() / 1e9:.2f} GB; weights bitwise "
            f"the mirror; {stale:.4e} from the trainer's (L2; last delta {last:.4e}, ratio "
            f"{stale / last:.4e}, limit {STALENESS}; {stale / float(keep['true'].norm()):.3e} "
            f"of the weights)")
        del served, sub, model
    finally:
        shutil.rmtree(ring, ignore_errors=True)
    log(f"[train-publish] ring deleted: disk used {shutil.disk_usage(tempfile.gettempdir()).used}")
    torch.cuda.empty_cache()


def publish_api_phase(dev, kernels) -> None:
    """``serve-publish-api``: the catch-up ladder through the API at 4
    layers.  A dense (``pjit``) trainer publishes every step at theta 0.7 on
    the ``auto`` backend (B4 and B2 once a publish, nothing else launched),
    a snapshot every 3 deltas, 3 buffered; a subscriber made at v0 syncs at
    step 2 (v1..v3 replayed, a local rebase at v3, one decompress) and at
    step 6 (the tail wrapped past v4: the v6 snapshot, then v7), bitwise
    the mirror after each."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.serve import PublishConfig, ReplicaSubscriber, WeightDeltaPublisher
    from repro_torch.train import TrainLoopConfig, init_state, train_loop
    from repro_torch.train.step import StepConfig

    ring = tempfile.mkdtemp(prefix="chip-smoke-ring-")
    syncs = {}
    try:
        cfg = model_config()
        model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        opt = OptConfig(kind="adamw", lr=3e-4)
        stream = SyntheticStream(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                                 global_batch=BATCH, seed=0), device=dev)
        state = init_state(model, opt)
        pub = WeightDeltaPublisher(ring, model.leaves(), PublishConfig(
            theta=KEEP_THETA, snapshot_every=3, capacity=3, backend="auto", selector="auto"))
        sub = ReplicaSubscriber(ring)
        publish = pub.hook()

        def hook(step, st):
            publish(step, st)
            if step in (2, 6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats = sub.sync()
                torch.cuda.synchronize()
                syncs[step] = (dataclasses.asdict(stats), time.perf_counter() - t0,
                               torch.equal(sub.weights(), pub.state.materialize()))

        train_phase(lambda: train_loop(model, opt, StepConfig(mode="pjit"), state, stream,
                                       TrainLoopConfig(total_steps=7, log_every=1,
                                                       publish_hook=hook)),
                    kernels, "serve-publish-api", ("sampled_threshold", "fused_compress"))
        launches = {kern.name: kern.launches for kern in kernels if kern.launches}
        if launches != {"sampled_threshold": 7, "fused_compress": 7}:
            raise AssertionError(f"serve-publish-api launched {launches}, expected B4 and B2 "
                                 "once a publish")
        _log_publishes("serve-publish-api", pub.timings)
        want = ({"applied": 3, "rebases": 1, "decompress_count": 1, "gap_detected": False,
                 "snapshot_loads": 0, "version": 3},
                {"applied": 1, "rebases": 0, "decompress_count": 1, "gap_detected": True,
                 "snapshot_loads": 1, "version": 7})
        for (step, (stats, secs, bitwise)), expect in zip(sorted(syncs.items()), want):
            log(f"[serve-publish-api] sync at step {step}: {stats}, {secs * 1e3:.1f} ms, "
                f"bitwise the mirror: {bitwise}")
            if {k: stats[k] for k in expect} != expect or not bitwise:
                raise AssertionError(f"serve-publish-api: sync at step {step} gave {stats} "
                                     f"(bitwise {bitwise}), expected {expect}")
        del pub, sub, state, model
    finally:
        shutil.rmtree(ring, ignore_errors=True)
    torch.cuda.empty_cache()


def theory_phase(dev, kernels) -> None:
    """Phase 15: Assumption 3.1 on a live gradient at full width, and the
    paper's Algorithm 1 beside the closed-form quantizer fit."""
    from repro_torch.comms.bucketing import stack_buckets
    from repro_torch.comms.reducers import flatten_tree
    from repro_torch.core import quantizer as Q
    from repro_torch.core.compressor import FFTCompressor, FFTCompressorConfig
    from repro_torch.core.theory import assumption31_holds_stats, assumption31_stats
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.models import build

    t_phase = time.perf_counter()
    cfg = model_config()
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    stream = SyntheticStream(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                             global_batch=BATCH, seed=0), device=dev)
    loss, _ = model.loss(stream.batch_at(0))
    loss.backward()
    flat, _ = flatten_tree({name: p.grad for name, p in model.leaves().items()})
    del model, loss
    torch.cuda.empty_cache()
    layout = main_path_layout()
    stacked = stack_buckets(flat, layout)
    del flat
    fused = ("sampled_threshold", "fused_compress", "fused_decompress")
    for theta in THEORY_THETAS:
        comp = FFTCompressor(FFTCompressorConfig(theta=theta, backend="cuda", selector="auto"))
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = comp.compress_stacked(stacked, layout.sizes())
        hat = comp.decompress_stacked(payload)
        torch.cuda.synchronize()
        roundtrip_ms = (time.perf_counter() - t0) * 1e3
        launches = {kern.name: kern.launches for kern in kernels if kern.launches}
        err, norm = (float(v) for v in assumption31_stats(stacked, hat))
        del hat
        slack = (A31_SQRT_SLACK * math.sqrt(theta) + A31_QUANT_MARGIN) / theta
        holds = assumption31_holds_stats(err, norm, theta, slack, A31_NORM_TOL)
        log(f"[theory] theta {theta}: {stacked.numel()} values, err_ratio {err:.6f} (bound "
            f"{slack * theta:.6f}), norm_ratio {norm:.6f} (bound {1 + A31_NORM_TOL}), "
            f"roundtrip {roundtrip_ms:.1f} ms, launches {launches}")
        if not holds:
            raise AssertionError(f"theory: Assumption 3.1 fails at theta {theta}: err {err}, "
                                 f"norm {norm}")
        if any(launches.get(name, 0) <= 0 for name in fused):
            raise AssertionError(f"theory: theta {theta} launched {launches}")
        if theta == KEEP_THETA:
            PHASE_MS["theory"] = roundtrip_ms
            _fit_comparison(stacked, payload, layout, Q)
        del payload
    del stacked
    torch.cuda.empty_cache()
    log(f"[theory] wall={time.perf_counter() - t_phase:.1f}s")


def _fit_comparison(stacked, payload, layout, Q) -> None:
    """Each bucket's kept coefficients (the true spectrum at the payload's
    indices) fitted by ``solve`` and by ``heuristic``, encoded and decoded
    with the plain ``encode``/``decode``: eps, P and relative L2 error."""
    rows = layout.n_buckets * layout.max_chunks
    spec = torch.fft.rfft(stacked.reshape(rows, layout.chunk), dim=-1)
    idx = payload.idx.reshape(rows, -1).long()
    kept = torch.cat([torch.gather(spec.real, -1, idx), torch.gather(spec.imag, -1, idx)], -1)
    del spec, idx
    kept = kept.reshape(layout.n_buckets, -1)
    lo, hi = kept.amin(-1), kept.amax(-1)
    qcfg = Q.RangeQuantConfig()
    out = {}
    for method in ("solve", "heuristic"):
        q = Q.fit_quantizer(lo, hi, qcfg, method=method)
        rec = Q.decode(Q.encode(kept, q.map(lambda t: t[:, None])), q.map(lambda t: t[:, None]))
        if not bool(torch.isfinite(rec).all()):
            raise AssertionError(f"theory: the {method} fit reconstructs non-finite values")
        rel = (torch.linalg.vector_norm(rec - kept, dim=-1)
               / torch.linalg.vector_norm(kept, dim=-1).clamp_min(1e-30))
        out[method] = (q.eps.tolist(), q.p_codes.tolist(), rel.tolist())
    for b in range(layout.n_buckets):
        (es, ps, rs), (eh, ph, rh) = ((out[m][0][b], out[m][1][b], out[m][2][b])
                                      for m in ("solve", "heuristic"))
        log(f"[theory] bucket {b}: range [{lo[b].item():.6e}, {hi[b].item():.6e}] solve eps "
            f"{es:.6e} P {ps} rel_l2 {rs:.6e} | heuristic eps {eh:.6e} P {ph} rel_l2 {rh:.6e}")
    for m in ("solve", "heuristic"):
        rel = out[m][2]
        log(f"[theory] {m}: relative L2 error mean {sum(rel) / len(rel):.6e}, "
            f"max {max(rel):.6e} over {len(rel)} buckets")


def lab_phase(kernels) -> None:
    """Phase 16: the lab's smoke matrix at one worker on the card; every
    claim's verdict must be ``LAB_VERDICTS``'s."""
    import contextlib
    import tempfile

    from repro_torch.lab import report
    from repro_torch.lab.evaluate import evaluate_results
    from repro_torch.lab.runner import run_matrix
    from repro_torch.lab.spec import smoke_matrix

    row_launches = {}

    @contextlib.contextmanager
    def count(spec):
        for kern in kernels:
            kern.launches = 0
        yield
        row_launches[spec.name] = {kern.name: kern.launches for kern in kernels
                                   if kern.launches}

    matrix = smoke_matrix(1)
    t0 = time.perf_counter()
    results = run_matrix(matrix, verbose=False, device="cuda", around=count)
    wall = time.perf_counter() - t0
    runs = {name: r.to_dict() for name, r in results.items()}
    claims, all_passed = evaluate_results(runs)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-lab-") as tmp:
        path = os.path.join(tmp, "convergence.json")
        report.write_json(path, runs, [c.to_dict() for c in claims], all_passed)
        log(f"[lab] wrote {os.path.getsize(path)} bytes of JSON to a temporary directory")
    for spec in matrix:
        r = results[spec.name]
        log(f"[lab] {spec.name}: backend {spec.backend}, final loss {r.final_loss():.6f}, "
            f"{spec.steps / r.walltime_s:.2f} steps/s, wall {r.walltime_s:.2f} s, "
            f"launches {row_launches[spec.name]}")
        if spec.backend == "cuda":
            missing = [k for k in LAB_CUDA_KERNELS if row_launches[spec.name].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"lab: {spec.name} never launched {missing}")
        elif row_launches[spec.name]:
            raise AssertionError(f"lab: {spec.name} ({spec.backend} backend) launched "
                                 f"{row_launches[spec.name]}")
    got = {c.name: c.passed for c in claims}
    for c in claims:
        log(f"[lab] {'PASS' if c.passed else 'FAIL'} {c.name}: {c.detail} (expected "
            f"{'PASS' if LAB_VERDICTS.get(c.name) else 'FAIL'})")
    steps = sum(spec.steps for spec in matrix)
    PHASE_MS["lab"] = sum(r.walltime_s for r in results.values()) * 1e3 / steps
    log(f"[lab] {len(matrix)} rows, {steps} steps in {wall:.1f} s; "
        f"{PHASE_MS['lab']:.1f} ms a step with its probe")
    if got != LAB_VERDICTS:
        differ = sorted(k for k in set(got) | set(LAB_VERDICTS)
                        if got.get(k) != LAB_VERDICTS.get(k))
        raise AssertionError(f"lab: verdicts differ from LAB_VERDICTS on {differ}")
    torch.cuda.empty_cache()


# the zoo's compressed training phases: the train phase's flags at another
# arch and depth, full width, under each config's remat="full" (hymba_1_5b:
# all 32 layers, 0.800 B parameters; xlstm_1_3b: one group, 7 mLSTM + 1
# sLSTM, 0.903 B; seamless_m4t_large_v2: SEAMLESS_LAYERS decoder and as
# many encoder layers over 512 audio frames a row)
SEAMLESS_LAYERS = 24
ZOO_TRAIN = {"train-hymba": ("hymba_1_5b", 32), "train-xlstm": ("xlstm_1_3b", 8),
             "train-seamless": ("seamless_m4t_large_v2", SEAMLESS_LAYERS)}
ZOO_TRAIN_STEPS = 3
# the compressed path's drop of step 0's loss over the dense path's, at
# least: the sketch keeps theta = 0.7 of each bucket's spectrum and error
# feedback carries the rest into the next step, so 3 steps should go most
# of the dense path's way (a gradient of half the batch, or of the wrong
# rows, goes a small part of it; AdamW hides a gradient's scale)
ZOO_DROP_RATIO = 0.5
# a full-width MoE backward pass: mixtral_8x22b at one layer (2.91 B
# parameters) on the dense baseline (--mode pjit: ~46.5 GB of weights, grads
# and AdamW moments); compression would add ~55 GB, more than the card has
MOE_TRAIN_ARGS = ["--arch", "mixtral_8x22b", "--n-layers", "1", "--mode", "pjit",
                  "--batch", "2", "--seq", "256", "--steps", "2"]
# llama3_2_vision_11b at one group (4 self-attention layers and the cross
# layer, 2.14 B parameters) on the dense baseline, batch 2 x 256 tokens over
# 1601 patches a row (~34 GB of weights, grads and AdamW moments;
# compression would not fit, as for train-moe), 2 steps
VISION_LAYERS = 5
VISION_SHAPE = (2, 256)
VISION_STEPS = 2
# the zoo's serving phase: one group of each arch the other phases do not
# run, built on the card, batch x prompt + new tokens
ZOO_ARCHS = ("internlm2_20b", "phi3_medium_14b", "qwen1_5_110b", "mixtral_8x22b",
             "qwen3_moe_235b_a22b")
ZOO_SHAPE = (2, 256, 8)
# a top-k choice may flip between decode and forward only where the router
# nearly ties: forward's k-th over (k+1)-th probability below this.  Their
# MoE inputs part by bf16 rounding, ~1e-2 relative; the router's logits
# (std ~0.02 at init) then move by ~2e-4 and its probabilities by ~2e-4 /
# n_experts
FLIP_MARGIN = 1e-4


def zoo_train_phase(kernels, fused, label: str, arch: str, layers: int) -> None:
    """``label``: 3 compressed_dp EF steps of ``arch`` at ``layers`` layers
    (sequenced, 64 MB buckets, backend and selector auto), B4, B2 and B3
    launched 2, 2 and 1 times a step as in ``train``, the losses finite;
    then the same 3 steps on the dense baseline (``--mode pjit``, the exact
    gradient, no kernel).  Each step draws a fresh batch of a 32k-256k
    token Markov stream, so the step losses need not fall in 3 steps; what
    is held is the loss of step 0's batch: lower under the trained weights
    than at step 0 on both paths, and the compressed path's drop at least
    ``ZOO_DROP_RATIO`` of the dense path's."""
    from repro_torch.data import SyntheticStream
    from repro_torch.launch import train as train_cli

    model_args = ["--arch", arch, "--n-layers", str(layers), "--batch", str(BATCH),
                  "--seq", str(SEQ), "--steps", str(ZOO_TRAIN_STEPS)]
    seen = []

    def run(args):
        def go():
            result = train_cli.main(args)
            model = result["state"]["model"]
            first = SyntheticStream(train_cli.stream_config(model.cfg, SEQ, BATCH, 0),
                                    device=model.embed["table"].device).batch_at(0)
            with torch.no_grad():
                seen.append(float(model.loss(first)[0]))
            return result
        return go

    counts, history = train_phase(run(model_args + TRAIN_ARGS[8:] + SEQUENCED), kernels,
                                  label, fused)
    if {k: counts[k] for k in LAUNCHES_PER_STEP} != {
            k: ZOO_TRAIN_STEPS * v for k, v in LAUNCHES_PER_STEP.items()}:
        raise AssertionError(f"{label} launched {counts} in {ZOO_TRAIN_STEPS} steps, not "
                             f"{ZOO_TRAIN_STEPS} x {LAUNCHES_PER_STEP}")
    _, dense = train_phase(run(model_args), kernels, f"{label}-dense", (),
                           must_not_launch=True)
    (before, dense_before), (after, dense_after) = ((history[0]["loss"], dense[0]["loss"]),
                                                    seen)
    drop, dense_drop = before - after, dense_before - dense_after
    log(f"[{label}] step 0's batch: loss {before:.4f} at step 0, {after:.4f} after "
        f"{ZOO_TRAIN_STEPS} compressed steps (drop {drop:.4f}); dense: {dense_before:.4f} "
        f"-> {dense_after:.4f} (drop {dense_drop:.4f}); compressed over dense "
        f"{drop / dense_drop:.3f} (at least {ZOO_DROP_RATIO})")
    if not (0 < dense_drop and ZOO_DROP_RATIO * dense_drop <= drop):
        raise AssertionError(f"{label}: step 0's loss fell by {drop} compressed and "
                             f"{dense_drop} dense")


def zoo_train_phases(kernels, fused) -> None:
    """Each of ``ZOO_TRAIN`` (``zoo_train_phase``), then ``train-moe``: 2
    dense steps of mixtral at one layer, a finite loss and aux, no kernel
    launched; then ``train-vision``."""
    from repro_torch.launch import train as train_cli

    for label, (arch, layers) in ZOO_TRAIN.items():
        zoo_train_phase(kernels, fused, label, arch, layers)
        torch.cuda.empty_cache()
    _, history = train_phase(lambda: train_cli.main(MOE_TRAIN_ARGS), kernels, "train-moe", (),
                             must_not_launch=True)
    aux = [row["aux"] for row in history]
    if not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"train-moe: aux {aux}")
    log(f"[train-moe] aux (the MoE layer's Switch loss, 1 at uniform routing) {aux}")
    torch.cuda.empty_cache()
    vision_train_phase(kernels)


def vision_train_phase(kernels) -> None:
    """``train-vision``: llama3_2_vision_11b at ``VISION_LAYERS`` layers,
    ``VISION_STEPS`` dense steps through the loop's API as the CLI builds it
    (``--mode pjit``, its stream with 1601 patch embeddings a row).  Its
    ``cross_gate`` starts at zero, so ``tanh(0)`` takes the cross path out of
    the loss: at step 0 every ``cross.*`` gradient is exactly zero and the
    gate's is not; the step moves the gate, and at step 1 every ``cross.*``
    gradient is non-zero.  Read off AdamW's first moment after each step (a
    leaf's is zero exactly while its gradients have been).  No kernel."""
    from repro_torch import configs
    from repro_torch.data import SyntheticStream
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build, registry
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, init_state, train_loop
    from repro_torch.train.step import StepConfig

    dev = torch.device("cuda", 0)
    batch, seq = VISION_SHAPE
    cfg = registry.with_depth(configs.get_config("llama3_2_vision_11b"), VISION_LAYERS)
    seen = []

    def hook(step, metrics, state):
        mu = state["opt"]["mu"]
        seen.append({name: float(m.abs().max()) for name, m in mu.items()
                     if ".cross." in name or name.endswith("cross_gate")})

    def run():
        model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        opt = OptConfig(kind="adamw", lr=3e-4)
        state = init_state(model, opt)
        stream = SyntheticStream(train_cli.stream_config(cfg, seq, batch, 0), device=dev)
        return train_loop(model, opt, StepConfig(mode="pjit"), state, stream,
                          TrainLoopConfig(total_steps=VISION_STEPS, log_every=1,
                                          metrics_hook=hook))

    train_phase(run, kernels, "train-vision", (), must_not_launch=True)
    gate = [k for k in seen[0] if k.endswith("cross_gate")]
    cross = [k for k in seen[0] if ".cross." in k]
    log(f"[train-vision] {cfg.n_layers} layers ({cfg.param_count()} parameters), "
        f"batch {batch} x {seq} tokens over {cfg.n_frontend_tokens} patches; AdamW's first "
        f"moment, max |mu| after each step: "
        + "; ".join(f"step {i}: cross_gate {row[gate[0]]:.3e}, cross.* "
                    f"{min(row[k] for k in cross):.3e}..{max(row[k] for k in cross):.3e}"
                    for i, row in enumerate(seen)))
    if len(seen) != VISION_STEPS or len(cross) != 4 or len(gate) != 1:
        raise AssertionError(f"train-vision: {len(seen)} steps, leaves {gate + cross}")
    if not (seen[0][gate[0]] > 0 and all(seen[0][k] == 0.0 for k in cross)):
        raise AssertionError(f"train-vision: step 0's gradients: {seen[0]}")
    if not all(seen[1][k] > 0 for k in cross):
        raise AssertionError(f"train-vision: a cross.* gradient is zero at step 1: {seen[1]}")


def zoo_serve_phase(dev, counted) -> None:
    """``zoo``: each of ``ZOO_ARCHS`` at full width and one group, built on
    the card from a seed, prefills batch 2 x 256 and decodes 8 tokens
    greedily; ``decode_step``'s logits along them against one ``forward``
    (``SERVE_LOGITS_REL``).  A MoE layer's output is not continuous in its
    input: a token whose experts differ between decode and forward gets
    another output.  Two causes move them: bf16 rounding that differs
    between decode and forward flips a near-tied top-k choice of the
    router (at init its probabilities sit within ~1e-2 of uniform), and
    forward's padded last group (zero tokens, whose tied router picks the
    first experts) fills capacity that decode's one-token groups leave
    free.  For the MoE archs the experts of every decoded position are
    recorded on both sides (``moe_decode_vs_forward``), at the configured
    capacity and at one that drops nothing: the flipped and dropped
    positions are counted and printed; a flip must sit at a near-tie
    (``FLIP_MARGIN``); of the positions not dropped at least half must
    agree (forward's padded group can hold a whole row's decoded
    positions); and the logits are held on the positions that agree.  No
    kernel launches; each model is freed before the next."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    batch, prompt, new = ZOO_SHAPE
    max_seq = prompt + new + 8
    for arch in ZOO_ARCHS:
        for kern in counted:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base = configs.get_config(arch)
        cfg = dataclasses.replace(base, n_layers=len(base.layer_pattern()))
        t0 = time.perf_counter()
        model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(1))
        engine = Engine(model, ServeConfig(max_seq=max_seq, batch=batch))
        engine.generate(prompts, new)  # the card's first launches
        tm = {}
        tokens = engine.generate(prompts, new, timings=tm)
        if cfg.n_experts:
            gaps = {"configured": moe_decode_vs_forward(model, tokens, prompt, max_seq)}
            model.cfg = dataclasses.replace(
                cfg, moe_capacity_factor=cfg.n_experts / cfg.experts_per_token)
            gaps["drop-free"] = moe_decode_vs_forward(model, tokens, prompt, max_seq)
            model.cfg = cfg
        else:
            gaps = {"configured": decode_vs_forward(model, tokens, prompt, max_seq)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {kern.name: kern.launches for kern in counted}
        params = sum(p.numel() for p in model.parameters())
        del model, engine
        torch.cuda.empty_cache()
        if any(launches.values()):
            raise AssertionError(f"zoo {arch} launched kernels: {launches}")
        steps = tm["decode_steps"]
        decode_ms = tm["decode_s"] * 1e3 / steps

        def line(g):
            return (f"{g['rel']:.3e} relative L2, max abs {g['max_abs']:.3e}, argmax agreement "
                    f"{g['agree']:.4f} over {g['positions']} positions")

        PHASE_MS[f"zoo-{arch}"] = decode_ms
        log(f"[zoo] {arch}: {len(cfg.layer_pattern())} layer(s), {params} parameters (built in "
            f"{build_s:.1f} s), batch {batch} x prompt {prompt} + {new} new: prefill "
            f"{tm['prefill_s'] * 1e3:.1f} ms, decode {decode_ms:.2f} ms a step, peak_memory="
            f"{peak_gb:.2f} GB; decode vs forward (limit {SERVE_LOGITS_REL}) " + "; ".join(
                f"{name}: {line(g)}" if "all" not in g else
                f"{name}: {g['flipped']} flipped and {g['dropped']} dropped of "
                f"{g['all']['positions']} positions (forward's k-th over (k+1)-th probability "
                f"at the flipped: {', '.join(f'{m:.2e}' for m in g['margins']) or '-'}), "
                f"where the experts agree {line(g)}, everywhere {line(g['all'])}"
                for name, g in gaps.items()))
        for name, g in gaps.items():
            if "all" in g and (2 * g["positions"] < g["all"]["positions"] - g["dropped"]
                               or not g["positions"]):
                raise AssertionError(f"zoo {arch} {name}: the experts agree at "
                                     f"{g['positions']} of {g['all']['positions']} positions "
                                     f"({g['dropped']} dropped)")
            if "all" in g and any(m >= FLIP_MARGIN for m in g["margins"]):
                raise AssertionError(f"zoo {arch} {name}: a choice flipped at a margin of "
                                     f"{max(g['margins'])}, limit {FLIP_MARGIN}")
            if not math.isfinite(g["rel"]) or g["rel"] > SERVE_LOGITS_REL:
                raise AssertionError(f"zoo {arch} {name}: decode logits {g['rel']:.3e} "
                                     f"(relative L2) from forward's, limit {SERVE_LOGITS_REL}")


# train-tp-kinds: one layer or group of each layer kind whose tensor
# parallelism over "model" the sharded pjit step runs, at full
# width, split over two processes on the one card -- a (1, 2) ("data",
# "model") mesh in a gloo group, since NCCL refuses two ranks on one device --
# against the unsplit layer on rank 0.  Each case: the config's changes
# (depth cut), and rules that differ from DEFAULT_RULES: at model 2 the
# rules would put mixtral's 8 experts over model, so its case unbinds
# "experts", which is where the rules leave it at model 16 (8 experts do not
# divide 16), and its MoE splits over ff; "split": the blocks the plan must
# split, block suffix -> TensorParallel flag
TP_CASES = {
    "qwen3-moe": {"arch": "qwen3_moe_235b_a22b", "changes": {"n_layers": 1},
                  "split": {"l0_attn_moe.attn": "heads", "l0_attn_moe.moe": "experts",
                            "embed": "vocab"}},
    "mixtral-moe": {"arch": "mixtral_8x22b", "changes": {"n_layers": 1},
                    "rules": {"experts": None},
                    "split": {"l0_attn_local_moe.attn": "heads", "l0_attn_local_moe.moe": "ff"}},
    "hymba": {"arch": "hymba_1_5b", "changes": {"n_layers": 1},
              "split": {"l0_hybrid.ssm": "inner"}},
    "xlstm": {"arch": "xlstm_1_3b", "changes": {"n_layers": 8}, "f32": True,
              "split": {"l0_mlstm.cell": "inner", "l7_slstm.cell": "ff"}},
    "seamless": {"arch": "seamless_m4t_large_v2",
                 "changes": {"n_layers": 1, "n_encoder_layers": 1},
                 "split": {"l0_dec_cross_mlp.attn": "heads", "l0_dec_cross_mlp.cross": "heads",
                           "l0_dec_cross_mlp.mlp": "ff", "encoder.attn": "heads",
                           "encoder.mlp": "ff"}},
    "vision": {"arch": "llama3_2_vision_11b",
               "changes": {"n_layers": 1, "cross_attn_period": 1},
               "split": {"l0_cross_attn_mlp.cross": "heads", "l0_cross_attn_mlp.mlp": "ff"}},
}
TP_SHAPE = (2, 256)
# the MoE routers start at 50x their init scale (0.02 / sqrt(d)): at init a
# router is near uniform, and the split sums' bf16 rounding flips its
# near-tied top-k choices (ROADMAP §3 fault 14; qwen3-moe's 128 experts at
# init: 98.9% of the gradient's signs equal, measured on one H100), which moves
# the gradient of the experts those tokens leave and join
TP_ROUTER_SCALE = 50.0
# the CPU tests' tolerances against the port's own unsplit step
# (tests/test_torch_tp_kinds.py): the loss within 1e-3 relative, the
# gradient's norm within 2e-3; and the whole gradient within relative L2 0.1
# with 99% of its signs equal.  A leaf the ranks both hold must have the
# same gradient on both, bit for bit (the stream between blocks is
# replicated bitwise)
TP_LOSS_REL = 1e-3
TP_NORM_REL = 2e-3
TP_GRAD_REL = 0.1
TP_SIGNS = 0.99
# a case marked "f32" (xlstm: one full-width group amplifies rounding,
# ROADMAP §3 fault 11 -- its bf16 gradient is 0.36 relative L2 from its f32
# one, measured on one H100 -- so two bf16 roundings of it part by more than
# the above) also runs in f32: there the split's loss is held to f32
# rounding and its gradient to within a tenth of the distance bf16 rounding
# puts between the unsplit model's gradients (the f32 sums' order alone
# moves it 1.7%); and its bf16 split gradient is held as close to the f32
# unsplit one as the bf16 unsplit gradient is, within a factor of 2 (the
# split rounds each product it reduces twice, its partial sums and then
# their sum, where the unsplit model rounds it once)
TP_F32_LOSS_REL = 1e-5
TP_F32_GRAD_SHARE = 0.1
TP_ACCURACY_RATIO = 2.0


def tp_case_config(case: dict):
    """A ``TP_CASES`` entry's config (``reduced`` first when it says so)."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(case["arch"])
    if case.get("reduced"):
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, **case["changes"])


@contextlib.contextmanager
def compute_dtype(dtype):
    """The LM computing in ``dtype`` in place of bf16: the stream's dtype is
    the embedding's output's, the encoder casts its frames (and a frontend
    arch its memory) to ``transformer.COMPUTE_DTYPE``, and the caches are
    ``init_caches``' default dtype."""
    from repro_torch.models import layers, transformer

    embed_defaults, compute = layers.embed.__defaults__, transformer.COMPUTE_DTYPE
    cache_defaults = transformer.LM.init_caches.__defaults__
    layers.embed.__defaults__ = (dtype,) + embed_defaults[1:]
    transformer.COMPUTE_DTYPE = dtype
    transformer.LM.init_caches.__defaults__ = (dtype,) + cache_defaults[1:]
    try:
        yield
    finally:
        layers.embed.__defaults__, transformer.COMPUTE_DTYPE = embed_defaults, compute
        transformer.LM.init_caches.__defaults__ = cache_defaults


def grad_stats(pairs, dev) -> dict:
    """Sums over (leaf, got, want) pairs, leaf by leaf on ``dev`` in f64:
    the relative L2 of the difference, of the norms, the signs equal where
    ``want`` is non-zero, and the worst leaf."""
    sq_diff = sq_got = sq_want = agree = nonzero = 0.0
    worst = (0.0, "")
    for k, g, w in pairs:
        g, w = g.to(dev).double(), w.to(dev).double()
        d, ww = float(torch.sum(torch.square(g - w))), float(torch.sum(torch.square(w)))
        sq_diff, sq_want = sq_diff + d, sq_want + ww
        sq_got += float(torch.sum(torch.square(g)))
        mask = w != 0
        nonzero += float(mask.sum())
        agree += float((torch.sign(g[mask]) == torch.sign(w[mask])).sum())
        worst = max(worst, ((d / max(ww, 1e-60)) ** 0.5, k))
    return {"grad_rel_l2": (sq_diff / sq_want) ** 0.5,
            "grad_norm_rel": abs((sq_got / sq_want) ** 0.5 - 1.0),
            "signs": agree / nonzero, "worst_leaf": worst[1], "worst_leaf_rel": worst[0]}


def tp_kinds_worker(rank: int, port: int, spec: dict) -> int:
    """One rank of ``train-tp-kinds`` (``spec``: device, shape, cases): for
    each case rank 0 runs the unsplit model's loss and backward, then both
    ranks build it, keep their model-local blocks (``sharding.local_slice``
    under the case's rules for ``{data: 1, model: 2}``) and run the loss and
    backward under ``step._swapped`` with their plan; rank 1 sends its
    gradients' blocks to rank 0 (host tensors: the check's traffic, not the
    port's), which holds them and the loss to the unsplit run's.  A case
    marked ``f32`` also runs both ways computing in f32, where the split is
    held to f32 rounding, and its bf16 split is held to be as close to the
    f32 gradient as the bf16 unsplit one is (``TP_ACCURACY_RATIO``).
    Prints one JSON line a case on rank 0; raises on a failed check."""
    import torch.distributed as dist

    from repro_torch.kernels import all_kernels
    from repro_torch.models import LM, registry
    from repro_torch.models.sharding import DEFAULT_RULES, local_slice, spec_tree_to_pspecs
    from repro_torch.models.tensor_parallel import plan
    from repro_torch.train.step import _swapped

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kernels = all_kernels()
    for kern in kernels:
        kern.launches = 0
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    mesh = {"data": 1, "model": 2}
    failed = []

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else float("nan")

    def reset_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def block(t, pspec, r):
        return t[local_slice(pspec, t.shape, mesh, {"data": 0, "model": r})]

    for name, case in spec["cases"].items():
        cfg = tp_case_config(case)
        batch = registry.make_batch(cfg, *spec["shape"],
                                    generator=torch.Generator(device=dev).manual_seed(1),
                                    device=dev)
        dtypes = ("bf16", "f32") if case.get("f32") else ("bf16",)

        def build():
            model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                for k, p in model.leaves().items():
                    if k.endswith("cross_gate"):  # zero at init: the cross path off
                        p.fill_(CROSS_GATE_OPEN)
                    elif k.endswith(".router"):
                        p.mul_(TP_ROUTER_SCALE)
            return model

        def run(model, tp, dtype):
            """(loss, gradients, ms of the loss and backward: in bf16 the
            second of two, in f32 the one)."""
            leaves = model.leaves()
            with compute_dtype(torch.float32 if dtype == "f32" else torch.bfloat16):
                for _ in range(2 if dtype == "bf16" else 1):
                    for p in leaves.values():
                        p.grad = None
                    sync()
                    t0 = time.perf_counter()
                    with _swapped(model, leaves, tp):
                        loss, _ = model.loss(batch)
                        loss.backward()
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3
            return float(loss.detach()), {k: p.grad.detach() for k, p in leaves.items()}, ms

        full = {}
        if rank == 0:
            reset_peak()
            model = build()
            for dt in dtypes:
                loss, grads, ms = run(model, None, dt)
                full[dt] = (loss, {k: g.cpu() for k, g in grads.items()}, ms)
                del grads
                gb_full = peak_gb() if dt == "bf16" else gb_full
            del model
        dist.barrier()
        model = build()
        specs = model.spec()
        pspecs = spec_tree_to_pspecs(specs, mesh, {**DEFAULT_RULES, **case.get("rules", {})})
        with torch.no_grad():
            for k, p in model.leaves().items():
                p.data = block(p.data, pspecs[k], rank).clone()
        reset_peak()
        tp = plan(pspecs, specs, None, 2, rank)
        unsplit = sorted(k for k, s in pspecs.items() if "model" in s and not tp.splits(k))
        flags = {b: f for b, f in case.get("split", {}).items()
                 if not any(blk.endswith(b) and getattr(t, f) for blk, t in tp.blocks.items())}
        if unsplit or flags:
            raise AssertionError(f"train-tp-kinds {name}: leaves sharded over model in a block "
                                 f"that computes whole {unsplit[:4]}; blocks not split as "
                                 f"expected {flags}")
        split = {}
        for dt in dtypes:
            split[dt] = run(model, tp, dt)
            gb = peak_gb() if dt == "bf16" else gb
        del model
        names = sorted(split["bf16"][1])
        if rank == 1:
            for dt in dtypes:
                loss, grads, ms = split[dt]
                for k in names:
                    dist.send(grads[k].cpu().contiguous(), 0)
                dist.send(torch.tensor([loss, ms, gb], dtype=torch.float64), 0)
            continue
        row = {"case": name, "arch": case["arch"], "params": cfg.param_count(),
               "split_blocks": sorted(b for b, t in tp.blocks.items() if t.split),
               "gb_split": [gb], "gb_unsplit": gb_full}

        def pairs_against(mine, theirs, want):
            """(leaf, got, want) for each block of both ranks; a leaf both
            hold whole once."""
            out = []
            for k in names:
                if "model" in pspecs[k]:
                    out += [(k, mine[k], block(want[k], pspecs[k], 0)),
                            (k, theirs[k], block(want[k], pspecs[k], 1))]
                else:
                    out.append((k, mine[k], want[k]))
            return out

        diverged, received = [], {}
        for dt in dtypes:
            loss, mine, ms = split[dt]
            theirs = {}
            for k in names:
                theirs[k] = torch.empty(mine[k].shape, dtype=mine[k].dtype)
                dist.recv(theirs[k], 1)
            buf = torch.empty(3, dtype=torch.float64)
            dist.recv(buf, 1)
            loss1, ms1, gb1 = buf.tolist()
            received[dt] = theirs
            diverged += [f"{k} ({dt})" for k in names if "model" not in pspecs[k]
                         and not torch.equal(mine[k].cpu(), theirs[k])]
            got = grad_stats(pairs_against(mine, theirs, full[dt][1]), dev)
            got.update(loss=loss, loss_unsplit=full[dt][0], loss_rank1=loss1,
                       loss_rel=abs(loss - full[dt][0]) / abs(full[dt][0]),
                       ms_split=[ms, ms1], ms_unsplit=full[dt][2])
            if dt == "bf16":
                row.update(got)
                row["gb_split"].append(gb1)
                continue
            # the bf16 gradients against the f32 unsplit one: the split's
            # distance over the unsplit's own
            truth = full["f32"][1]
            got["bf16_vs_f32_split"] = grad_stats(pairs_against(
                split["bf16"][1], received["bf16"], truth), dev)["grad_rel_l2"]
            got["bf16_vs_f32_unsplit"] = grad_stats(
                [(k, full["bf16"][1][k], truth[k]) for k in names], dev)["grad_rel_l2"]
            row["f32"] = got
        print("TP_CASE " + json.dumps(row), flush=True)
        if "f32" in row:
            f = row["f32"]
            ok = (f["loss_rel"] <= TP_F32_LOSS_REL and row["loss_rel"] <= TP_LOSS_REL
                  and f["grad_rel_l2"] <= TP_F32_GRAD_SHARE * f["bf16_vs_f32_unsplit"]
                  and f["bf16_vs_f32_split"] <= TP_ACCURACY_RATIO * f["bf16_vs_f32_unsplit"])
        else:
            ok = (row["loss_rel"] <= TP_LOSS_REL and row["grad_norm_rel"] <= TP_NORM_REL
                  and row["grad_rel_l2"] <= TP_GRAD_REL and row["signs"] >= TP_SIGNS)
        if not ok or diverged or row["loss_rank1"] != row["loss"]:
            failed.append(f"{name}: {row}; replicated leaves that differ across ranks "
                          f"{diverged[:4]}")
        del full, split
    launched = {k.name: k.launches for k in kernels if k.launches}
    dist.barrier()
    dist.destroy_process_group()
    if launched or failed:
        raise AssertionError(f"train-tp-kinds: kernels launched {launched}; cases out of "
                             f"tolerance: {failed}")
    return 0


def two_rank_phase(label: str, worker: str, spec: dict, tag: str, env=None) -> list:
    """Two ``chip_smoke.py --worker WORKER`` processes (a gloo group on a
    free localhost port); fails unless both exit with 0.  Returns the JSON
    of rank 0's lines that start with ``tag``."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", worker,
                               str(rank), str(port), json.dumps(spec)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{label}: a worker failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{log[-6000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [json.loads(line[len(tag):]) for line in logs[0].splitlines()
            if line.startswith(tag)]


def tp_kinds_phase(device: str = "cuda:0", cases=None, shape=TP_SHAPE) -> list:
    """``train-tp-kinds``: two ``tp_kinds_worker`` processes on ``device``
    (a gloo group on a free localhost port); fails unless both exit with 0.
    Returns rank 0's rows.  The split times include gloo's staging of every
    collective's CUDA tensors through the host: they are not NCCL's."""
    spec = {"device": device, "shape": list(shape), "cases": cases or TP_CASES}
    t0 = time.perf_counter()
    rows = two_rank_phase("train-tp-kinds", "tp", spec, "TP_CASE ")
    for row in rows:
        log(f"[train-tp-kinds] {row['case']} ({row['arch']}, {row['params']} parameters; "
            f"split: {', '.join(row['split_blocks'])}): loss {row['loss']:.6f} split vs "
            f"{row['loss_unsplit']:.6f} unsplit (rel {row['loss_rel']:.2e}); gradient norm rel "
            f"{row['grad_norm_rel']:.2e}, relative L2 {row['grad_rel_l2']:.3e}, signs "
            f"{row['signs']:.4f}, worst leaf {row['worst_leaf']} {row['worst_leaf_rel']:.3e}; "
            f"loss+backward ms split {row['ms_split'][0]:.1f}/{row['ms_split'][1]:.1f} (gloo "
            f"via the host) vs unsplit {row['ms_unsplit']:.1f}; peak GB split "
            f"{row['gb_split'][0]:.2f}/{row['gb_split'][1]:.2f} vs unsplit "
            f"{row['gb_unsplit']:.2f}")
        if "f32" in row:
            f = row["f32"]
            log(f"[train-tp-kinds] {row['case']} in f32: loss rel {f['loss_rel']:.2e}, gradient "
                f"relative L2 {f['grad_rel_l2']:.3e}, norm rel {f['grad_norm_rel']:.2e}; bf16 "
                f"gradients from the f32 unsplit one: split {f['bf16_vs_f32_split']:.3e}, "
                f"unsplit {f['bf16_vs_f32_unsplit']:.3e}; ms split "
                f"{f['ms_split'][0]:.1f}/{f['ms_split'][1]:.1f} vs unsplit {f['ms_unsplit']:.1f}")
    if len(rows) != len(spec["cases"]):
        raise AssertionError(f"train-tp-kinds: {len(rows)} cases reported of "
                             f"{len(spec['cases'])}")
    log(f"[train-tp-kinds] {len(rows)} cases in {time.perf_counter() - t0:.1f}s")
    return rows


# train-sp: gemma2_2b at full width and depth (13 groups of a local and a
# global layer) under remat="full", batch 2 x 4096 (the model axis, 2,
# divides the sequence), split over two processes on the one card
SP_ARCH = "gemma2_2b"
SP_GROUPS = 13
SP_SHAPE = (2, 4096)


@contextlib.contextmanager
def stream_bytes_saved():
    """Yields ``[n]``: the bytes the checkpoints' input saving packs for the
    stream (a checkpointed group's or encoder layer's second argument), by a
    ``saved_tensors_hooks`` pack hook around each ``torch.utils.checkpoint``
    call of the LM."""
    from repro_torch.models import transformer

    saved = [0]
    checkpoint = transformer.checkpoint

    def counted(fn, *args, **kwargs):
        x = args[1]

        def pack(t):
            if t.data_ptr() == x.data_ptr() and t.shape == x.shape:
                saved[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return checkpoint(fn, *args, **kwargs)

    transformer.checkpoint = counted
    try:
        yield saved
    finally:
        transformer.checkpoint = checkpoint


@contextlib.contextmanager
def replicated_stream():
    """The LM keeping the stream between groups replicated under a plan
    (its sequence-parallel condition never met)."""
    from repro_torch.models import LM

    condition = LM._sequence_parallel
    LM._sequence_parallel = lambda self, s: None
    try:
        yield
    finally:
        LM._sequence_parallel = condition


def sp_worker(rank: int, port: int, spec: dict) -> int:
    """One rank of ``train-sp``: rank 0 runs the unsplit model's loss and
    backward (a warm run, a timed one, then one computing in f32); then both
    ranks keep their model-local blocks and run the loss and backward under
    their plan three times: the stream kept replicated, sequence-parallel,
    and sequence-parallel in f32, each timed and its checkpointed stream
    bytes counted (``stream_bytes_saved``).  Deterministic algorithms are
    on, so the first two are held bitwise on each rank; rank 1 sends its
    sequence-parallel gradients' blocks to rank 0, which holds them and the
    loss to the unsplit run's: the loss, the gradient's norm and relative
    L2 at the ``TP_*`` tolerances, and, as ``train-tp-kinds`` holds its f32
    case, the f32 split to f32 rounding and the bf16 split as close to the
    f32 gradient as the bf16 unsplit one (at full depth bf16 rounding flips
    ~1.5% of the gradient's signs, so the signs are printed, not held).
    Prints one JSON line on rank 0; raises on a failed check."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import all_kernels
    from repro_torch.models import LM, registry
    from repro_torch.models.sharding import local_slice, spec_tree_to_pspecs
    from repro_torch.models.tensor_parallel import plan
    from repro_torch.train.step import _swapped

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    kernels = all_kernels()
    for kern in kernels:
        kern.launches = 0
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    mesh = {"data": 1, "model": 2}
    cfg = configs.get_config(SP_ARCH)
    cfg = dataclasses.replace(registry.with_depth(cfg.reduced() if spec["reduced"] else cfg,
                                                  2 * spec["groups"]), remat="full")
    b, s = spec["shape"]
    batch = registry.make_batch(cfg, b, s, generator=torch.Generator(device=dev).manual_seed(1),
                                device=dev)

    def build():
        return LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))

    def run(model, tp):
        """(loss, gradients, ms, stream bytes saved, peak GB)."""
        leaves = model.leaves()
        for p in leaves.values():
            p.grad = None
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with stream_bytes_saved() as saved, _swapped(model, leaves, tp):
            loss, _ = model.loss(batch)
            loss.backward()
        if cuda:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        grads = {k: p.grad for k, p in leaves.items()}
        for p in leaves.values():
            p.grad = None
        return (float(loss.detach()), grads, ms, saved[0],
                torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else float("nan"))

    def host(grads):
        return {k: g.cpu() for k, g in grads.items()}

    row = {"arch": SP_ARCH, "groups": spec["groups"], "shape": [b, s],
           "params": cfg.param_count(), "width": "reduced" if spec["reduced"] else "full"}
    if rank == 0:
        model = build()
        run(model, None)
        loss_full, grads, ms, saved, gb = run(model, None)
        full = {"bf16": host(grads)}
        del grads
        with compute_dtype(torch.float32):
            loss32, grads, ms32, _, _ = run(model, None)
        full["f32"] = host(grads)
        del grads, model
        row.update(loss_unsplit=loss_full, ms_unsplit=ms, gb_unsplit=gb, saved_unsplit=saved,
                   loss_unsplit_f32=loss32, ms_unsplit_f32=ms32)
    dist.barrier()
    model = build()
    specs = model.spec()
    pspecs = spec_tree_to_pspecs(specs, mesh)
    with torch.no_grad():
        for k, p in model.leaves().items():
            p.data = p.data[local_slice(pspecs[k], p.shape, mesh,
                                        {"data": 0, "model": rank})].clone()
    tp = plan(pspecs, specs, None, 2, rank)
    runs, mine = {}, {}
    # the stream replicated (the bitwise yardstick; rank 1's first pass),
    # sequence-parallel, then sequence-parallel in f32
    for key in ("rep", "sp", "sp_f32"):
        with (replicated_stream() if key == "rep" else
              compute_dtype(torch.float32) if key == "sp_f32" else contextlib.nullcontext()):
            loss, grads, ms, saved, gb = run(model, tp)
        runs[key] = {"loss": loss, "ms": ms, "saved": saved, "gb": gb}
        grads = host(grads)
        if key == "rep":
            want = (loss, grads)
        else:
            mine["f32" if key == "sp_f32" else "bf16"] = grads
        del grads
    bitwise = want[0] == runs["sp"]["loss"] and all(
        torch.equal(g, want[1][k]) for k, g in mine["bf16"].items())
    del model, want
    names = sorted(mine["bf16"])
    fields = {"loss": float, "ms": float, "saved": int, "gb": float}
    failed = []
    if rank == 1:
        for dt in ("bf16", "f32"):
            for k in names:
                dist.send(mine[dt][k].contiguous(), 0)
        dist.send(torch.tensor([runs[k][f] for k in runs for f in fields] + [bitwise],
                               dtype=torch.float64), 0)
    else:
        theirs = {}
        for dt in ("bf16", "f32"):
            theirs[dt] = {}
            for k in names:
                theirs[dt][k] = torch.empty(mine[dt][k].shape, dtype=mine[dt][k].dtype)
                dist.recv(theirs[dt][k], 1)
        buf = torch.empty(len(runs) * len(fields) + 1, dtype=torch.float64)
        dist.recv(buf, 1)
        other = iter(buf.tolist())
        for k in runs:
            for f, cast in fields.items():
                row[f"{k}_{f}"] = [runs[k][f], cast(next(other))]
        row["sp_bitwise"] = [bitwise, bool(next(other))]

        def pairs(dt, want):
            """(leaf, got, want) for each block of both ranks' ``dt`` split
            gradients against the unsplit ``want``; a leaf both hold whole
            once."""
            out = []
            for k in names:
                if "model" in pspecs[k]:
                    for r, got in ((0, mine[dt][k]), (1, theirs[dt][k])):
                        block = local_slice(pspecs[k], want[k].shape, mesh,
                                            {"data": 0, "model": r})
                        out.append((k, got, want[k][block]))
                else:
                    out.append((k, mine[dt][k], want[k]))
            return out

        row.update(grad_stats(pairs("bf16", full["bf16"]), dev))
        row["loss_rel"] = abs(runs["sp"]["loss"] - loss_full) / abs(loss_full)
        row["f32"] = {**grad_stats(pairs("f32", full["f32"]), dev),
                      "loss_rel": abs(runs["sp_f32"]["loss"] - loss32) / abs(loss32),
                      "bf16_vs_f32_split": grad_stats(pairs("bf16", full["f32"]),
                                                      dev)["grad_rel_l2"],
                      "bf16_vs_f32_unsplit": grad_stats(
                          [(k, full["bf16"][k], full["f32"][k]) for k in names],
                          dev)["grad_rel_l2"]}
        row["diverged"] = [k for k in names if "model" not in pspecs[k]
                           and not torch.equal(mine["bf16"][k], theirs["bf16"][k])]
        d, bytes_ = cfg.d_model, 2  # the stream's bf16
        row["saved_want"] = {"sp": spec["groups"] * b * (s // 2) * d * bytes_,
                             "rep": spec["groups"] * b * s * d * bytes_}
        print("SP_CASE " + json.dumps(row), flush=True)
        f = row["f32"]
        if not (row["loss_rel"] <= TP_LOSS_REL and row["grad_norm_rel"] <= TP_NORM_REL
                and row["grad_rel_l2"] <= TP_GRAD_REL):
            failed.append("the split against the unsplit model")
        if not (f["loss_rel"] <= TP_F32_LOSS_REL
                and f["grad_rel_l2"] <= TP_F32_GRAD_SHARE * f["bf16_vs_f32_unsplit"]
                and f["bf16_vs_f32_split"] <= TP_ACCURACY_RATIO * f["bf16_vs_f32_unsplit"]):
            failed.append("the split in f32, or the bf16 split's accuracy against f32")
        if not all(row["sp_bitwise"]):
            failed.append("the sequence-parallel stream against the replicated one (bitwise)")
        if row["sp_loss"][1] != row["sp_loss"][0] or row["diverged"]:
            failed.append("the ranks' losses or replicated leaves")
        if row["sp_saved"] != [row["saved_want"]["sp"]] * 2 or \
                row["rep_saved"] != [row["saved_want"]["rep"]] * 2:
            failed.append("the stream bytes the checkpoints saved")
    launched = {k.name: k.launches for k in kernels if k.launches}
    dist.barrier()
    dist.destroy_process_group()
    if launched or failed:
        raise AssertionError(f"train-sp: kernels launched {launched}; failed: {failed}")
    return 0


def sp_phase(device: str = "cuda:0", groups: int = SP_GROUPS, shape=SP_SHAPE,
             reduced: bool = False) -> dict:
    """``train-sp``: two ``sp_worker`` processes on ``device``, in a gloo
    group whose every collective goes through the host: the split times are
    not NCCL's.  ``reduced`` takes the arch's CPU-test widths.  Returns
    rank 0's row."""
    t0 = time.perf_counter()
    spec = {"device": device, "groups": groups, "shape": list(shape), "reduced": reduced}
    rows = two_rank_phase("train-sp", "sp", spec, "SP_CASE ",
                          env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    if len(rows) != 1:
        raise AssertionError(f"train-sp: {len(rows)} rows reported")
    row = rows[0]
    f = row["f32"]
    log(f"[train-sp] {row['arch']} at {row['width']} width, {row['groups']} groups "
        f"({row['params']} parameters), remat full, batch {row['shape'][0]} x {row['shape'][1]}, "
        f"a (1, 2) (data, model) mesh: loss {row['sp_loss'][0]:.6f} split vs "
        f"{row['loss_unsplit']:.6f} unsplit (rel {row['loss_rel']:.2e}); gradient norm rel "
        f"{row['grad_norm_rel']:.2e}, relative L2 {row['grad_rel_l2']:.3e}, signs "
        f"{row['signs']:.4f} (printed), worst leaf {row['worst_leaf']} "
        f"{row['worst_leaf_rel']:.3e}; sequence-parallel bitwise the replicated stream on both "
        f"ranks: {row['sp_bitwise']}")
    log(f"[train-sp] in f32: loss rel {f['loss_rel']:.2e}, gradient relative L2 "
        f"{f['grad_rel_l2']:.3e}, norm rel {f['grad_norm_rel']:.2e}, signs {f['signs']:.4f}; "
        f"bf16 gradients from the f32 unsplit one: split {f['bf16_vs_f32_split']:.3e}, "
        f"unsplit {f['bf16_vs_f32_unsplit']:.3e}; ms split {row['sp_f32_ms'][0]:.1f}/"
        f"{row['sp_f32_ms'][1]:.1f} vs unsplit {row['ms_unsplit_f32']:.1f}")
    log(f"[train-sp] stream bytes the checkpoints saved a rank: sequence-parallel "
        f"{row['sp_saved']} (want {row['saved_want']['sp']}), replicated {row['rep_saved']} "
        f"(want {row['saved_want']['rep']}), unsplit {row['saved_unsplit']}")
    log(f"[train-sp] loss+backward ms a rank: sequence-parallel {row['sp_ms'][0]:.1f}/"
        f"{row['sp_ms'][1]:.1f}, replicated {row['rep_ms'][0]:.1f}/{row['rep_ms'][1]:.1f} "
        f"(rank 1's first pass; gloo via the host, two processes sharing the card) vs unsplit "
        f"{row['ms_unsplit']:.1f}; peak GB sequence-parallel {row['sp_gb'][0]:.2f}/"
        f"{row['sp_gb'][1]:.2f}, replicated {row['rep_gb'][0]:.2f}/{row['rep_gb'][1]:.2f} vs "
        f"unsplit {row['gb_unsplit']:.2f}; {time.perf_counter() - t0:.1f}s")
    return row


# dryrun-vs-card: the dry-run's trace of the train-dense and train phases'
# configurations (gemma2_2b full width, N_LAYERS layers, BATCH x SEQ, one
# process) on fake cuda tensors, held to the same steps run on the card: the
# matmul flops and the kernels' calls exactly, the traced peak within
# DRYRUN_PEAK_REL of the allocator's
DRYRUN_PEAK_REL = 0.10
# dryrun-production: the cells traced on the production meshes' fake worlds,
# in a process of their own beside the other phases (CPU work: fake tensors
# move no bytes on the card)
DRYRUN_CELLS = [("gemma2_2b", "train_4k", False, "pjit"),
                ("gemma2_2b", "prefill_32k", False, "pjit"),
                ("gemma2_2b", "decode_32k", False, "pjit"),
                ("gemma2_2b", "train_4k", True, "hierarchical"),
                ("qwen1_5_110b", "train_4k", False, "pjit"),
                ("qwen3_moe_235b_a22b", "train_4k", False, "pjit")]
# serve-sharded: two gloo processes on the one card, a (1, 2) ("data",
# "model") mesh; each case's sharded prefill and greedy decode against the
# unsplit model on rank 0 (name -> arch, layers, batch, prompt, new tokens)
SERVE_SHARDED_CASES = {
    "gemma2": ("gemma2_2b", 26, 8, 512, 32),
    "gemma2-batch1": ("gemma2_2b", 26, 1, 512, 16),
    "hymba-layer": ("hymba_1_5b", 1, 8, 512, 32),
    "xlstm-group": ("xlstm_1_3b", 8, 2, 512, 32),
}
SERVE_SHARDED_ATOL = 5e-2
# the f32 pass's tokens (along the bf16 greedy ones)
SERVE_SHARDED_F32_STEPS = 8


def dryrun_card_phase(kernels) -> None:
    """``dryrun-vs-card`` (module constants above)."""
    from repro_torch.analysis.roofline import compute_roofline
    from repro_torch.comms.reducers import ReducerConfig
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import registry

    cfg = registry.with_depth(registry.get_config("gemma2_2b"), N_LAYERS)
    shape = ShapeConfig("train-smoke", SEQ, BATCH, "train")
    main_path = ReducerConfig(kind="fft", theta=KEEP_THETA, error_feedback=True,
                              transport="sequenced", bucket_bytes=BUCKET_MB << 20,
                              backend="auto", selector="auto")
    for label, mode, reducer in (("train-dense", "pjit", None),
                                 ("train", "compressed_dp", main_path)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fake = dryrun.trace_cell(cfg, shape, None, mode=mode, device="cuda", reducer=reducer)
        t_trace = time.perf_counter() - t0
        real = dryrun.trace_cell(cfg, shape, None, mode=mode, device="cuda", reducer=reducer,
                                 fake=False,
                                 generator=torch.Generator(device="cuda").manual_seed(0))
        launched = real["launches"]
        peak = fake["argument"] + fake["temp"]
        terms = compute_roofline(cost={"flops": fake["flops"], "bytes accessed": fake["bytes"]},
                                 collectives={}, chips=1, n_active_params=fake["n_params"],
                                 tokens=fake["tokens"], kind="train")
        log(f"[dryrun-vs-card] {label}: flops traced {fake['flops']} card {real['flops']}; "
            f"kernel calls traced {fake['kernels']} launched {launched}; peak traced "
            f"{peak / 2**30:.3f} GiB (arguments {fake['argument'] / 2**30:.3f}, temp "
            f"{fake['temp'] / 2**30:.3f}) card {real['cuda_peak'] / 2**30:.3f} GiB "
            f"(rel {peak / real['cuda_peak'] - 1:+.4f}); bytes accessed traced "
            f"{fake['bytes']} card {real['bytes']}; roofline step_time_s "
            f"{terms.step_time_s:.6f} ({terms.dominant}) vs measured step "
            f"{real['step_ms']:.1f} ms; trace {t_trace:.1f}s")
        if fake["flops"] != real["flops"] or fake["flops"] <= 0:
            raise AssertionError(f"dryrun-vs-card {label}: flops {fake['flops']} traced, "
                                 f"{real['flops']} on the card")
        want = LAUNCHES_PER_STEP if mode != "pjit" else {}
        if fake["kernels"] != launched or launched != want:
            raise AssertionError(f"dryrun-vs-card {label}: kernel calls {fake['kernels']} "
                                 f"traced, {launched} launched, {want} expected")
        if abs(peak / real["cuda_peak"] - 1) > DRYRUN_PEAK_REL:
            raise AssertionError(f"dryrun-vs-card {label}: traced peak {peak} against the "
                                 f"card's {real['cuda_peak']} (limit {DRYRUN_PEAK_REL:.0%})")
        del fake, real


def dryrun_worker(rank: int, port: int, spec: dict) -> int:
    """The ``dryrun-production`` cells, one after another, each on its
    fake world; prints one ``DRY_CELL`` JSON line a cell."""
    from repro_torch.launch import dryrun

    del rank, port
    for arch, shape, multi_pod, mode in spec["cells"]:
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, multi_pod=multi_pod, mode=mode, device="cuda",
                            out_dir=None, verbose=False)
        r["wall_s"] = time.perf_counter() - t0
        print("DRY_CELL " + json.dumps(r), flush=True)
    return 0


def start_dryrun_production() -> subprocess.Popen:
    """``dryrun-production``'s process, started beside the other phases."""
    spec = {"cells": DRYRUN_CELLS}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", "dry", "0",
                             "0", json.dumps(spec)], env=dict(os.environ, OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_production_phase(proc: subprocess.Popen) -> list:
    """Collect ``dryrun-production``: every cell ``ok``, its memory a rank
    against the card's, its collectives and roofline printed."""
    try:
        out = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"dryrun-production failed (rc {proc.returncode}):\n{out[-6000:]}")
    total = torch.cuda.get_device_properties(0).total_memory
    rows = [json.loads(line[len("DRY_CELL "):]) for line in out.splitlines()
            if line.startswith("DRY_CELL ")]
    for r in rows:
        mem, roof = r["memory"], r["roofline"]
        peak = (mem["argument_size_gib"] + mem["temp_size_gib"]) * 2**30
        coll = {k: (v["count"], v["link_bytes"]) for k, v in r["collectives"].items()}
        log(f"[dryrun-production] {r['arch']} x {r['shape']} "
            f"{'multi' if r['multi_pod'] else 'single'} {r['mode']}: {r['status']}, "
            f"{r['chips']} ranks; memory a rank argument {mem['argument_size_gib']:.3f} GiB, "
            f"temp {mem['temp_size_gib']:.3f}, output {mem['output_size_gib']:.3f}; fits the "
            f"card's {total / 2**30:.2f} GiB: {'yes' if peak <= total else 'no'}; flops "
            f"{r['cost']['flops']:.4e}, bytes {r['cost']['bytes accessed']:.4e}; collectives "
            f"(count, link bytes) {coll}; kernel calls {r['kernel_calls']}; roofline compute "
            f"{roof['compute_s'] * 1e3:.2f} ms, memory {roof['memory_s'] * 1e3:.2f} ms, "
            f"collective {roof['collective_s'] * 1e3:.2f} ms, {roof['dominant']}, useful "
            f"{roof['useful_ratio']:.3f}; trace {r['trace_s']}s, wall {r['wall_s']:.1f}s")
    if len(rows) != len(DRYRUN_CELLS) or any(r["status"] != "ok" for r in rows):
        raise AssertionError(f"dryrun-production: {len(rows)} of {len(DRYRUN_CELLS)} cells "
                             f"reported, statuses {[r['status'] for r in rows]}")
    return rows


def serve_sharded_worker(rank: int, port: int, spec: dict) -> int:
    """One rank of ``serve-sharded``: for each case both ranks build the
    model from one seed (its weights rounded to bf16, the values the
    sharded engine's blocks hold) and serve the prompts on the ``(1, 2)``
    mesh through the engine's prefill and decode steps, greedy (the
    engine's ``generate``, keeping each step's logits), then in f32 along
    the first ``SERVE_SHARDED_F32_STEPS`` of those tokens; rank 0 then runs
    the unsplit model on the same tokens both ways, and its own greedy
    generation, and prints one ``SERVE_CASE`` JSON line a case."""
    import torch.distributed as dist

    from repro_torch.kernels import all_kernels
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM, registry
    from repro_torch.serve import Engine, ServeConfig

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    kernels = all_kernels()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    mesh = make_local_mesh((1, 2), ("data", "model"), device="cpu")

    def cache_bytes(c):
        if isinstance(c, dict):
            return sum(cache_bytes(v) for v in c.values())
        if isinstance(c, tuple):
            return sum(cache_bytes(v) for v in c)
        return sum(t.numel() * t.element_size() for t in vars(c).values()
                   if isinstance(t, torch.Tensor))

    def run(prefill, decode, prompts, steps, forced=None):
        """Prefill and ``steps - 1`` decode steps, greedy or along
        ``forced``'s tokens: (tokens, logits (B, steps, V) f32, caches)."""
        prompt = prompts.shape[1]
        logits, caches = prefill(prompts)
        out, toks = [logits.float()], []
        for i in range(steps):
            tok = (torch.argmax(logits[:, -1], dim=-1)[:, None] if forced is None
                   else forced[:, prompt + i:prompt + i + 1])
            toks.append(tok)
            if i == steps - 1:
                break
            logits, caches = decode(caches, tok, prompt + i)
            out.append(logits.float())
        return torch.cat([prompts] + toks, dim=1), torch.cat(out, dim=1), caches

    for name, (arch, layers, batch, prompt, new) in spec["cases"].items():
        cfg = registry.get_config(arch)
        cfg = registry.with_depth(cfg.reduced() if spec.get("reduced") else cfg, layers)
        model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16).float())
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        max_seq = prompt + new
        f32_steps = min(spec["f32_steps"], new)
        for kern in kernels:
            kern.launches = 0
        engine = Engine(model, ServeConfig(max_seq=max_seq), mesh=mesh)

        def split_prefill(t):
            return engine._prefill({"tokens": t}, global_batch=batch)

        def split_decode(c, t, pos):
            return engine._decode(c, t, pos, global_batch=batch, max_seq=max_seq)

        sync()
        t0 = time.perf_counter()
        toks, split, caches = run(split_prefill, split_decode, prompts, new)
        sync()
        gen_s = time.perf_counter() - t0
        mine = cache_bytes(caches)
        kv = [s[0] if isinstance(s, tuple) else s
              for s in engine.placement.cache_specs(batch, max_seq, None).values()]
        kv_spec = next(([str(a) for a in s.k] for s in kv if hasattr(s, "k")), None)
        del caches
        with compute_dtype(torch.float32):
            _, split32, _ = run(split_prefill, split_decode, prompts, f32_steps, forced=toks)
        del engine
        launched = {k.name: k.launches for k in kernels if k.launches}
        both = torch.tensor([mine], dtype=torch.float64)
        dist.all_reduce(both)
        if rank == 0:
            def whole_prefill(t):
                return model.prefill(t, max_seq=max_seq, last_only=True)

            whole_toks, whole, caches = run(whole_prefill, model.decode_step, prompts, new)
            whole_bytes = cache_bytes(caches)
            del caches
            _, whole, _ = run(whole_prefill, model.decode_step, prompts, new, forced=toks)
            with compute_dtype(torch.float32):
                _, whole32, _ = run(whole_prefill, model.decode_step, prompts, f32_steps,
                                    forced=toks)
            gap = float((split - whole).abs().max())
            head = slice(0, f32_steps)
            row = {"case": name, "arch": arch, "layers": layers, "batch": batch,
                   "prompt": prompt, "new": new, "gap": gap,
                   "gap_f32": float((split32 - whole32).abs().max()),
                   "split_from_f32": float((split[:, head] - whole32).abs().max()),
                   "whole_from_f32": float((whole[:, head] - whole32).abs().max()),
                   "tokens_equal": bool(torch.equal(toks, whole_toks)),
                   "cache_bytes_rank": mine, "cache_bytes_total": float(both),
                   "cache_bytes_whole": whole_bytes, "generate_s": gen_s,
                   "k_spec": kv_spec, "launched": launched}
            if not row["tokens_equal"]:
                # the first differing token; whole[:, j] predicted token prompt + j
                b, t = (toks != whole_toks).nonzero()[0].tolist()
                top2 = torch.topk(whole[b, t - prompt], 2)
                row["diverge"] = {"row": b, "position": t,
                                  "margin": float(top2.values[0] - top2.values[1])}
            print("SERVE_CASE " + json.dumps(row), flush=True)
        del model
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    dist.destroy_process_group()
    return 0


def serve_sharded_phase(device: str = "cuda:0", cases=None, reduced: bool = False) -> list:
    """``serve-sharded``: two ``serve_sharded_worker`` processes on
    ``device`` in a gloo group (every collective through the host).  Each
    case's f32 logits within ``SERVE_SHARDED_ATOL`` of the unsplit model's;
    in bf16 the gap is printed, and the split is held by accuracy: its
    logits no further from the unsplit f32 ones than ``TP_ACCURACY_RATIO``
    times the unsplit bf16 ones are (at 26 layers a logit of ~20 has a bf16
    ulp of 0.125); its greedy tokens equal, or the first divergence at a
    near tie (the unsplit model's top-2 margin there under the bf16 logits
    gap); no kernel launches.  ``reduced`` takes the archs' CPU-test
    widths."""
    spec = {"device": device, "cases": cases or SERVE_SHARDED_CASES, "reduced": reduced,
            "f32_steps": SERVE_SHARDED_F32_STEPS}
    t0 = time.perf_counter()
    rows = two_rank_phase("serve-sharded", "serve", spec, "SERVE_CASE ")
    for row in rows:
        log(f"[serve-sharded] {row['case']} ({row['arch']}, {row['layers']} layers, batch "
            f"{row['batch']} x {row['prompt']} + {row['new']}): logits gap in f32 "
            f"{row['gap_f32']:.3e} (limit {SERVE_SHARDED_ATOL}), in bf16 {row['gap']:.3e}; "
            f"from the unsplit f32 logits: split {row['split_from_f32']:.3e}, unsplit "
            f"{row['whole_from_f32']:.3e}; greedy tokens equal: {row['tokens_equal']}"
            f"{'' if row['tokens_equal'] else ', first divergence ' + json.dumps(row['diverge'])}"
            f"; KV cache placed {row['k_spec']}; cache bytes a rank {row['cache_bytes_rank']}, "
            f"both {row['cache_bytes_total']:.0f}, unsplit {row['cache_bytes_whole']}; sharded "
            f"generate {row['generate_s']:.2f}s (gloo via the host)")
        if (row["gap_f32"] > SERVE_SHARDED_ATOL or row["launched"] or row["split_from_f32"]
                > TP_ACCURACY_RATIO * max(row["whole_from_f32"], SERVE_SHARDED_ATOL)):
            raise AssertionError(f"serve-sharded {row['case']}: {row}")
        if not row["tokens_equal"] and not row["diverge"]["margin"] < row["gap"]:
            raise AssertionError(f"serve-sharded {row['case']}: tokens diverge at "
                                 f"{row['diverge']} above the logits gap {row['gap']}")
    if len(rows) != len(spec["cases"]):
        raise AssertionError(f"serve-sharded: {len(rows)} of {len(spec['cases'])} cases")
    log(f"[serve-sharded] {len(rows)} cases in {time.perf_counter() - t0:.1f}s")
    return rows


# publish-sharded's steps, a publish each
PUBLISH_SHARDED_STEPS = 3


def publish_sharded_phase(dev, kernels) -> None:
    """``publish-sharded``: ``train-fsdp``'s run (``DENSE_ARGS``'s model and
    batch in ``pjit`` with ``fsdp=True`` on a ``(1, 1)`` ``("data",
    "model")`` mesh over a one-rank NCCL group: ``DTensor`` leaves) for
    ``PUBLISH_SHARDED_STEPS`` steps with the CLI's publisher (``--backend
    auto --selector auto``, a theta-0 delta every step, the flags'
    defaults), each leaf gathered whole for the version-0 snapshot and
    every publish; then ``publish-replicated``, the same on the replicated
    state (``train-dense``'s).  B4 and B2 launch once a publish and nothing
    else launches; the two rings are equal file for file (a one-rank mesh's
    gathers move nothing, so the runs compute the same bits, as
    ``train-fsdp`` and ``train-dense`` do); a subscriber that follows the
    sharded ring ends bitwise its publisher's mirror."""
    import dataclasses
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.comms import calibrate
    from repro_torch.data import SyntheticStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import stream_config
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.serve import (PublishConfig, ReplicaSubscriber, RingReader,
                                   WeightDeltaPublisher)
    from repro_torch.train import TrainLoopConfig, init_state, train_loop
    from repro_torch.train.step import StepConfig

    rings, mirrors, steps = {}, {}, PUBLISH_SHARDED_STEPS

    def run(label, sharded):
        cfg = dataclasses.replace(model_config(), n_layers=N_LAYERS)
        model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        opt = OptConfig(kind="adamw", lr=3e-4)
        stream = SyntheticStream(stream_config(cfg, SEQ, BATCH, 0), device=dev)
        step_cfg = StepConfig(mode="pjit", fsdp=sharded)
        rings[label] = tempfile.mkdtemp(prefix="chip-smoke-ring-")

        def go(mesh):
            state = init_state(model, opt, mesh=mesh, step_cfg=step_cfg)
            if sharded and not all(isinstance(v, DTensor) for v in model.leaves().values()):
                raise AssertionError(f"{label}: the state is not DTensor leaves")
            pub = WeightDeltaPublisher(rings[label], model.leaves(),
                                       PublishConfig(backend="auto", selector="auto"))
            result = train_loop(model, opt, step_cfg, state, stream,
                                TrainLoopConfig(total_steps=steps, log_every=1,
                                                publish_hook=pub.hook()), group=mesh)
            pub.close()
            mirrors[label] = pub.state.materialize().cpu()
            _log_publishes(label, pub.timings)
            result["state"] = None
            return result

        if not sharded:
            return go(None)
        with calibrate.process_group(dev):
            return go(make_local_mesh((1, 1), ("data", "model"), device=dev))

    fused = ("sampled_threshold", "fused_compress")
    try:
        for label, sharded in (("publish-sharded", True), ("publish-replicated", False)):
            counts, _ = train_phase(lambda: run(label, sharded), kernels, label, fused)
            launched = {k: v for k, v in counts.items() if v}
            if launched != {name: steps for name in fused}:
                raise AssertionError(f"{label} launched {launched}: B4 and B2 once a publish "
                                     f"({steps}) and nothing else expected")
        got, want = (rings[k] for k in ("publish-sharded", "publish-replicated"))
        manifests = [RingReader(r).manifest() for r in (got, want)]
        if manifests[0] != manifests[1]:
            raise AssertionError(f"publish-sharded: manifests differ {manifests}")

        def same_file(name):
            with open(os.path.join(got, name), "rb") as f, open(os.path.join(want, name),
                                                                "rb") as g:
                return f.read() == g.read()

        files = [manifests[0]["snapshot"]["path"]] + [d["path"] for d in manifests[0]["deltas"]]
        bitwise = [same_file(name) for name in files]
        sub = ReplicaSubscriber(got, device=dev)
        version = sub.follow(timeout_s=60.0)
        followed = torch.equal(sub.weights().cpu(), mirrors["publish-sharded"])
        del sub
        log(f"[publish-sharded] v{version}: the snapshot and {len(files) - 1} deltas bitwise the "
            f"replicated state's {bitwise}; losses {LOSSES['publish-sharded']} vs "
            f"{LOSSES['publish-replicated']}; the subscriber bitwise the mirror: {followed}")
        if not all(bitwise) or version != steps or not followed:
            raise AssertionError(f"publish-sharded: files bitwise {bitwise}; the subscriber "
                                 f"ends at v{version}, bitwise the mirror {followed}")
    finally:
        for ring in rings.values():
            shutil.rmtree(ring, ignore_errors=True)
    torch.cuda.empty_cache()


def zoo_phases(dev, kernels, fused) -> None:
    """Phases 17-19: the zoo's training, its two full-depth serve phases
    and ``zoo``."""
    zoo_train_phases(kernels, fused)
    torch.cuda.empty_cache()
    for label in ("serve-hymba", "serve-xlstm", "serve-seamless", "serve-vision"):
        serve_phase(dev, kernels, label)
    zoo_serve_phase(dev, kernels)


# the phases --only names, run after the kernel phases
ONLY = {"theory", "lab", "zoo", "tp", "publish", "sp", "dry", "serve"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=None,
                    help="kernel-phase rows (default: the main path's)")
    ap.add_argument("--skip-train", action="store_true",
                    help="skip the ops and training phases")
    ap.add_argument("--profile", action="store_true",
                    help="trace the first training phase with torch.profiler")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the kernel phases "
                         "(theory, lab, zoo, tp, publish, sp, dry, serve); default every "
                         "phase")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("PHASE", "RANK", "PORT", "SPEC"),
                    help="run one rank of train-tp-kinds (tp), train-sp (sp) or "
                         "serve-sharded (serve), each of which starts two, or the "
                         "dryrun-production process (dry)")
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
        phase, rank, port, spec = args.worker
        worker = {"tp": tp_kinds_worker, "sp": sp_worker, "serve": serve_sharded_worker,
                  "dry": dryrun_worker}[phase]
        return worker(int(rank), int(port), json.loads(spec))
    only = set(args.only.split(",")) if args.only else None
    if only is not None and not only <= ONLY:
        ap.error(f"--only takes {', '.join(sorted(ONLY))}, got {sorted(only)}")

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
    dry = None
    if not args.skip_train and (only is None or "dry" in only):
        dry = start_dryrun_production()
    if not args.skip_train and only is None:
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
        sharding_phases(dev, kernels, fused)
        two_level_phases(kernels, fused)
        streamed_phases(kernels, fused, main_counts)
        auto_phase(kernels, fused)
        chaos_phase(dev, kernels, fused)
        torch.cuda.empty_cache()
        bytecodec_phase(dev)
        torch.cuda.empty_cache()
        for label in ("serve", "serve-long"):
            serve_phase(dev, kernels, label)
        publish_phases(kernels, fused)
        publish_api_phase(dev, kernels)
    if not args.skip_train:
        if only is None or "theory" in only:
            theory_phase(dev, kernels)
        if only is None or "lab" in only:
            lab_phase(kernels)
        if only is None or "zoo" in only:
            zoo_phases(dev, kernels, tuple(LAUNCHES_PER_STEP))
        if only is None or "tp" in only:
            torch.cuda.empty_cache()
            tp_kinds_phase()
        if only is None or "publish" in only:
            torch.cuda.empty_cache()
            publish_sharded_phase(dev, kernels)
        if only is None or "sp" in only:
            torch.cuda.empty_cache()
            sp_phase()
        if only is None or "dry" in only:
            torch.cuda.empty_cache()
            dryrun_card_phase(kernels)
            dryrun_production_phase(dry)
        if only is None or "serve" in only:
            torch.cuda.empty_cache()
            serve_sharded_phase()

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
    log(smi)  # again beside the numbers: the start of a long log may be cut
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
