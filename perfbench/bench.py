"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result's line (see ``run.py`` for the command).

A one-chip cell runs in this process.  A cell on more chips starts one
worker process a card (``--worker``), rank 0's pipe carrying its result
back; the workers meet over NCCL at a free ``localhost`` port.  The parent
builds the kernels first, so the workers find them built.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from perfbench import check, spec
from perfbench.peaks import BF16_FLOPS_PER_S

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RESULT = "PERFBENCH_RESULT "
# the traced run profiles at most this long a window (its events are read in Python)
TRACE_WINDOW_S = 8.0
# steps profiled with stacks after the traced window
DETAIL_STEPS = 2


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(spec.ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def prebuild_kernels(cell) -> float:
    """Build the port's kernel libraries that are missing (all at once);
    the seconds it took (0 when all were built)."""
    if cell.traffic.mode == "pjit":
        return 0.0
    from repro_torch.kernels import all_kernels
    from repro_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    built = kbuild.build([k.source for k in all_kernels()])
    return time.perf_counter() - t0 if built else 0.0


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def flops_per_step(cell, arch: Optional[Dict] = None) -> float:
    a = cell.config.arch if arch is None else arch
    return cell.traffic.workers * cell.config.flops(a, cell.traffic.rows, cell.traffic.seq,
                                                     cell.frames())


def reference_readings(cell, seed: int, device, *, arch: Optional[Dict] = None,
                       state_dtype=torch.float32, fault: Optional[str] = None) -> Dict:
    from perfbench import program
    from perfbench.reference import train as ref_train

    feed = program.make_feed(cell, seed, device, arch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref_train.run(cell.config.reference(), cell.config.arch if arch is None else arch,
                         cell.traffic.data, seed, feed, workers=cell.traffic.workers,
                         steps=cell.traffic.warmup_steps, device=device, state_dtype=state_dtype,
                         fault=fault)


def compare(cell, prog_readings: Dict, ref: Dict) -> Dict:
    nums = check.numbers(prog_readings, ref)
    limits = cell.limits
    for k in sorted(set(nums) - set(check.compared(limits))):
        log(f"[check] {k} {nums[k]!r} read, not compared "
            f"(no upper reading: limits/{cell.name}.json)")
    return {"correct": check.verdict(nums, limits),
            "checks": {k: {"value": nums[k], "limit": limits[k]["limit"]}
                       for k in check.compared(limits)}}


def per_layer(cell, record: Dict) -> Dict:
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _gather(obj, world: int):
    import torch.distributed as dist

    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def worker(cell, seed: int, seconds: float, trace: bool, rank: int, world: int, device,
           t_start: float, *, arch=None) -> Optional[Dict]:
    """Set-up, window, reference, comparison: rank 0 returns the result."""
    from perfbench import program
    from perfbench.trace import Tracer

    tracer = Tracer(DETAIL_STEPS, record_collectives=world > 1) if trace else None
    window_s = min(seconds, TRACE_WINDOW_S) if trace else seconds
    out = program.run(cell, seed, window_s, device, tracer=tracer, arch=arch)
    win = out["window"]
    if rank == 0:
        marks, last = [], t_start
        for stage, t in out["stages"].items():
            marks.append(f"{stage} +{t - last:.2f}")
            last = t
        log(f"[setup] {', '.join(marks)} s")
    if rank == 0 and win.marks:
        ms = sorted(win.step_ms())
        log(f"[window] {win.steps} steps in {win.seconds:.3f} s; a step's ms on the host's clock: "
            f"min {ms[0]:.1f} median {statistics.median(ms):.1f} max {ms[-1]:.1f}")
    local = {"peak": out["peak_bytes"], "t_open": win.t_open,
             "failed": win.skipped + out["feed_retries"]}
    if tracer is not None:
        local["window"], local["detail"] = tracer.window_rec, tracer.detail_rec
    everyone = _gather(local, world)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return None
    peak = max(x["peak"] for x in everyone)
    failed = max(x["failed"] for x in everyone)
    a = None if arch is None else dataclasses.asdict(arch)
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device, arch=a)
    log(f"[reference] {cell.traffic.warmup_steps} steps of {cell.traffic.workers} worker(s) in "
        f"{time.perf_counter() - t_ref:.1f} s (the window: {win.seconds:.1f} s)")
    verdict = compare(cell, out["readings"].__dict__, ref)
    result = {"correct": verdict["correct"], "attempted": win.steps, "failed": failed}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": world, "memory_peak_bytes": int(peak)}
    if not trace:
        values = {"tokens_per_s": win.steps * cell.tokens_per_step() / win.seconds,
                  "peak_mem_gib": peak / 2 ** 30,
                  "setup_s": max(x["t_open"] for x in everyone) - t_start}
        # a quantity split by cells (tokens_per_s.x4) is its quantity's value
        result["metrics"] = {m["name"]: {"value": values[m["name"].split(".")[0]],
                                         "unit": m["unit"]} for m in cell.end_to_end}
    else:
        w0, d0 = everyone[0]["window"], everyone[0]["detail"]
        busy = statistics.mean(x["window"]["busy_s"] for x in everyone)
        record = {"chips": world, "window_steps": win.steps, "window_s": w0["window_s"],
                  "busy_s": busy, "kernel_device_s": w0["kernel_device_s"],
                  "kernel_calls": w0["kernel_calls"], "layer_ms": d0["layer_ms"],
                  "wire_bytes_per_step": d0.get("wire_bytes_per_step"),
                  "flops_per_step": flops_per_step(cell, a),
                  "peak_flops": BF16_FLOPS_PER_S,
                  "n_params": sum(math.prod(s) for s in out["readings"].shapes.values()),
                  "theta": (cell.traffic.data.get("reducer") or {}).get("theta")}
        layers = d0["layer_ms"]
        log("[layers] " + " + ".join(f"{k} {v:.3f}" for k, v in layers.items())
            + f" = {sum(layers.values()):.3f} ms a step; device busy "
            f"{d0['detail_busy_ms']:.3f} ms a step ({d0['detail_steps']} steps traced with "
            f"stacks, {d0['stacks_seen']} ops with a stack)")
        result["metrics"] = per_layer(cell, record)
        dev.update(busy_s=busy, window_s=w0["window_s"])
        result["breakdown"] = {"device_ops": w0["device_ops"], "idle_gaps": d0["idle_gaps"]}
    result["device"] = dev
    result["checks"] = verdict["checks"]
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args, cell, t_start: float) -> Optional[Dict]:
    """One worker process a chip; rank 0's result."""
    port = _free_port()
    env = dict(os.environ, NCCL_SHM_DISABLE="1")
    base = [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
            str(args.trace), "--port", str(port), "--t-start", repr(t_start)]
    procs = []
    for r in range(cell.chips):
        procs.append(subprocess.Popen(base + ["--worker", str(r)], env=env,
                                      stdout=subprocess.PIPE if r == 0 else sys.stderr,
                                      text=True))
    result = None
    for line in procs[0].stdout:
        if line.startswith(RESULT):
            result = json.loads(line[len(RESULT):])
        else:
            sys.stderr.write(line)
    codes = [p.wait() for p in procs]
    if any(codes):
        log(f"[perfbench] worker exit codes {codes}")
        return None
    return result


def run_worker_process(args, cell) -> int:
    import torch.distributed as dist

    rank, world = args.worker, cell.chips
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{args.port}", rank=rank,
                            world_size=world, device_id=device)
    result = worker(cell, args.seed, args.seconds, bool(args.trace), rank, world, device,
                    args.t_start)
    if rank == 0:
        bad = forbidden_modules()
        if bad:
            log(f"[perfbench] the worker loaded {bad}")
            return 3
        print(RESULT + json.dumps(result), flush=True)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parser().parse_args(argv)
    t_start = args.t_start if args.t_start is not None else (t_start or time.time())
    cell = spec.load_cell(args.workload)
    set_cache_dirs()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[perfbench] {args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    if args.worker is not None:
        return run_worker_process(args, cell)
    built = prebuild_kernels(cell)
    if built:
        log(f"[perfbench] built the kernels in {built:.1f} s")
    card = power_limit()
    if cell.chips == 1:
        result = worker(cell, args.seed, args.seconds, bool(args.trace), 0, 1,
                        torch.device("cuda", 0), t_start)
    else:
        result = spawn(args, cell, t_start)
    if result is None:
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"[perfbench] the run loaded {bad}: the benchmark measures the port alone")
        return 3
    result["device"]["card"] = card
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
