"""A cell's step split by the program's stage spans (not part of a benchmark
run).

Runs the cell as a traced run does (set-up, a window profiled on the device
alone), then ``2 x passes`` detailed passes of ``bench.DETAIL_STEPS`` steps,
each profiled with host ops and stacks, the program's tracing
(``repro_torch.tracing``) off and on in turns.  Each pass prints the
``[layers]`` line of ``trace.Tracer`` and, with tracing on, the ``[spans]``
line of ``spans.spans_line``, the synchronizing calls by site, each span and
counter quantity as a per-layer metric would read it, and the stage sums
against their layers and the counters against the trace; the last line is
tracing's cost: the
detailed steps' host ms with tracing on against off, the spans a step,
and one span and one counter call with tracing off and on, timed on this
host.

    python3 perfbench/tools/span_split.py --workload phi3m-l3.cdp.b4s512 --seed 7 \\
        [--seconds 4] [--passes 2] [--out build/spans]

Needs the cell's CUDA devices (one worker process a device above one).
Writes ``<out>/<workload>.json``: the window's record and every pass's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import timeit

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if HERE in sys.path:
    sys.path.remove(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from perfbench import bench, program, spans, spec, trace  # noqa: E402

RESULT = "SPAN_SPLIT_RESULT "


class SpanTracer(trace.Tracer):
    """The benchmark's tracer, whose detailed passes alternate the program's
    tracing off and on and read the spans of each pass."""

    def __init__(self, passes: int, **kw):
        super().__init__(**kw)
        self.modes = ["off", "on"] * passes
        self.passes = []

    def detail(self) -> None:
        from repro_torch import tracing

        tracing.reset()
        tracing.enable(self.modes[len(self.passes)] == "on")
        super().detail()

    def finish(self) -> bool:
        from repro_torch import tracing

        super().finish()
        counters = tracing.counters()
        tracing.enable(False)
        events = self.detail_prof.events()
        rec = spans.span_record(events)
        n = rec["detail_steps"]
        rec.update(tracing=self.modes[len(self.passes)],
                   counters={k: v / n for k, v in counters.items()},
                   layer_ms=self.detail_rec["layer_ms"],
                   detail_busy_ms=self.detail_rec["detail_busy_ms"],
                   wire_bytes_per_step=self.detail_rec.get("wire_bytes_per_step"),
                   collective_ms=spans.collective_ms(events))
        self.passes.append(rec)
        return len(self.passes) < len(self.modes)


def span_cost_ns() -> dict:
    """ns a call on this host: a span and a counter with tracing off, and a
    span with tracing on, alone and under a CPU profiler recording stacks
    (the medians of 5 repeats)."""
    from repro_torch import tracing

    glb = {"tracing": tracing}
    span = "with tracing.span('step.forward'):\n    pass"

    def ns(stmt: str, number: int) -> float:
        return 1e9 * statistics.median(timeit.repeat(stmt, globals=glb, number=number,
                                                     repeat=5)) / number

    tracing.enable(False)
    out = {"span_off": ns(span, 1_000_000), "count_off": ns("tracing.count('x')", 1_000_000)}
    tracing.enable(True)
    try:
        out["span_on"] = ns(span, 20_000)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    with_stack=True):
            out["span_on_profiled"] = ns(span, 20_000)
    finally:
        tracing.enable(False)
    return out


def sums(rec: dict, workers: int) -> dict:
    """Each stage sum beside the layer it splits, and the checks of the
    counters, in one pass's record (tracing on)."""
    s, layers = rec["span_ms"], rec["layer_ms"]
    stages = sum(s.get(k, 0.0) for k in spans.EXCHANGE_STAGES) + s.get("step.exchange", 0.0)
    exchange = layers.get("exchange", 0.0)
    if workers > 1:
        stages += s.get("exchange.gather", 0.0)
        exchange += layers.get("transport", 0.0)
    work = sum(layers.values())
    out = {"exchange_stages_ms": stages, "exchange_layer_ms": exchange,
           "optim_stages_ms": s.get("optim.clip", 0.0) + s.get("optim.update", 0.0),
           "optim_layer_ms": layers.get("optimizer", 0.0),
           "model_stages_ms": s.get("step.forward", 0.0) + s.get("step.backward", 0.0),
           "model_layer_ms": layers.get("models", 0.0),
           "step_other_layer_ms": layers.get("step other", 0.0),
           "unspanned_share": rec["unspanned_ms"] / work if work else None,
           "host_syncs": rec["counters"].get("host_syncs"), "trace_syncs": rec["trace_syncs"],
           "nccl_ms": rec["collective_ms"]}
    wire = rec.get("wire_bytes_per_step")
    if wire and workers > 1:
        out["payload_x_p_minus_1"] = rec["counters"].get("exchange.payload_bytes", 0.0) * (
            workers - 1)
        out["wire_bytes"] = wire
    return out


def run(cell, seed: int, seconds: float, passes: int, world: int, device) -> dict:
    """The window and the passes."""
    tracer = SpanTracer(passes, extra_steps=bench.DETAIL_STEPS, record_collectives=world > 1)
    out = program.run(cell, seed, seconds, device, tracer=tracer)
    win = dict(tracer.window_rec)
    win.pop("device_ops", None)
    return {"window": win, "window_steps": out["window"].steps, "passes": tracer.passes}


def report(cell, result: dict, log) -> dict:
    workers = cell.chips
    win = result["window"]
    nccl = sum(t for k, t in win["kernel_device_s"].items() if trace.is_collective(k))
    log(f"[window] {result['window_steps']} steps in {win['window_s']:.3f} s, idle "
        f"{100 * (1 - win['busy_s'] / win['window_s']):.2f}%, NCCL's kernels "
        f"{1e3 * nccl / max(result['window_steps'], 1):.3f} ms a step")
    for i, rec in enumerate(result["passes"]):
        layers = rec["layer_ms"]
        log(f"[layers] pass {i} (tracing {rec['tracing']}): " + " + ".join(
            f"{k} {v:.3f}" for k, v in layers.items()) + f" ms; step host "
            f"{rec['step_host_ms']:.3f} ms, of it waiting in sync calls {rec['step_wait_ms']:.3f}")
        if rec["tracing"] == "on":
            log(spans.spans_line(rec, rec["counters"], wire_bytes=rec.get("wire_bytes_per_step"),
                                 workers=workers))
            log(f"[sync sites] pass {i}: {json.dumps(rec['sync_sites'])}")
            quantities = {q: spans.metric_value(q, rec) for q in (
                *spans.SPAN_METRICS, *spans.COUNTER_METRICS)}
            log(f"[quantities] pass {i}: {json.dumps(quantities)}")
            log(f"[sums] pass {i}: {json.dumps(sums(rec, workers))}")
    by = {m: [r for r in result["passes"] if r["tracing"] == m] for m in ("off", "on")}
    cost = {}
    for m, recs in by.items():
        cost[f"step_host_ms_{m}"] = statistics.median(r["step_host_ms"] for r in recs)
        cost[f"host_work_ms_{m}"] = statistics.median(
            r["step_host_ms"] - r["step_wait_ms"] for r in recs)
    cost["ns_a_call"] = span_cost_ns()
    cost["spans_a_step"] = sum(by["on"][0]["span_calls"].values()) if by["on"] else None
    log(f"[cost] {json.dumps(cost)}")
    result["cost"] = cost
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's step split by the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out", default=os.path.join("build", "spans"))
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    bench.set_cache_dirs()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        bench.log(f"[span_split] {args.workload} needs {cell.chips} CUDA device(s)")
        return 2
    if args.worker is not None:
        import torch.distributed as dist

        rank = args.worker
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{args.port}", rank=rank,
                                world_size=cell.chips, device_id=device)
        result = run(cell, args.seed, args.seconds, args.passes, cell.chips, device)
        dist.destroy_process_group()
        if rank == 0:
            print(RESULT + json.dumps(result), flush=True)
        return 0
    bench.prebuild_kernels(cell)
    if cell.chips == 1:
        result = run(cell, args.seed, args.seconds, args.passes, 1, torch.device("cuda", 0))
    else:
        port = _free_port()
        env = dict(os.environ, NCCL_SHM_DISABLE="1")
        base = [sys.executable, os.path.abspath(__file__)] + [
            a for a in (argv if argv is not None else sys.argv[1:])]
        procs = [subprocess.Popen(base + ["--worker", str(r), "--port", str(port)], env=env,
                                  stdout=subprocess.PIPE if r == 0 else sys.stderr, text=True)
                 for r in range(cell.chips)]
        result = None
        for line in procs[0].stdout:
            if line.startswith(RESULT):
                result = json.loads(line[len(RESULT):])
            else:
                sys.stderr.write(line)
        codes = [p.wait() for p in procs]
        if any(codes) or result is None:
            bench.log(f"[span_split] worker exit codes {codes}")
            return 1
    result = report(cell, result, bench.log)
    result["card"] = bench.power_limit()
    bench.log(f"[span_split] card {result['card']}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
