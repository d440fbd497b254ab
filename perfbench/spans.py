"""The program's stage spans read from a profiler's events: pure functions.

The port names each stage of its train step with a profiler range
(``repro_torch.tracing.span``: ``step.forward``, ``exchange.fft``,
``optim.update`` ...), nested in the loop's ``train_step`` range, and keeps
counters in memory (``repro_torch.tracing.counters``).  Over the steps of a
profile taken with host ops and tracing on:

* each kernel of a host op goes to the innermost program span open on that
  op's thread when the op began; an op on another thread than the step's
  (the autograd engine's) with no span open on its own thread goes to the
  innermost span open on the step's thread then (``step.backward`` while
  ``loss.backward()`` runs).  A kernel inside ``train_step`` under no span
  is "unspanned".  This is each span's self device time.
* each span's host time is its self time on the step's thread: its length
  less the part its child spans cover (``train_step`` keeps what no span
  covers);
* each idle gap of the device inside a step goes to the innermost span open
  on the step's thread at the gap's start (``train_step`` where none is);
* the CUDA runtime's synchronizing calls inside the steps are counted, each
  beside the innermost program frame of the host op that made it, to hold
  the program's ``host_syncs`` counter against.

The same kernels, gaps and steps as ``trace.Tracer.detail_record`` reads,
so the spans of a stage split its layer's ``layer_ms``.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.trace import STEP_RANGE, is_collective, layer_of

# the program's span names: <layer>.<stage>
SPAN_LAYERS = ("step", "exchange", "optim")
# the CUDA runtime's calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# each per-layer quantity read from the spans, and its span
SPAN_METRICS = {
    "forward_ms": "step.forward", "backward_ms": "step.backward", "guard_ms": "step.guard",
    "clip_ms": "optim.clip", "update_ms": "optim.update",
    "flat_ms": "exchange.flat", "fft_ms": "exchange.fft", "select_ms": "exchange.select",
    "fit_ms": "exchange.fit", "encode_ms": "exchange.encode", "decode_ms": "exchange.decode",
    "gather_ms": "exchange.gather"}
# each per-layer quantity read from the counters (a step), and its counter
COUNTER_METRICS = {"compress_passes": "exchange.compress_passes", "host_syncs": "host_syncs"}
# the exchange's stages, which split exchange_ms (with the gather, the
# transport's NCCL kernels too) with step.exchange's self time
EXCHANGE_STAGES = ("exchange.flat", "exchange.fft", "exchange.select", "exchange.fit",
                   "exchange.encode", "exchange.decode")
# host ops looked back through for the one holding a synchronizing call
_SCAN = 64
_FRAME = re.compile(r"((?:repro_torch|perfbench)/.*)")


def is_span(e) -> bool:
    """A program span: a host range named ``<layer>.<stage>``."""
    return (e.device_type == torch.autograd.DeviceType.CPU
            and bool(getattr(e, "is_user_annotation", False))
            and e.name.split(".", 1)[0] in SPAN_LAYERS and "." in e.name)


class _Innermost:
    """``at(t)``: the innermost of properly nested ranges open at ``t``
    (None where none is), by one bisection over their boundaries."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        self.times, self.names = [], []
        stack: List[Tuple[float, float, str]] = []

        def close_until(t: float) -> None:
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                self.times.append(end)
                self.names.append(stack[-1][2] if stack else None)

        for r in sorted(ranges, key=lambda r: (r[0], -r[1])):
            close_until(r[0])
            stack.append(r)
            self.times.append(r[0])
            self.names.append(r[2])
        close_until(float("inf"))

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None

    def self_times(self, lo: float, hi: float) -> Dict[Optional[str], float]:
        """Length of ``[lo, hi)`` under each innermost range (None: none)."""
        out: Dict[Optional[str], float] = collections.Counter()
        i = bisect.bisect_right(self.times, lo) - 1
        t, name = lo, self.names[i] if i >= 0 else None
        for j in range(i + 1, len(self.times)):
            if self.times[j] >= hi:
                break
            out[name] += self.times[j] - t
            t, name = self.times[j], self.names[j]
        out[name] += hi - t
        return out


def _steps(events):
    return sorted((e.time_range.start, e.time_range.end, e.thread) for e in events
                  if e.name == STEP_RANGE and e.device_type == torch.autograd.DeviceType.CPU)


def _device_spans(events):
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and e.name != STEP_RANGE)


def _frame_of(stack) -> Optional[str]:
    _, frame = layer_of(stack)
    if frame is None:
        return None
    m = _FRAME.search(frame)
    return m.group(1) if m else frame


def span_record(events) -> Dict:
    """Each span's device ms, host ms, launches, idle ms and calls a step,
    the device ms no span covers, and the synchronizing runtime calls a step
    (``trace_syncs``, and by the program frame that made each:
    ``sync_sites``) over the ``train_step`` ranges of ``events``."""
    steps = _steps(events)
    if not steps:
        raise RuntimeError("the events hold no step range")
    starts = [s for s, _, _ in steps]

    def step_of(t: float) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= steps[i][1] else None

    step_thread = steps[0][2]
    by_thread = collections.defaultdict(list)
    calls = collections.Counter()
    for e in events:
        if is_span(e):
            by_thread[e.thread].append((e.time_range.start, e.time_range.end, e.name))
            calls[e.name] += step_of(e.time_range.start) is not None
    inner = {th: _Innermost(r) for th, r in by_thread.items()}
    on_step = inner.get(step_thread) or _Innermost([])

    def span_at(thread, t: float) -> Optional[str]:
        own = inner[thread].at(t) if thread in inner else None
        if own is None and thread != step_thread:
            own = on_step.at(t)
        return own

    device_us = collections.Counter()
    launches = collections.Counter()
    unspanned = 0.0
    syncs: List = []
    ops = collections.defaultdict(list)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or getattr(
                e, "is_user_annotation", False) or e.name == STEP_RANGE:
            continue
        if e.name in SYNC_CALLS:
            if step_of(e.time_range.start) is not None:
                syncs.append(e)
            continue
        if e.stack:
            ops[e.thread].append(e)
        if not e.kernels or step_of(e.time_range.start) is None:
            continue
        name = span_at(e.thread, e.time_range.start)
        for k in e.kernels:
            if name is None:
                unspanned += k.duration
            else:
                device_us[name] += k.duration
                launches[name] += 1

    host_us = collections.Counter()
    for s0, s1, _ in steps:
        for name, t in on_step.self_times(s0, s1).items():
            host_us[STEP_RANGE if name is None else name] += t

    idle_us = collections.Counter()
    device = _device_spans(events)
    for s0, s1, _ in steps:
        reach = s0
        for a, b in [(max(a, s0), min(b, s1)) for a, b in device if a < s1 and b > s0] + [
                (s1, s1)]:
            if a > reach:
                idle_us[on_step.at(reach) or STEP_RANGE] += a - reach
            reach = max(reach, b)

    sites = collections.Counter()
    for th in ops:
        ops[th].sort(key=lambda e: e.time_range.start)
    begun = {th: [e.time_range.start for e in group] for th, group in ops.items()}
    for e in syncs:
        t, group = e.time_range.start, ops.get(e.thread, [])
        i = bisect.bisect_right(begun.get(e.thread, []), t) - 1
        stop = max(-1, i - _SCAN)
        while i > stop and group[i].time_range.end < t:
            i -= 1
        frame = _frame_of(group[i].stack) if i > stop else None
        sites[frame or f"{e.name} outside the program"] += 1

    n = len(steps)
    per = lambda c, scale=1e3: {k: v / scale / n for k, v in sorted(c.items())}
    return {"detail_steps": n,
            "span_ms": per(device_us), "span_host_ms": per(host_us),
            "span_launches": per(launches, 1.0), "span_idle_ms": per(idle_us),
            "span_calls": per(calls, 1.0),
            "unspanned_ms": unspanned / 1e3 / n,
            "trace_syncs": len(syncs) / n, "sync_sites": per(sites, 1.0),
            "step_host_ms": sum(s1 - s0 for s0, s1, _ in steps) / 1e3 / n,
            "step_wait_ms": sum(e.time_range.end - e.time_range.start for e in syncs) / 1e3 / n}


def collective_ms(events) -> float:
    """Device ms of the collectives' (NCCL's) kernels launched inside the
    steps, a step: the part of ``exchange.gather`` (and of ``step.guard``)
    that also waits for the other workers."""
    steps = _steps(events)
    starts = [s for s, _, _ in steps]
    total = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= steps[i][1]:
            total += sum(k.duration for k in e.kernels if is_collective(k.name))
    return total / 1e3 / max(len(steps), 1)


def metric_value(name: str, record: Dict) -> Optional[float]:
    """A span or counter quantity's value in a record that holds ``span_ms``
    and ``counters`` (a step), or None where the record lacks its span or
    counter.  A name split by cells (``gather_ms.x4``) reads its quantity."""
    base = name.split(".", 1)[0]
    if base in SPAN_METRICS:
        value = (record.get("span_ms") or {}).get(SPAN_METRICS[base])
    elif base in COUNTER_METRICS:
        value = (record.get("counters") or {}).get(COUNTER_METRICS[base])
    else:
        raise KeyError(f"no span or counter quantity {name!r}")
    return value if value else None


def spans_line(rec: Dict, counters: Dict, *, wire_bytes: Optional[float] = None,
               workers: int = 1) -> str:
    """The ``[spans]`` line: each span's device ms / host ms / launches /
    idle ms a step, the unspanned device ms, each counter a step, and
    ``host_syncs`` beside the trace's synchronizing calls (a payload's bytes
    x (P - 1) beside the wire's, with more than one worker)."""
    names = sorted(set(rec["span_ms"]) | set(rec["span_host_ms"]) | set(rec["span_idle_ms"]))
    parts = [f"{n} {rec['span_ms'].get(n, 0.0):.3f}/{rec['span_host_ms'].get(n, 0.0):.3f}/"
             f"{rec['span_launches'].get(n, 0.0):g}/{rec['span_idle_ms'].get(n, 0.0):.3f}"
             for n in names]
    out = ("[spans] device/host ms, launches, idle ms a step: " + "; ".join(parts)
           + f"; unspanned {rec['unspanned_ms']:.3f} ms | counters a step: "
           + "; ".join(f"{k} {v:g}" for k, v in sorted(counters.items()))
           + f" | host_syncs {counters.get('host_syncs', 0):g} against the trace's "
           f"{rec['trace_syncs']:g}")
    if wire_bytes and workers > 1:
        payload = counters.get("exchange.payload_bytes", 0.0) * (workers - 1)
        out += f" | payload x (P-1) {payload:.6g} B against the wire's {wire_bytes:.6g} B"
    return out
