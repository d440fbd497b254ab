"""The traced run: ``torch.profiler`` over the window, then a few steps with
Python stacks and the collective recorder.

* The window is profiled on the device alone (host ops are not recorded,
  so the host runs as in an untraced window): it gives the device's busy
  time (the union of its kernels, copies and sets), each kernel's device
  time and launches by its function's name, and the device operations that
  took the most time; the window's length is the host's clock from its
  opening to its closing, each after a synchronize.
* ``extra_steps`` more steps are profiled with host ops and their Python
  stacks (and, with more than one worker, the collective recorder): each
  device kernel goes to the layer of the innermost frame of
  ``src/repro_torch/`` (or of this harness) on the stack of the op that
  launched it -- ``models/`` is the model, ``comms/``, ``core/`` and
  ``kernels/`` the exchange, ``optim/`` the optimizer, ``train/`` "step
  other", the harness's feed "data", the rest of the harness "harness"; an
  op with no such frame (the autograd thread's backward) is the model's;
  a collective's kernel (NCCL's) is the transport's, wherever launched.
  Those steps are the loop's ``train_step`` ranges.  The idle gaps inside
  them are named by the innermost such frame of the host op running when
  each began.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from perfbench import collectives

STEP_RANGE = "train_step"
LAYERS = ("models", "exchange", "transport", "optimizer", "step other", "data", "harness")
_SUBPACKAGE_LAYER = {"models": "models", "comms": "exchange", "core": "exchange",
                     "kernels": "exchange", "optim": "optimizer", "train": "step other",
                     "data": "data"}
# a device op's name in the breakdown is cut to this many characters
NAME_CHARS = 160
# the detailed steps' device work a step may differ from the window's by this share
# before they run again (the profiler can drop records when it records stacks)
DETAIL_TOLERANCE = 0.03
DETAIL_ATTEMPTS = 3
# the longest gaps a detailed run names
GAPS_NAMED = 400
# host ops looked back through for the one running at a gap's start
HOST_SCAN = 4000
_FRAME = re.compile(r"(repro_torch|perfbench)/([^/(]+)")
_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")  # the CUDA runtime's and driver's calls


# Frozen copy of chip_smoke.py's _busy_us at commit 9055aa7.
def _busy_us(spans, start: float, end: float) -> float:
    """Length of the union of ``spans`` (device intervals, us) inside
    ``[start, end)``."""
    busy, reach = 0.0, start
    for s0, s1 in sorted((max(a, start), min(b, end)) for a, b in spans if a < end and b > start):
        if s1 > reach:
            busy += s1 - max(s0, reach)
            reach = s1
    return busy


def layer_of(stack) -> Tuple[str, Optional[str]]:
    """(layer, innermost frame of the program or the harness) of an op's
    stack, innermost frame first."""
    for frame in stack or ():
        m = _FRAME.search(frame)
        if not m or m.group(2) == "collectives.py":  # the recorder's dispatch is no layer
            continue
        if m.group(1) == "perfbench":
            return ("data" if m.group(2) == "feed.py" else "harness"), frame
        sub = m.group(2)
        return _SUBPACKAGE_LAYER.get(sub, "step other"), frame
    return "models", None


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name == STEP_RANGE


def _profile(with_stack: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if with_stack:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    kw = {}
    if with_stack:
        try:  # per-op Python stacks need the verbose experimental config
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(verbose=True)
        except (AttributeError, TypeError):
            pass
    return torch.profiler.profile(activities=acts, with_stack=with_stack, **kw)


def _steps(events) -> List[Tuple[float, float]]:
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == STEP_RANGE and not _is_device(e))


def kernel_name(name: str) -> str:
    """A kernel's function name: its demangled name without the return
    type, the template arguments and the parameters."""
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    if head.startswith("void "):
        head = head[len("void "):]
    return head.rsplit("::", 1)[-1].strip() or name


def is_collective(kernel: str) -> bool:
    """A collective's kernel (NCCL's): the transport layer's."""
    return kernel_name(kernel).startswith("nccl")


def _device_spans(events) -> List[Tuple[float, float, str]]:
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if _is_device(e) and not _annotation(e)]


def _within(steps):
    """``t -> whether t lies in one of the sorted, disjoint ``steps``."""
    starts = [a for a, _ in steps]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= steps[i][1]

    return inside


class Tracer:
    """Told by the window when it opens and closes; profiles as above."""

    def __init__(self, extra_steps: int = 2, record_collectives: bool = False):
        self.extra_steps = extra_steps
        self.record_collectives = record_collectives
        self.window_prof = None
        self.detail_prof = None
        self.recorder = None
        self.window_rec = None
        self.detail_rec = None
        self.attempts = 0

    def open(self) -> None:
        self.window_prof = _profile(with_stack=False)
        self.window_prof.start()
        self._t_open = time.perf_counter()

    def close(self, steps: int) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t_open
        self.window_prof.stop()
        self.window_rec = self.window_record()
        self.window_rec["steps"] = steps

    def detail(self) -> None:
        self.detail_prof = _profile(with_stack=True)
        self.detail_prof.start()
        if self.record_collectives:
            self.recorder = collectives.CollectiveRecorder()
            self.recorder.__enter__()

    def finish(self) -> bool:
        """Ends the detailed steps; True when they should run again: their
        device work a step is off the window's by more than
        ``DETAIL_TOLERANCE`` (the profiler dropped records under the load of
        the stacks), at most ``DETAIL_ATTEMPTS`` times."""
        torch.cuda.synchronize()
        if self.recorder is not None:
            self.recorder.__exit__(None, None, None)
        self.detail_prof.stop()
        self.detail_rec = self.detail_record()
        self.recorder = None
        self.attempts += 1
        # the work but the collectives' (whose kernels also wait for the other
        # workers, longer while stacks slow the hosts unevenly)
        waits = sum(t for k, t in self.window_rec.get("kernel_device_s", {}).items()
                    if is_collective(k))
        per_step = 1e3 * (self.window_rec["busy_s"] - waits) / max(self.window_rec["steps"], 1)
        layers = self.detail_rec["layer_ms"]
        work = sum(layers.values()) - layers["transport"]
        off = abs(work - per_step) / per_step
        print(f"[trace] detailed steps' device work but collectives {work:.3f} ms a step "
              f"against the window's {per_step:.3f} (attempt {self.attempts})",
              file=sys.stderr, flush=True)
        return off > DETAIL_TOLERANCE and self.attempts < DETAIL_ATTEMPTS

    # ---- reading -------------------------------------------------------

    def window_record(self) -> Dict:
        spans = _device_spans(self.window_prof.events())
        if not spans:
            raise RuntimeError("the traced window holds no device activity")
        busy = _busy_us([(a, b) for a, b, _ in spans], min(a for a, _, _ in spans),
                        max(b for _, b, _ in spans))
        by_name = collections.Counter()
        kernels = collections.defaultdict(lambda: [0.0, 0])
        for a, b, name in spans:
            by_name[name] += b - a
            k = kernels[kernel_name(name)]
            k[0] += (b - a) / 1e6
            k[1] += 1
        return {"window_s": self.window_s, "busy_s": busy / 1e6,
                "device_ops": [[n[:NAME_CHARS], t / 1e6] for n, t in by_name.most_common(10)],
                "kernel_device_s": {k: v[0] for k, v in kernels.items()},
                "kernel_calls": {k: v[1] for k, v in kernels.items()}}

    def detail_record(self) -> Dict:
        events = self.detail_prof.events()
        steps = _steps(events)
        if not steps:
            raise RuntimeError("the detailed steps hold no step range")
        layer_us = collections.Counter({name: 0.0 for name in LAYERS})
        stacked = 0
        cpu = []
        inside = _within(steps)
        for e in events:
            if _is_device(e) or _annotation(e):
                continue
            cpu.append(e)
            if not e.kernels or not inside(e.time_range.start):
                continue
            stacked += bool(e.stack)
            layer, _ = layer_of(e.stack)
            for k in e.kernels:
                layer_us["transport" if is_collective(k.name) else layer] += k.duration
        spans = _device_spans(events)
        busy = sum(_busy_us([(a, b) for a, b, _ in spans], s0, s1) for s0, s1 in steps)
        found = []
        for s0, s1 in steps:
            within = sorted((max(a, s0), min(b, s1)) for a, b, _ in spans if a < s1 and b > s0)
            reach = s0
            for a, b in within + [(s1, s1)]:
                if a > reach:
                    found.append((a - reach, reach))
                reach = max(reach, b)
        # the host ops that name a gap: with a Python stack first (any thread:
        # the autograd thread's recompute), then any other but the CUDA
        # runtime's calls (the backward's ops)
        ops = [e for e in cpu if not _RUNTIME.match(e.name)]
        named = [sorted((e for e in ops if e.stack), key=lambda e: e.time_range.start),
                 sorted((e for e in ops if not e.stack), key=lambda e: e.time_range.start)]
        starts = [[e.time_range.start for e in group] for group in named]
        gaps = collections.Counter()
        for length, at in sorted(found, reverse=True)[:GAPS_NAMED]:
            gaps[self._host_at(named, starts, at)] += length
        n = len(steps)
        out = {"detail_steps": n, "stacks_seen": stacked,
               "layer_ms": {k: v / 1e3 / n for k, v in layer_us.items()},
               "detail_busy_ms": busy / 1e3 / n,
               "idle_gaps": [[name, t / 1e6] for name, t in gaps.most_common(10)]}
        if self.recorder is not None:
            link = sum(r_.link_bytes for r_ in self.recorder.stats().values())
            out["wire_bytes_per_step"] = link / n
        return out

    @staticmethod
    def _host_at(named, starts, t: float) -> str:
        """What the host was doing at ``t``: the innermost frame of the
        program or the harness on the stack of the innermost op running then
        (of the ops begun by ``t``, the latest begun that has not ended),
        else that op's name ("backward: ..." for an op without a stack),
        else "no host op"."""
        for group, begun in zip(named, starts):
            i = bisect.bisect_right(begun, t) - 1
            stop = max(-1, i - HOST_SCAN)
            while i > stop and group[i].time_range.end < t:
                i -= 1
            if i <= stop:
                continue
            e = group[i]
            if not e.stack:
                return f"backward: {e.name}"
            _, frame = layer_of(e.stack)
            if frame is None:
                return e.name
            m = re.search(r"((?:repro_torch|perfbench)/.*)", frame)
            return m.group(1) if m else frame
        return "no host op"
