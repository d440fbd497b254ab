"""The system under test: the port's training step, built as its training
CLI (``repro_torch.launch.train.main``) builds it, driven by
``repro_torch.train.train_loop`` on the harness's rows and weights.

Set-up builds ONE model, state and step, fills the weights from the seed,
and runs the traffic's first steps (``warmup_steps``) through the loop's own
call and the harness's feed; the loop's metrics hook reads what the
comparison needs from those steps (each loss, the first gradient as AdamW's
first moment holds it, each leaf's change after the last of them) and then
opens the measured window on the same objects.  The window ends at the
first step boundary after ``seconds``: the hook raises :class:`WindowClosed`,
which the loop does not catch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from perfbench import weights
from perfbench.feed import Feed


class WindowClosed(Exception):
    """Raised from the loop's hook at the first step boundary after the
    window's length; not a ``RuntimeError``, so the loop lets it through."""


def arch_config(cell, overrides: Optional[Dict] = None):
    """The port's ``ArchConfig``: the registry's entry with every size the
    configuration file states (so a change to the registry cannot change
    what is measured)."""
    from repro_torch import configs

    base = configs.get_config(cell.config.data["registry"])
    fields = dict(cell.config.arch, **(overrides or {}))
    return dataclasses.replace(base, name=cell.config.name, **fields)


def reducer_config(traffic: Dict):
    from repro_torch.comms.reducers import ReducerConfig

    r = traffic["reducer"]
    return ReducerConfig(kind=r["kind"], theta=r["theta"], n_bits=r["n_bits"], m_bits=r["m_bits"],
                         chunk=r["chunk"], error_feedback=r["error_feedback"],
                         bucket_bytes=int(r["bucket_mb"] * (1 << 20)),
                         transport=r["transport"], backend=r["backend"],
                         stacked=r["stacked"], schedule=r["schedule"],
                         stream_groups=r.get("stream_groups"), selector=r["selector"],
                         sample_rate=r["sample_rate"])


@dataclasses.dataclass
class Readings:
    """What the program's first steps give the comparison."""

    loss: List[float] = dataclasses.field(default_factory=list)
    grad: Dict[str, float] = dataclasses.field(default_factory=dict)
    change: Dict[str, float] = dataclasses.field(default_factory=dict)
    shapes: Dict[str, List[int]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WindowResult:
    steps: int = 0
    skipped: int = 0
    t_open: float = 0.0  # time.time() when the window opened
    seconds: float = 0.0  # its length on the host's clock
    marks: List[float] = dataclasses.field(default_factory=list)  # each step's end

    def step_ms(self) -> List[float]:
        ends = [self._t0] + self.marks
        return [1e3 * (b - a) for a, b in zip(ends, ends[1:])]


def make_feed(cell, seed: int, device, arch: Optional[Dict] = None) -> Feed:
    a = cell.config.arch if arch is None else arch
    return Feed(a["vocab_size"], cell.traffic.rows, cell.traffic.seq, cell.frames(),
                a["d_model"], seed, device)


def run(cell, seed: int, seconds: float, device, *, tracer=None, arch=None) -> Dict:
    """Set-up, the window, and the program's state freed.  Returns
    ``{"readings", "window", "feed_retries", "peak_bytes", "stages"}``
    (``stages``: the host's clock at the end of each stage of set-up).
    ``arch`` overrides the configuration (the tests' reduced widths);
    ``tracer`` (``trace.Tracer``) is told when the window opens and closes
    and may ask for more steps after it."""
    from repro_torch.core import schedules
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, init_state, train_loop
    from repro_torch.train.step import StepConfig

    stages = {"imported": time.time()}  # set-up's stages, on the host's clock
    traffic = cell.traffic.data
    cfg = arch if arch is not None else arch_config(cell)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = build(cfg, device="meta")
    model.to_empty(device=device)
    for path, p in model.named_parameters():
        weights.fill_(p.data, seed, path)
    stages["weights"] = time.time()
    compressed = traffic["mode"] != "pjit"
    reducer = reducer_config(traffic) if compressed else None
    step_cfg = StepConfig(mode=traffic["mode"], reducer=reducer, clip_norm=traffic["clip_norm"])
    o = traffic["optimizer"]
    opt_cfg = OptConfig(kind=o["kind"], lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                        weight_decay=o["weight_decay"])
    feed = make_feed(cell, seed, device, None if arch is None else dataclasses.asdict(arch))
    state = init_state(model, opt_cfg, error_feedback=compressed and reducer.error_feedback,
                       step_cfg=step_cfg)
    stages["state"] = time.time()
    readings = Readings(shapes={k: list(p.shape) for k, p in model.named_parameters()})
    window = WindowResult()
    warmup = cell.traffic.warmup_steps
    on_card = torch.device(device).type == "cuda"
    after = [0]  # steps run after the window closed, for the tracer

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def hook(step, metrics, st):
        if step < warmup:
            stages[f"step {step}"] = time.time()
            readings.loss.append(float(metrics["loss"]))
            if step == 0 and rank == 0:
                b1 = opt_cfg.b1
                readings.grad = {k: float(torch.linalg.vector_norm(m)) / (1.0 - b1)
                                 for k, m in st["opt"]["mu"].items()}
            if step == warmup - 1:
                if rank == 0:
                    with torch.no_grad():
                        for k, p in model.named_parameters():
                            p0 = weights.leaf(seed, k, p.shape, device)
                            readings.change[k] = float(torch.linalg.vector_norm(p.data - p0))
                            del p0
                sync()
                stages["readings"] = time.time()
                if tracer is not None:
                    tracer.open()
                window.t_open = time.time()
                window._t0 = time.perf_counter()
            return
        if window.seconds:  # closed: the tracer's detailed steps
            after[0] += 1
            if after[0] < tracer.extra_steps:
                return
            again = tracer.finish()
            if world > 1:  # rank 0's verdict for every worker
                flag = torch.tensor([1.0 if again else 0.0], device=device)
                dist.broadcast(flag, src=0)
                again = bool(flag.item())
            if again:
                after[0] = 0
                tracer.detail()
                return
            raise WindowClosed()
        window.steps += 1
        window.skipped += int(bool(metrics.get("skipped", 0.0)))
        now = time.perf_counter()
        window.marks.append(now)
        done = now - window._t0 >= seconds
        if world > 1:  # rank 0's clock decides for every worker
            flag = torch.tensor([1.0 if done else 0.0], device=device)
            dist.broadcast(flag, src=0)
            done = bool(flag.item())
        if done:
            window.seconds = time.perf_counter() - window._t0
            if tracer is not None:
                tracer.close(window.steps)
                tracer.detail()
                return
            raise WindowClosed()

    theta = schedules.constant(reducer.theta) if compressed else None
    loop_cfg = TrainLoopConfig(total_steps=1 << 40, log_every=1 << 40, theta_schedule=theta,
                               metrics_hook=hook)
    try:
        train_loop(model, opt_cfg, step_cfg, state, feed, loop_cfg)
    except WindowClosed:
        pass
    sync()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    retries = feed.retries()
    del model, state, feed
    if on_card:
        torch.cuda.empty_cache()
    return {"readings": readings, "window": window, "feed_retries": retries, "peak_bytes": peak,
            "stages": stages}
