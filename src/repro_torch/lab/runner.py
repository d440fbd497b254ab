"""Experiment runner (port of ``repro.lab.runner``): drives ``train_loop``
for one spec while recording the per-step evidence the evaluator needs.

Recorded per step (via the ``TrainLoopConfig.metrics_hook`` seam):

* ``loss`` / ``acc`` — the step's averaged training metrics;
* ``grad_sq`` — measured gradient energy ``||g||^2`` (pre-clip global norm),
  the quantity Thm 3.4 bounds;
* ``theta`` — the quantized theta the step actually ran;
* ``skipped`` — the guard's verdict (compressed rows);
* ``payload_bits`` / ``compression_ratio`` — modeled wire payload at that
  theta over the run's bucket layout (feeds ``cost_model.run_wire_account``);
* Assumption 3.1 probe — every ``probe_every`` steps the live full-batch
  gradient at the current parameters is flattened (``flatten_tree``),
  compressed and reconstructed with the row's compressor at the step's
  theta on the row's backend (so a ``cuda`` row launches the kernels),
  recording ``err_ratio = ||g - g_hat||/||g||`` and ``norm_ratio =
  ||g_hat||/||g||`` (``core.theory.assumption31_stats``).

Workers.  A row with one worker runs in this process.  A row with more
spawns ``spec.workers`` processes, each running the same per-rank function
in a world of exactly ``spec.workers`` ranks -- gloo on the CPU, NCCL with
one GPU a rank on the card (a card with fewer GPUs than the row asks for
raises; the row is never shrunk) -- and rank 0 returns the records; a
failing rank fails the row.  Every rank takes its slice of the rows of the
one global batch, as the reference shards its global batch over the data
axis, so a row's data do not depend on its worker count.

On the card a run sets cuDNN deterministic, turns its autotuning off and
turns TF32 off for cuDNN and matmuls, and restores the flags afterwards:
the lab's identity claims compare curves bitwise or to 1e-4.

Initial parameters come from a ``torch.Generator`` seeded with the spec's
seed, drawn on the CPU and moved to the device, so the CPU and the card
start from the same weights (not the reference's: its draws are JAX's).
``run_experiment(spec, init_params=, stream=)`` is the seam through which
a caller hands in other weights (a ``state_dict``) and another stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import socket
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.comms import cost_model
from repro_torch.comms import faults as faults_mod
from repro_torch.comms.bucketing import build_layout
from repro_torch.comms.reducers import ReducerConfig, flatten_tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import schedules as theta_schedules
from repro_torch.core.baselines import QSGD, TernGrad
from repro_torch.core.compressor import (FFTCompressor, FFTCompressorConfig,
                                         TimeDomainCompressor)
from repro_torch.core.theory import assumption31_stats
from repro_torch.data import ImageConfig, ImageStream, SyntheticConfig, SyntheticStream
from repro_torch.lab.spec import ExperimentSpec
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.convnet import ConvConfig, ConvNet
from repro_torch.models.transformer import LM
from repro_torch.optim import OptConfig
from repro_torch.train import TrainLoopConfig, init_state, train_loop
from repro_torch.train.step import StepConfig

__all__ = ["RunResult", "run_experiment", "run_matrix", "GlobalBatchShards"]

# the reference's CPU-sized model and data recipes
_LM_ARCH = ArchConfig(
    name="lab-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64,
)
_CONV_CFG = ConvConfig(n_classes=8, widths=(8, 16), blocks_per_stage=1, img_size=16)


@dataclasses.dataclass
class RunResult:
    """One completed experiment: the spec plus everything measured."""

    spec: ExperimentSpec
    records: List[Dict]  # one dict per step
    n_elems: int  # flat gradient length
    entropy_floor: float
    wire: Optional[Dict]  # cost_model.RunWireAccount.to_dict()
    walltime_s: float
    # the loop's ReducerHealth record (skipped steps, delays, degradation
    # transitions) plus the number of fatal-crash auto-resumes
    health: Optional[Dict] = None

    @property
    def loss_curve(self) -> List[float]:
        return [r["loss"] for r in self.records]

    @property
    def grad_sq_curve(self) -> List[float]:
        return [r["grad_sq"] for r in self.records]

    def final_loss(self, tail: int = 5) -> float:
        tail = min(tail, len(self.records))
        return sum(self.loss_curve[-tail:]) / tail

    def to_dict(self) -> Dict:
        return {
            "spec": self.spec.to_dict(),
            "records": self.records,
            "n_elems": self.n_elems,
            "entropy_floor": self.entropy_floor,
            "final_loss": self.final_loss(),
            "wire": self.wire,
            "walltime_s": round(self.walltime_s, 2),
            "health": self.health,
        }


class GlobalBatchShards:
    """A stream whose ``batch_at(step, host_index, num_hosts)`` is this
    host's contiguous slice of the rows of ``stream.batch_at(step)``: every
    worker count sees the same global batch."""

    def __init__(self, stream):
        self.stream = stream

    def batch_at(self, step: int, host_index: int = 0, num_hosts: int = 1) -> Dict:
        batch = self.stream.batch_at(step)
        if num_hosts == 1:
            return batch
        out = {}
        for key, value in batch.items():
            rows = value.shape[0] // num_hosts
            out[key] = value[host_index * rows:(host_index + 1) * rows]
        return out

    def entropy_floor(self) -> float:
        return self.stream.entropy_floor()


def _build_model(spec: ExperimentSpec, init_params: Optional[Mapping] = None):
    """The row's model on the CPU, from the spec's seed or ``init_params``."""
    gen = torch.Generator().manual_seed(spec.seed)
    if spec.model == "lm":
        model = LM(_LM_ARCH, device="cpu", generator=gen)
    else:
        model = ConvNet(_CONV_CFG, generator=gen)
    if init_params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
    return model


def _build_stream(spec: ExperimentSpec, device):
    if spec.model == "lm":
        return SyntheticStream(SyntheticConfig(
            vocab_size=_LM_ARCH.vocab_size, seq_len=32,
            global_batch=spec.global_batch, seed=1234 + spec.seed), device=device)
    return ImageStream(ImageConfig(
        n_classes=_CONV_CFG.n_classes, img_size=_CONV_CFG.img_size,
        global_batch=spec.global_batch, seed=1234 + spec.seed), device=device)


def _reducer_config(spec: ExperimentSpec,
                    plan: Optional[faults_mod.FaultPlan]) -> Optional[ReducerConfig]:
    if spec.reducer is None:
        return None
    return ReducerConfig(
        kind=spec.reducer, theta=spec.theta, quantize=spec.quantize,
        bucket_bytes=spec.bucket_bytes, transport=spec.transport,
        error_feedback=spec.error_feedback, backend=spec.backend, stacked=spec.stacked,
        schedule=spec.exchange_schedule, selector=spec.selector,
        validate=spec.validate, faults=plan,
    )


def _compressor_at(spec: ExperimentSpec, theta: float):
    """The compressor a worker runs at this theta (for probe + wire model)."""
    cfg = FFTCompressorConfig(theta=theta, quantize=spec.quantize,
                              backend=spec.backend, selector=spec.selector)
    if spec.reducer == "fft":
        return FFTCompressor(cfg)
    if spec.reducer == "timedomain":
        return TimeDomainCompressor(cfg)
    if spec.reducer == "terngrad":
        return TernGrad()
    if spec.reducer == "qsgd":
        return QSGD()
    return None


def _payload_bits(spec: ExperimentSpec, theta: float, n_elems: int) -> Optional[float]:
    """Modeled wire payload of one exchange at this theta, over the run's
    bucket layout, priced at the transport's payload granularity
    (``cost_model.bucketed_payload_bits``); stacked runs bill every bucket
    at the StackedPayload's padded row width."""
    comp = _compressor_at(spec, theta)
    if comp is None or not hasattr(comp, "wire_bits"):
        return None
    if spec.bucket_bytes is None:
        return float(comp.wire_bits(n_elems))
    layout = build_layout(n_elems, spec.bucket_bytes)
    return cost_model.bucketed_payload_bits(
        comp.wire_bits, layout.sizes(), spec.transport,
        stacked=spec.stacked, chunk=layout.chunk)


@contextlib.contextmanager
def _deterministic(dev: torch.device):
    """On the card: cuDNN deterministic, no autotuning, no TF32; restored
    on the way out."""
    if dev.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved


def _probe(model, batch, comp):
    """Assumption 3.1 on the live full-batch gradient at the current
    parameters: (err_ratio, norm_ratio) of decompress(compress(g))."""
    params = model.leaves()
    names = list(params)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    with torch.no_grad():
        flat, _ = flatten_tree(dict(zip(names, grads)))
        flat_hat = comp.decompress(comp.compress(flat))
        return assumption31_stats(flat, flat_hat)


def _run_rank(spec: ExperimentSpec, dev: torch.device, verbose: bool,
              init_params: Optional[Mapping], stream, ckpt_dir: Optional[str]) -> RunResult:
    """One worker's run (rank 0's records are the row's)."""
    rank = dist.get_rank() if spec.workers > 1 else 0
    init_model = _build_model(spec, init_params)
    init_sd = {k: v.detach().clone() for k, v in init_model.state_dict().items()}
    model = init_model.to(dev)
    stream = GlobalBatchShards(stream if stream is not None else _build_stream(spec, dev))
    opt = (OptConfig(kind="sgd", lr=spec.lr, momentum=0.9)
           if spec.opt == "sgd" else OptConfig(kind="adamw", lr=spec.lr))
    plan = faults_mod.FaultPlan.from_dicts(spec.faults) if spec.faults else None
    reducer = _reducer_config(spec, plan)
    step_cfg = StepConfig(mode="pjit" if reducer is None else "compressed_dp",
                          reducer=reducer)
    if spec.nodes is not None:
        mesh = make_local_mesh((spec.nodes, spec.workers // spec.nodes))
    else:
        mesh = make_local_mesh((spec.workers,), ("data",))
    state = init_state(model, opt, error_feedback=spec.error_feedback)
    n_elems = sum(p.numel() for p in model.leaves().values())
    schedule = (theta_schedules.make_schedule(**spec.schedule)
                if spec.schedule else None)

    comps: Dict[float, object] = {}
    payloads: Dict[float, Optional[float]] = {}
    records: List[Dict] = []

    def payload_at(theta: float) -> Optional[float]:
        # payload size depends only on the quantized theta (bounded grid)
        if theta not in payloads:
            payloads[theta] = _payload_bits(spec, theta, n_elems)
        return payloads[theta]

    def hook(step: int, metrics: Dict, state) -> None:
        theta = metrics.get("theta")
        rec = {"step": step, "loss": metrics["loss"],
               "grad_sq": metrics["grad_norm"] ** 2, "theta": theta}
        if "acc" in metrics:
            rec["acc"] = metrics["acc"]
        if "skipped" in metrics:
            rec["skipped"] = metrics["skipped"]
        payload = (payload_at(theta if theta is not None else spec.theta)
                   if spec.reducer is not None else None)
        rec["payload_bits"] = payload
        if payload:
            rec["compression_ratio"] = 32.0 * n_elems / payload
        probeable = (rank == 0 and spec.reducer in ("fft", "timedomain")
                     and spec.probe_every and step % spec.probe_every == 0
                     and theta is not None and theta > 0.0)
        if probeable:
            if theta not in comps:
                comps[theta] = _compressor_at(spec, theta)
            err, norm = _probe(model, stream.batch_at(step), comps[theta])
            rec["err_ratio"] = float(err)
            rec["norm_ratio"] = float(norm)
        records.append(rec)
        if verbose and step % 10 == 0:
            print(f"[lab:{spec.name}] step {step} loss {metrics['loss']:.4f}", flush=True)

    loop_cfg = TrainLoopConfig(
        total_steps=spec.steps, log_every=max(spec.steps, 1),
        theta_schedule=schedule, metrics_hook=hook,
        faults=plan, ckpt_dir=ckpt_dir, ckpt_every=spec.ckpt_every or 50,
    )
    t0 = time.perf_counter()
    resumes = 0
    with _deterministic(dev):
        while True:
            try:
                out = train_loop(model, opt, step_cfg, state, stream, loop_cfg, group=mesh)
                break
            except faults_mod.FatalInjectedCrash as e:
                resumes += 1
                if resumes > 8:
                    raise
                if verbose:
                    print(f"[lab:{spec.name}] {e}; restarting (auto-resume #{resumes})")
                # simulated process death: a fresh init state, which the
                # loop's auto-resume overwrites from the newest checkpoint
                with torch.no_grad():
                    for name, p in model.leaves().items():
                        p.copy_(init_sd[name])
                state = init_state(model, opt, error_feedback=spec.error_feedback)
    health = dict(out["health"], resumes=resumes)
    walltime = time.perf_counter() - t0

    if plan is not None:
        # rollback/resume re-runs steps: keep the LAST record per step
        last = {r["step"]: r for r in records}
        records = [last[s] for s in sorted(last)]

    if schedule is not None:
        # the loop's realized thetas must equal the declarative curve
        expected = theta_schedules.schedule_curve(schedule, spec.steps)
        realized = tuple(r["theta"] for r in records)
        if realized != expected:
            raise RuntimeError(
                f"{spec.name}: realized theta curve diverged from "
                f"schedule_curve: {realized} != {expected}")

    wire = None
    if spec.reducer is not None:
        topology = ((spec.nodes, spec.workers // spec.nodes)
                    if spec.nodes is not None else None)
        wire = cost_model.run_wire_account(
            n_elems, [r["payload_bits"] for r in records],
            spec.transport, spec.workers, topology=topology,
        ).to_dict()
    return RunResult(
        spec=spec, records=records, n_elems=n_elems,
        entropy_floor=stream.entropy_floor(), wire=wire, walltime_s=walltime,
        health=health,
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, spec_dict: Dict, dev_type: str, addr: str, verbose: bool,
               init_params, stream, ckpt_dir, out_path: str) -> None:
    """A spawned worker: joins the row's world, runs it, rank 0 writes the
    result."""
    spec = ExperimentSpec.from_dict(spec_dict)
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
        # the ranks share the host's cores (and OMP_NUM_THREADS, if set)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // spec.workers)))
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo", init_method=addr,
                            world_size=spec.workers, rank=rank)
    try:
        result = _run_rank(spec, dev, verbose and rank == 0, init_params, stream, ckpt_dir)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _spawn(spec: ExperimentSpec, dev: torch.device, verbose: bool, init_params, stream,
           ckpt_dir: Optional[str]) -> RunResult:
    """``spec.workers`` processes, one world; rank 0's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix=f"lab-{spec.name}-") as tmp:
        out_path = os.path.join(tmp, "result.pkl")
        mp.start_processes(
            _rank_main, nprocs=spec.workers, join=True, start_method="spawn",
            args=(spec.to_dict(), dev.type, f"tcp://localhost:{_free_port()}", verbose,
                  init_params, stream, ckpt_dir, out_path))
        with open(out_path, "rb") as f:
            return pickle.load(f)


def run_experiment(spec: ExperimentSpec, verbose: bool = True, *, device=None,
                   init_params: Optional[Mapping] = None, stream=None) -> RunResult:
    """Run one spec end to end on ``device`` (default ``cuda``; raises
    without it unless ``device="cpu"``); returns the recorded evidence.
    ``init_params`` (a ``state_dict`` of the row's model) and ``stream``
    (any object with ``batch_at(step)`` giving the global batch) replace
    the row's own."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() < spec.workers:
        raise RuntimeError(
            f"spec {spec.name!r} needs {spec.workers} workers, one GPU each, but only "
            f"{torch.cuda.device_count()} GPU(s) exist; run it with fewer workers "
            "(--workers) or on the CPU (--device cpu)")
    # crash/resume rows checkpoint into a throwaway directory every rank sees
    ckpt_dir = (tempfile.mkdtemp(prefix=f"lab-{spec.name}-ckpt-")
                if spec.ckpt_every else None)
    try:
        if spec.workers == 1:
            return _run_rank(spec, dev, verbose, init_params, stream, ckpt_dir)
        return _spawn(spec, dev, verbose, init_params, stream, ckpt_dir)
    finally:
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def run_matrix(specs: List[ExperimentSpec], verbose: bool = True, *, device=None,
               around: Optional[Callable[[ExperimentSpec], contextlib.AbstractContextManager]]
               = None) -> Dict[str, RunResult]:
    """Run every spec; returns {spec.name: RunResult} in matrix order.
    ``around(spec)``, when given, is a context manager entered around each
    row's run (a caller counting a row's kernel launches hangs there)."""
    out: Dict[str, RunResult] = {}
    for i, spec in enumerate(specs):
        if verbose:
            print(f"[lab] ({i + 1}/{len(specs)}) {spec.name}", flush=True)
        with (around(spec) if around is not None else contextlib.nullcontext()):
            out[spec.name] = run_experiment(spec, verbose=verbose, device=device)
        if verbose:
            r = out[spec.name]
            print(f"[lab] {spec.name}: final {r.final_loss():.4f} "
                  f"({r.walltime_s:.1f}s)", flush=True)
    return out
