"""Cost-model calibration: measure alpha-beta, the compression throughput and the
backward pass on the live process group (port of ``repro.comms.calibrate``,
flat exchanges).

* :func:`benchmark_collectives` times real collectives of the group --
  ``all_gather_into_tensor`` (the gather transports) and ``all_reduce`` (the
  spectrum psum) -- at a geometric sweep of sizes, with CUDA events on the
  card;
* :func:`fit_alpha_beta` least-squares fits ``t(wire_bytes) = alpha +
  beta * wire_bytes`` per collective family;
* :func:`measure_throughputs` times the compress -> decompress roundtrip
  the exchange itself runs (the reducer's transport, compressor and engine
  backend: the fused kernels on the card) and rebuilds the ``Throughputs``
  table from its byte rate;
* :func:`measure_backprop_rate` times the model's forward and backward pass
  and converts it to a FLOP rate by the 4*N*T backward model.

A one-rank group measures what a collective costs to launch, not a link:
its gather moves one payload and its all_reduce nothing over a wire.

The result is a frozen :class:`CostProfile`, persisted as JSON and keyed on
(platform, device name, world size, model, torch version): a job loads it
instead of profiling again, and a mismatch (another card, group size, model
or torch, or an artifact of the reference package, which is keyed on a JAX
mesh) raises :class:`ProfileKeyMismatch`.  Per-axis fits over two-level
meshes are not ported yet (ROADMAP.md).

    python -m repro_torch.comms.calibrate [--smoke] [--out PATH] [--check PATH]
        [--device cpu]

runs the pass in a one-rank group of its own (or the group a launcher such
as ``torchrun`` set up), prints the profile and writes it.  The reference's
``--devices`` (fake JAX host devices) has no counterpart: a group's size is
its launcher's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comms import cost_model
from repro_torch.dist_util import world_size

__all__ = ["ARTIFACT_VERSION", "COLLECTIVE_FAMILIES", "CostProfile", "LinkFit", "ProfileKey",
           "ProfileKeyMismatch", "UNCALIBRATED", "benchmark_collectives", "calibrate",
           "collective_family", "fit_alpha_beta", "load_or_calibrate", "load_profile_for",
           "measure_backprop_rate", "measure_throughputs", "process_group", "profile_key"]

# the reference writes integer versions keyed on a JAX mesh; the port's own
ARTIFACT_VERSION = "repro_torch/1"

COLLECTIVE_FAMILIES = ("gather", "psum")
_FAMILY_FOR_TRANSPORT = {"allgather": "gather", "sequenced": "gather", "psum": "psum"}

# fit floors: a noisy intercept or slope can come out non-positive, and a
# profile must stay usable as a divisor
ALPHA_FLOOR_S = 1e-9
BETA_FLOOR_S_PER_BYTE = 1e-15

# per-worker payload bytes: 64 KiB .. 16 MiB in 4x steps
DEFAULT_SIZES_BYTES = tuple(1 << p for p in range(16, 25, 2))
SMOKE_SIZES_BYTES = (1 << 14, 1 << 16, 1 << 18)


def collective_family(transport: str) -> str:
    """The alpha-beta family a transport's collective belongs to."""
    try:
        return _FAMILY_FOR_TRANSPORT[transport]
    except KeyError:
        raise ValueError(f"unknown transport {transport!r}; expected one of "
                         f"{tuple(_FAMILY_FOR_TRANSPORT)}") from None


class ProfileKeyMismatch(ValueError):
    """A persisted calibration does not match the live system."""


@dataclasses.dataclass(frozen=True)
class ProfileKey:
    """What a calibration is valid for: alpha-beta depend on the platform,
    the card and the group's size, the backward rate on the model, and the
    kernels and collectives on the torch build."""

    platform: str  # "cuda" | "cpu"
    device: str  # torch.cuda.get_device_name, or "cpu"
    workers: int
    model: str  # "<ClassName>/<param_count>" or "none"
    torch_version: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileKey":
        try:
            return cls(platform=d["platform"], device=d["device"], workers=int(d["workers"]),
                       model=d["model"], torch_version=d["torch_version"])
        except KeyError as e:
            raise ProfileKeyMismatch(f"calibration key {d} lacks {e}") from None


@dataclasses.dataclass(frozen=True)
class LinkFit:
    """Fitted model of one collective family, t(wire_bytes) = alpha + beta*b,
    over the cost model's per-worker wire volume (P*payload for gather,
    2*(P-1)/P*buffer for psum), so 1/beta is the model's ``t_comm``."""

    family: str
    alpha_s: float
    beta_s_per_byte: float
    n_points: int = 0

    def __post_init__(self):
        if self.family not in COLLECTIVE_FAMILIES:
            raise ValueError(f"unknown collective family {self.family!r}; expected one of "
                             f"{COLLECTIVE_FAMILIES}")
        if self.alpha_s <= 0.0 or self.beta_s_per_byte <= 0.0:
            raise ValueError(f"alpha/beta must be positive, got alpha={self.alpha_s} "
                             f"beta={self.beta_s_per_byte}")

    @property
    def t_comm(self) -> float:
        """Fitted link byte rate (bytes/second)."""
        return 1.0 / self.beta_s_per_byte

    def time_s(self, wire_bytes: float) -> float:
        return self.alpha_s + self.beta_s_per_byte * wire_bytes

    def to_dict(self) -> dict:
        return dict(dataclasses.asdict(self), t_comm_bytes_per_s=self.t_comm)


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """A frozen calibration of the cost model for one system: every pricing
    input ``cost_model`` and ``scheduler`` take, measured."""

    key: ProfileKey
    fits: Tuple[LinkFit, ...]  # one per family
    throughputs: cost_model.Throughputs
    backprop_flops_per_s: float
    calibrated: bool = True  # False: the uncalibrated defaults

    def __post_init__(self):
        if sorted(f.family for f in self.fits) != sorted(COLLECTIVE_FAMILIES):
            raise ValueError(f"profile needs one fit per family {COLLECTIVE_FAMILIES}, got "
                             f"{[f.family for f in self.fits]}")
        if self.backprop_flops_per_s <= 0.0:
            raise ValueError(
                f"backprop_flops_per_s must be positive, got {self.backprop_flops_per_s}")

    def fit_for(self, transport: str) -> LinkFit:
        family = collective_family(transport)
        return next(f for f in self.fits if f.family == family)

    def alpha_s(self, transport: str) -> float:
        return self.fit_for(transport).alpha_s

    def t_comm(self, transport: str) -> float:
        return self.fit_for(transport).t_comm

    def backprop_s(self, n_params: int, batch_tokens: int) -> float:
        """Backward pass at the measured rate (4 FLOPs a parameter a token)."""
        return 4.0 * float(n_params) * float(batch_tokens) / self.backprop_flops_per_s

    def to_dict(self) -> dict:
        return {"version": ARTIFACT_VERSION, "key": self.key.to_dict(),
                "fits": [f.to_dict() for f in self.fits],
                "throughputs": dataclasses.asdict(self.throughputs),
                "backprop_flops_per_s": self.backprop_flops_per_s,
                "calibrated": self.calibrated}

    @classmethod
    def from_dict(cls, d: dict) -> "CostProfile":
        if d.get("version") != ARTIFACT_VERSION:
            raise ProfileKeyMismatch(f"calibration artifact version {d.get('version')!r} != "
                                     f"supported {ARTIFACT_VERSION!r}")
        return cls(key=ProfileKey.from_dict(d["key"]),
                   fits=tuple(LinkFit(family=f["family"], alpha_s=f["alpha_s"],
                                      beta_s_per_byte=f["beta_s_per_byte"],
                                      n_points=int(f.get("n_points", 0))) for f in d["fits"]),
                   throughputs=cost_model.Throughputs(
                       **{k: float(v) for k, v in d["throughputs"].items()}),
                   backprop_flops_per_s=float(d["backprop_flops_per_s"]),
                   calibrated=bool(d.get("calibrated", True)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str, expect: Optional[ProfileKey] = None,
             strict: bool = True) -> "CostProfile":
        """Load an artifact; with ``expect`` (and ``strict``) a key mismatch
        raises :class:`ProfileKeyMismatch`."""
        with open(path) as f:
            profile = cls.from_dict(json.load(f))
        if expect is not None and profile.key != expect and strict:
            raise ProfileKeyMismatch(f"calibration artifact at {path} was measured for "
                                     f"{profile.key}, but this system is {expect}")
        return profile


# the uncalibrated defaults as a profile: what profile=None prices with
UNCALIBRATED = CostProfile(
    key=ProfileKey(platform="static", device="none", workers=0, model="none",
                   torch_version="any"),
    fits=tuple(LinkFit(family, cost_model.COLLECTIVE_ALPHA_S,
                       1.0 / cost_model.NETWORKS[cost_model.DEFAULT_NETWORK])
               for family in COLLECTIVE_FAMILIES),
    throughputs=cost_model.H100,
    backprop_flops_per_s=cost_model.BACKPROP_FLOPS_PER_S,
    calibrated=False)


def fit_alpha_beta(wire_bytes: Sequence[float],
                   times_s: Sequence[float]) -> Tuple[float, float]:
    """Least-squares fit of ``t = alpha + beta * bytes`` -> (alpha_s,
    beta_s_per_byte), both clamped to positive floors; fewer than two
    distinct sizes (a one-worker psum moves 0 bytes at every size) give
    alpha = mean(t) at the beta floor."""
    xs = [float(x) for x in wire_bytes]
    ts = [float(t) for t in times_s]
    if len(xs) != len(ts) or not xs:
        raise ValueError(f"need matching non-empty sweeps, got {len(xs)} sizes / "
                         f"{len(ts)} times")
    n = len(xs)
    mean_x = sum(xs) / n
    mean_t = sum(ts) / n
    var_x = sum((x - mean_x) ** 2 for x in xs)
    if var_x <= 0.0:
        alpha, beta = mean_t, BETA_FLOOR_S_PER_BYTE
    else:
        beta = sum((x - mean_x) * (t - mean_t) for x, t in zip(xs, ts)) / var_x
        alpha = mean_t - beta * mean_x
    return max(alpha, ALPHA_FLOOR_S), max(beta, BETA_FLOOR_S_PER_BYTE)


def _median_time_s(fn, device: torch.device, *, warmup: int = 1, iters: int = 3) -> float:
    """Median wall time of ``fn()``: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _modeled_wire_bytes(family: str, per_worker_bytes: int, workers: int) -> float:
    if family == "gather":
        return float(workers * per_worker_bytes)
    return 2.0 * per_worker_bytes * (workers - 1) / workers  # ring all-reduce


def _default_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def benchmark_collectives(group=None, sizes_bytes: Sequence[int] = DEFAULT_SIZES_BYTES, *,
                          iters: int = 3,
                          device=None) -> Dict[str, List[Tuple[float, float]]]:
    """Time real collectives of the initialized process group at each size:
    ``{family: [(modeled_wire_bytes, seconds), ...]}``, median of ``iters``
    after a warm-up call."""
    if not dist.is_initialized():
        raise RuntimeError("benchmark_collectives needs an initialized process group")
    device = torch.device(device) if device is not None else _default_device()
    workers = world_size(group)
    gen = torch.Generator(device=device).manual_seed(0)
    out: Dict[str, List[Tuple[float, float]]] = {f: [] for f in COLLECTIVE_FAMILIES}
    for size in sizes_bytes:
        n = max(1, int(size) // 4)
        x = torch.randn(n, generator=gen, device=device)
        gathered = x.new_empty(workers * n)
        t_gather = _median_time_s(
            lambda: dist.all_gather_into_tensor(gathered, x, group=group), device, iters=iters)
        t_psum = _median_time_s(lambda: dist.all_reduce(x, group=group), device, iters=iters)
        out["gather"].append((_modeled_wire_bytes("gather", 4 * n, workers), t_gather))
        out["psum"].append((_modeled_wire_bytes("psum", 4 * n, workers), t_psum))
    return out


def _throughput_elems(device: torch.device) -> int:
    """The calibration buffer: 2**26 values on the card (four 64 MiB
    buckets; at the reference's 2**20 a roundtrip measures launch cost, not
    throughput), 2**20 on the CPU."""
    return 1 << 26 if device.type == "cuda" else 1 << 20


# what measure_throughputs prices when no reducer is given: the CLI's fft
# reducer over 64 MiB sequenced buckets
DEFAULT_REDUCER = dict(kind="fft", theta=0.7, transport="sequenced", backend="auto",
                       selector="auto", bucket_bytes=64 << 20)


def measure_throughputs(n_elems: Optional[int] = None, *, reducer=None,
                        device=None) -> cost_model.Throughputs:
    """The §III-D compression cost per byte, measured through the code the
    exchange runs: the local compress -> decompress roundtrip of
    ``reducer`` (a ``ReducerConfig``; None, or a ``dense`` one, which
    compresses nothing: :data:`DEFAULT_REDUCER`) -- its
    transport, bucket layout, compressor and engine backend, so the fused
    kernels (B4/B1, B2, B3) on the card -- over ``n_elems`` values.

    The fused kernels run select, pack and encode in one launch, so the
    stages have no times of their own: every field gets the one rate ``r``
    at which the model's pair cost, ``2 * M * (4/r + 1/r + 1/r + 1/r)`` for
    ``M`` bytes, equals the measured roundtrip.  The cost model reads the
    table only through that sum (``Throughputs.inv_sum``)."""
    from repro_torch.comms.reducers import ReducerConfig, _make_compressor
    from repro_torch.comms.transport import get_transport

    device = torch.device(device) if device is not None else _default_device()
    n_elems = _throughput_elems(device) if n_elems is None else n_elems
    cfg = (ReducerConfig(**DEFAULT_REDUCER) if reducer is None or reducer.kind == "dense"
           else reducer)
    comp, transport = _make_compressor(cfg), get_transport(cfg.transport)
    layout = cfg.layout_for(n_elems)
    gen = torch.Generator(device=device).manual_seed(1)
    g = torch.randn(n_elems, generator=gen, device=device) * 0.05
    pair_s = _median_time_s(lambda: transport.run(g, comp=comp, layout=layout, local=True,
                                                  stacked=cfg.stacked), device)
    r = 2.0 * 7.0 * 4.0 * n_elems / pair_s
    return cost_model.Throughputs(t_m=r, t_f=r, t_p=r, t_s=r)


def _n_params(model) -> int:
    return sum(p.numel() for p in model.leaves().values())


def measure_backprop_rate(model, batch, *, batch_tokens: Optional[int] = None,
                          iters: int = 3) -> float:
    """The model's backward-pass FLOP rate: its forward and backward on
    ``batch`` timed, converted by the 4*N*T model ``modeled_backprop_s``
    prices with (rate in, time out round-trips)."""
    params = model.leaves()
    device = next(iter(params.values())).device
    tokens = batch["tokens"].numel() if batch_tokens is None else batch_tokens

    def grad():
        for p in params.values():
            p.grad = None
        model.loss(batch)[0].backward()

    t = _median_time_s(grad, device, iters=iters)
    for p in params.values():
        p.grad = None
    return 4.0 * float(_n_params(model)) * float(tokens) / t


def profile_key(model=None, model_name: Optional[str] = None, group=None,
                device=None) -> ProfileKey:
    """The key a calibration of this system persists under."""
    device = torch.device(device) if device is not None else _default_device()
    if model_name is None:
        model_name = "none" if model is None else f"{type(model).__name__}/{_n_params(model)}"
    return ProfileKey(
        platform=device.type,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        workers=world_size(group), model=model_name, torch_version=torch.__version__)


def _fit_sweeps(sweeps) -> List[LinkFit]:
    fits = []
    for family in COLLECTIVE_FAMILIES:
        points = sweeps[family]
        alpha, beta = fit_alpha_beta([b for b, _ in points], [t for _, t in points])
        fits.append(LinkFit(family, alpha, beta, n_points=len(points)))
    return fits


def calibrate(group=None, *, model=None, batch=None,
              sizes_bytes: Sequence[int] = DEFAULT_SIZES_BYTES, iters: int = 3,
              throughput_elems: Optional[int] = None, measure_stages: bool = True,
              reducer=None, device=None) -> CostProfile:
    """The profiling pass: one measured :class:`CostProfile`.  Without a
    model and batch the backward rate keeps the default, and the key says
    ``model="none"``.  ``reducer`` is the ``ReducerConfig`` whose exchange
    the throughputs are measured through (:func:`measure_throughputs`)."""
    device = torch.device(device) if device is not None else _default_device()
    fits = _fit_sweeps(benchmark_collectives(group, sizes_bytes, iters=iters, device=device))
    thr = (measure_throughputs(throughput_elems, reducer=reducer, device=device)
           if measure_stages else cost_model.H100)
    if model is not None and batch is not None:
        backprop = measure_backprop_rate(model, batch, iters=iters)
    else:
        backprop = cost_model.BACKPROP_FLOPS_PER_S
    return CostProfile(key=profile_key(model=model, group=group, device=device),
                       fits=tuple(fits), throughputs=thr, backprop_flops_per_s=backprop)


def load_profile_for(path: str, model=None, group=None, device=None) -> CostProfile:
    """Load an artifact for this system (what the train step uses): platform,
    card, group size and torch must match; the model must match or be
    ``"none"`` (a comms-only calibration prices any model's collectives).
    A mismatch raises :class:`ProfileKeyMismatch`."""
    if device is None and model is not None:
        device = next(iter(model.leaves().values())).device
    profile = CostProfile.load(path)
    live = profile_key(model=model, group=group, device=device)
    k = profile.key
    if not (k.platform == live.platform and k.device == live.device
            and k.workers == live.workers and k.torch_version == live.torch_version
            and k.model in (live.model, "none")):
        raise ProfileKeyMismatch(f"calibration artifact at {path} was measured for {k}, "
                                 f"but this system is {live}")
    return profile


def load_or_calibrate(path: Optional[str], group=None, *, expect: Optional[ProfileKey] = None,
                      **calibrate_kwargs) -> CostProfile:
    """Load ``path`` when it exists (and matches ``expect``); otherwise
    profile and persist to ``path`` so the next job skips the pass."""
    if path is not None and os.path.exists(path):
        return CostProfile.load(path, expect=expect)
    profile = calibrate(group, **calibrate_kwargs)
    if path is not None:
        profile.save(path)
    return profile


@contextlib.contextmanager
def process_group(device: torch.device):
    """The process group to calibrate over: the one already initialized,
    else the one a launcher's environment (``WORLD_SIZE``) describes, else a
    one-rank group on a file store of its own (NCCL on the card, gloo on
    the CPU).  A group this made is destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    store_dir = None
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        store_dir = tempfile.mkdtemp(prefix="calibrate-")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def main(argv=None) -> int:
    """Run the profiling pass (or check an artifact) on this host."""
    import argparse

    from repro_torch import device as device_mod

    ap = argparse.ArgumentParser(description="cost-model calibration pass")
    ap.add_argument("--smoke", action="store_true",
                    help="small size sweep and throughput buffer")
    ap.add_argument("--out", default=None, help="persist the artifact here")
    ap.add_argument("--check", default=None,
                    help="load an artifact, check it against this host's key, print it")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    if args.check is not None:
        profile = CostProfile.load(args.check)
        live = profile_key(model_name=profile.key.model, device=dev)
        if profile.key != live:
            print(f"[calibrate] STALE artifact: measured for {profile.key}, "
                  f"live system is {live}")
            return 1
        print(json.dumps(profile.to_dict(), indent=2))
        print("[calibrate] artifact matches the live system")
        return 0

    with process_group(dev):
        sizes = SMOKE_SIZES_BYTES if args.smoke else DEFAULT_SIZES_BYTES
        profile = calibrate(sizes_bytes=sizes, device=dev,
                            throughput_elems=(1 << 16) if args.smoke else None)
    print(json.dumps(profile.to_dict(), indent=2))
    for fit in profile.fits:
        print(f"[calibrate] {fit.family}: alpha={fit.alpha_s * 1e6:.1f} us  "
              f"1/beta={fit.t_comm / 1e9:.2f} GB/s  ({fit.n_points} points)")
    if args.out:
        profile.save(args.out)
        print(f"[calibrate] wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
