"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace one step of
every (arch x shape x mesh) cell on fake tensors over a fake world.

For each cell this:
  1. starts a fake world of 256 ranks (512 with ``--multi-pod``), this
     process rank 0, on PyTorch's ``fake`` process-group backend, and builds
     the production mesh, ``(16, 16)`` or ``(2, 16, 16)``;
  2. builds the model, the state or the serving placement and the inputs
     (``registry.input_specs``) as fake tensors, so nothing is allocated;
  3. runs one ``train`` step body (``step.body``, the committing branch of a
     compressed step), or one prefill or decode step, on the rank's shard
     of everything, under four dispatch modes: a live-storage tracker (the
     memory), ``FlopCounterMode`` (the flops), a byte counter (the bytes
     accessed, and the kernels' custom-op calls) and the collective recorder
     (``analysis/collectives.py``);
  4. prices it with the roofline (``analysis/roofline.py``, the H100's) and
     writes a JSON artifact under the reference's tag and keys.

What the port counts, and why it traces at full depth:

* ``flops`` is what ``FlopCounterMode`` counts: the matmuls and attention
  products, forward and backward, not elementwise ops or FFTs;
* ``bytes accessed`` is the eager program's traffic: each op's operands
  and results once (views, allocations and collectives move nothing here);
* ``memory``: ``argument_size`` is the rank's inputs (state or serving
  parameters, batch, caches), ``temp_size`` the peak of every other live
  storage during the step, ``output_size`` what the step leaves (a train
  step's updated state, which it writes in place; serving's logits and
  caches).  XLA's ``generated_code_size`` has no counterpart;
* eager PyTorch dispatches every trip of every loop, so a full-depth trace
  counts every layer: the reference's ``scan_layers=False`` depth samples,
  its ``_affine_extrapolate`` and ``_recurrent_correction`` and
  ``models/flags.py`` (which only steer XLA's lowering for
  ``cost_analysis``) have nothing to correct, and are not ported.

A kernel's launch is a custom op with a shape function
(``kernels/build.py:kernel_op``), so a fake tensor never reaches
``ctypes``; the quantizer's search runs to its cap on fakes
(``core/quantizer.py``).  The trace runs on ``cuda`` fakes unless the
caller asks for the CPU (``--device cpu``), as the tests do; on ``cuda`` a
``fits`` line compares the rank's peak with the card's memory.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun]
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k \\
      --multi-pod --mode hierarchical --theta 0.7   # compressed-exchange variants
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.collectives import CollectiveRecorder
from repro_torch.analysis.roofline import compute_roofline
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.configs import SHAPES
from repro_torch.kernels import all_kernels
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.models.sharding import count_params
from repro_torch.optim import OptConfig
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.state import init_state
from repro_torch.train.step import StepConfig, build_train_step, mesh_batch_axes

__all__ = ["FSDP_TRAIN_THRESHOLD", "FSDP_SERVE_THRESHOLD", "LiveStorage", "OpBytes",
           "run_cell", "trace_cell", "main"]

# the reference's: FSDP is the uniform train default; serving weights (bf16,
# no optimizer state) are 2-D sharded above ~40B parameters
FSDP_TRAIN_THRESHOLD = 0
FSDP_SERVE_THRESHOLD = 40e9

_C10D = ("c10d", "_c10d_functional")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "alias", "_local_scalar_dense", "set_", "resize_"}

def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _tensors(tree):
    """The tensors of a tree of dicts, sequences and cache dataclasses (a
    DTensor's local shard in its place)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [_local(tree)] if isinstance(tree, torch.Tensor) else []


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class OpBytes(TorchDispatchMode):
    """``bytes``: each op's operands and results once (no views,
    allocations, metadata reads or collectives); ``kernels``: calls of each
    kernel's custom op (``repro_torch::<name>``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kernels = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "repro_torch":
            self.kernels[func._opname] += 1
        if (ns not in _C10D and ns != "prim" and not func.is_view
                and func._opname not in _NO_TRAFFIC):
            self.bytes += _bytes(args) + _bytes(kwargs) + _bytes(out)
        return out


class LiveStorage(TorchDispatchMode):
    """The bytes of the storages alive: those :meth:`track` is given and
    every op's results, each freed when its storage is; ``peak`` the most
    at once."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors; returns their bytes."""
        added = 0
        for t in _tensors(tree):
            if t.device.type == "meta":  # shapes only, never memory
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))
            self.live += n
            added += n
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, key: int, n: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


@contextlib.contextmanager
def measured(skip_cost: bool = False):
    """The four counters around one step: yields a dict that receives
    ``flops``, ``bytes``, ``kernels`` and ``collectives`` when the block
    ends (``mem``, the :class:`LiveStorage`, at once)."""
    from torch.utils.flop_counter import FlopCounterMode

    mem, ops, coll = LiveStorage(), OpBytes(), CollectiveRecorder()
    flops = FlopCounterMode(display=False)
    out = {"mem": mem}
    with contextlib.ExitStack() as stack:
        stack.enter_context(mem)
        if not skip_cost:
            stack.enter_context(flops)
            stack.enter_context(ops)
        stack.enter_context(coll)
        yield out
    out.update(flops=0 if skip_cost else flops.get_total_flops(), bytes=ops.bytes,
               kernels=dict(ops.kernels), collectives=coll.summary())


def _rows(global_batch: int, workers: int) -> int:
    """The rows one rank's program sees of a batch sharded over
    ``workers`` (the whole batch when they do not divide it)."""
    return global_batch // workers if global_batch % workers == 0 else global_batch


def _real_inputs(cfg, shape, device, generator) -> Dict:
    """``input_specs``' tensors filled: tokens drawn in the vocab (int32),
    the frontend's embeddings, empty decode caches."""
    from repro_torch.models.transformer import init_caches

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"caches": init_caches(cfg, b, s, device=device),
                "token": torch.randint(0, cfg.vocab_size, (b, 1), generator=generator,
                                       device=device, dtype=torch.int32),
                "pos": torch.tensor(s - 1, dtype=torch.int32, device=device)}
    out = registry.make_batch(cfg, b, s, generator=generator, device=device)
    out = {k: v.to(torch.int32) if k in ("tokens", "targets") else v for k, v in out.items()}
    if shape.kind == "prefill":
        del out["targets"]
    return out


def trace_cell(cfg, shape, mesh, *, multi_pod: bool = False, mode: str = "pjit",
               theta: float = 0.7, device: str = "cuda", skip_cost: bool = False,
               reducer: Optional[ReducerConfig] = None, fake: bool = True,
               generator: Optional[torch.Generator] = None) -> Dict:
    """One step of ``cfg`` at ``shape`` on ``mesh``, traced on fake tensors
    of ``device`` (the caller holds the fake world): the reference's
    ``_lower_cell``.  Returns the measurements (bytes, flops, collectives,
    kernel calls) and ``kind`` and ``tokens``.  ``mesh=None`` is one
    process with no process group, as the CLIs run on one card.
    ``fake=False`` runs the same step on real tensors (weights and tokens
    from ``generator``), measured the same way: what the trace is held to;
    on the card it also gives ``cuda_peak`` (the allocator's peak during the
    step above what was allocated before the model was built) and
    ``step_ms`` (one more step, unmeasured) and ``launches`` (each
    kernel's launches in the measured step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    on_card = not fake and torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
    with (FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()):
        model = registry.build(cfg, device=device, generator=generator)
        n_params = count_params(model.spec())
        specs = (registry.input_specs(cfg, shape, device=device) if fake
                 else _real_inputs(cfg, shape, device, generator))
        if shape.kind == "train":
            opt_cfg = OptConfig(kind="adamw")
            if mode != "pjit" and reducer is None:
                # the port's kernel path (B4, B2, B3), which the card runs
                reducer = ReducerConfig(kind="fft" if mode == "compressed_dp" else "hierarchical",
                                        theta=theta, backend="auto", selector="auto")
            fsdp = mode == "pjit" and n_params > FSDP_TRAIN_THRESHOLD
            step_cfg = StepConfig(mode=mode, fsdp=fsdp, multi_pod=multi_pod, reducer=reducer)
            state = init_state(model, opt_cfg, mesh=mesh, step_cfg=step_cfg,
                               error_feedback=reducer is not None and reducer.error_feedback)
            workers = 1 if mesh is None else mesh.size_of(mesh_batch_axes(step_cfg, mesh))
            b = _rows(shape.global_batch, workers)
            batch = {k: v[:b].clone() for k, v in specs.items()}
            step = build_train_step(model, opt_cfg, step_cfg, group=mesh,
                                    batch_tokens=shape.tokens)
            args = ({k: v for k, v in state.items() if k != "model"}, model.leaves(), batch)
            # a trace commits without reading the guard; a real step reads it
            kw = {} if mode == "pjit" else {"commit": True if fake else None}
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels = all_kernels()
                before = {k.name: k.launches for k in kernels}
            with measured(skip_cost) as m:
                m["argument"] = m["mem"].track(args)
                out = step.body(state, batch, **kw)
                m["temp"] = m["mem"].peak - m["argument"]
            if on_card:
                torch.cuda.synchronize()
                m["cuda_peak"] = torch.cuda.max_memory_allocated() - base
                m["launches"] = {k.name: k.launches - before[k.name] for k in kernels
                                 if k.launches > before[k.name]}
                t1 = time.perf_counter()
                step.body(state, batch, **kw)
                torch.cuda.synchronize()
                m["step_ms"] = (time.perf_counter() - t1) * 1e3
            m["output"] = _bytes(({k: v for k, v in state.items() if k != "model"},
                                  model.leaves(), out))
            kind, tokens = "train", shape.tokens
        else:
            fsdp = n_params > FSDP_SERVE_THRESHOLD
            b = shape.global_batch
            engine = Engine(model, ServeConfig(max_seq=shape.seq_len, batch=b), mesh=mesh,
                            fsdp=fsdp)
            place = engine.placement
            if shape.kind == "prefill":
                batch = {k: place.rows(v, b).clone() for k, v in specs.items()}
                args = (place.blocks, batch)
                with measured(skip_cost) as m:
                    m["argument"] = m["mem"].track(args)
                    out = engine._prefill(batch, global_batch=b)
                    m["temp"] = m["mem"].peak - m["argument"]
                kind, tokens = "prefill", shape.tokens
            else:
                full = specs["caches"]
                memory_len = _memory_len(cfg, full)
                cspecs = place.cache_specs(b, shape.seq_len, memory_len)
                caches = place.local_caches(full, cspecs)
                token = place.rows(specs["token"], b).clone()
                args = (place.blocks, caches, token)
                with measured(skip_cost) as m:
                    m["argument"] = m["mem"].track(args)
                    out = engine._decode(caches, token, shape.seq_len - 1, global_batch=b,
                                         max_seq=shape.seq_len, memory_len=memory_len)
                    m["temp"] = m["mem"].peak - m["argument"]
                kind, tokens = "decode", b
            m["output"] = _bytes(out)
    del m["mem"]
    m.update(kind=kind, tokens=tokens, n_params=n_params, trace_s=time.perf_counter() - t0)
    return m


def _memory_len(cfg, caches) -> Optional[int]:
    """The cross caches' length in decode caches (None without cross
    layers)."""
    from repro_torch.models.transformer import CROSS_KINDS

    for key, c in caches.items():
        kind = key.split("_", 1)[1]
        if kind in CROSS_KINDS:
            cross = c[1] if isinstance(c, tuple) else c
            return cross.k.shape[2]
    return None


def _tag(arch: str, shape_name: str, multi_pod: bool, mode: str) -> str:
    return f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}__{mode}"


def _write(out_dir: Optional[str], tag: str, result: Dict) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the block (none is left behind)."""
    import torch.distributed as dist

    from repro_torch.dist_util import init_fake_world

    init_fake_world(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, mode: str = "pjit",
             theta: float = 0.7, out_dir: Optional[str] = "build/dryrun", verbose: bool = True,
             skip_cost: bool = False, device: str = "cuda", cfg=None, mesh_shape=None,
             shape=None, reducer: Optional[ReducerConfig] = None) -> Dict:
    """One cell, the reference's artifact: traced on the production mesh
    over a fake world of its size (``cfg``, ``mesh_shape``, ``shape`` and
    ``reducer`` override the arch's config, the mesh, the cell's shape and
    the compressed modes' reducer, for cut-down cells)."""
    shape = shape or SHAPES[shape_name]
    tag = _tag(arch, shape_name, multi_pod, mode)
    skip = registry.cell_is_supported(arch, shape)
    if skip:
        result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "mode": mode,
                  "status": "skipped", "reason": skip}
        _write(out_dir, tag, result)
        return result
    cfg = cfg or registry.get_config(arch)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    with fake_world(math.prod(mesh_shape)):
        if tuple(mesh_shape) in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3, device=device)
        else:
            mesh = make_local_mesh(tuple(mesh_shape), axes, device=device)
        m = trace_cell(cfg, shape, mesh, multi_pod=multi_pod, mode=mode, theta=theta,
                       device=device, skip_cost=skip_cost, reducer=reducer)
    chips = math.prod(mesh_shape)
    n_active = cfg.active_param_count() if cfg.n_experts else m["n_params"]
    cost = {"flops": float(m["flops"]), "bytes accessed": float(m["bytes"])}
    terms = compute_roofline(cost=cost, collectives=m["collectives"], chips=chips,
                             n_active_params=n_active, tokens=m["tokens"], kind=m["kind"])
    mem = {f"{k}_size_gib": m[k] / 2**30 for k in ("argument", "output", "temp")}
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod, "mode": mode,
        "status": "ok", "chips": chips, "kind": m["kind"], "n_params": m["n_params"],
        "n_active_params": n_active, "tokens": m["tokens"], "memory": mem,
        "cost": cost, "collectives": m["collectives"], "roofline": terms.as_dict(),
        "kernel_calls": m["kernels"], "trace_s": round(m["trace_s"], 1), "device": device,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={'multi' if multi_pod else 'single'} "
              f"mode={mode}: OK (trace {m['trace_s']:.0f}s)")
        print(f"  memory/device: {mem}")
        print(f"  collectives: {m['collectives']}")
        print(f"  roofline: compute={terms.compute_s*1e3:.2f}ms "
              f"memory={terms.memory_s*1e3:.2f}ms collective={terms.collective_s*1e3:.2f}ms "
              f"dominant={terms.dominant} useful={terms.useful_ratio:.2f}")
        if device == "cuda":
            total = torch.cuda.get_device_properties(0).total_memory
            peak = m["argument"] + m["temp"]
            print(f"  fits: {peak / 2**30:.2f} GiB a rank of the card's {total / 2**30:.2f} GiB: "
                  f"{'yes' if peak <= total else 'NO'}")
    _write(out_dir, tag, result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=registry.ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="pjit", choices=["pjit", "compressed_dp", "hierarchical"])
    ap.add_argument("--theta", type=float, default=0.7)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-cost", action="store_true",
                    help="memory and collectives only: no flop or byte counting")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default cuda; --device cpu on a host)")
    args = ap.parse_args(argv)
    device = "cuda" if args.device is None else args.device
    if device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to trace on CPU fakes")
    if args.mode == "hierarchical" and not args.multi_pod:
        ap.error("--mode hierarchical exchanges over the 'pod' axis: give --multi-pod")

    cells = []
    if args.all:
        # the enc-dec arch last, as the reference schedules it
        order = [a for a in registry.ARCH_NAMES if a != "seamless_m4t_large_v2"]
        order.append("seamless_m4t_large_v2")
        for arch in order:
            for shape in SHAPES:
                if os.path.exists(os.path.join(
                        args.out, _tag(arch, shape, args.multi_pod, args.mode) + ".json")):
                    continue  # resumable batch
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        try:
            run_cell(arch, shape, multi_pod=args.multi_pod, mode=args.mode, theta=args.theta,
                     out_dir=args.out, skip_cost=args.skip_cost, device=device)
        except Exception:
            failures += 1
            print(f"[dryrun] {arch} x {shape} FAILED:")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
