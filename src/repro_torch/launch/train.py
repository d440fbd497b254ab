"""Training CLI of the port (same flags and defaults as ``repro.launch.train``).

The default, ``--mode pjit``, is the dense baseline: AdamW on the mean
gradient, no reducer and no theta schedule.  ``--mode compressed_dp`` is
the paper's setting, with ``--reducer fft|timedomain|terngrad|qsgd|dense``
over the ``allgather`` transport (the default: one monolithic payload),
``sequenced`` (bucketed all_gather), ``psum`` (one all_reduce of the dense
spectra) or ``reduce_scatter`` (the dense spectra reduced bucket by bucket
range, each worker inverting its own); ``--nodes N`` splits the workers
into N islands, a ``("node", "local")`` mesh (``launch/mesh.py``), over
which the exchange runs, ``--transport hierarchical`` (the island's dense
mean on the fast link, one compressed payload an island over the fabric)
needs it, and ``--transport auto`` lets the cost model choose ``psum`` or
``hierarchical`` on its topology; ``--no-stacked`` runs the per-bucket loop instead of the
batched executor, ``--theta-schedule constant|step|thm35`` sets theta
step by step, ``--schedule streamed`` (with ``--stream-groups N``)
dispatches the exchange one readiness group at a time and ``--schedule
auto`` lets the cost model choose, priced by ``--calibrate`` (measure
collectives, stages and this model's backward pass first; with
``--calibration-path`` the artifact is written there, and a later run
that finds it loads it instead of profiling) or by a ``--calibration-path``
artifact alone; ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps
and resumes from the newest checkpoint there:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \\
      --n-layers 4 --steps 3 --batch 4 --seq 512 --mode compressed_dp \\
      --reducer fft --transport sequenced --bucket-mb 64 --error-feedback \\
      --backend auto --selector auto

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU.  ``--n-layers`` cuts the depth at full width (a port-only flag).  Flags
and values the port does not run (``--mode hierarchical``, ``--mesh
production|multi_pod``, ``--publish-dir``) raise with a pointer to
ROADMAP.md.  Under ``torchrun`` (or any launcher that sets the
``torch.distributed`` environment) each process trains one worker of the
data-parallel group; ``--calibrate`` with ``--nodes`` also fits each axis's
link on its own:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced --device cpu \\
      --mode compressed_dp --nodes 2 --transport hierarchical --bucket-mb 0.25 \\
      --error-feedback --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch import configs, device as device_mod
from repro_torch.comms.reducers import ReducerConfig
from repro_torch.core import schedules as theta_schedules
from repro_torch.data import SyntheticConfig, SyntheticStream
from repro_torch.launch.mesh import make_two_level_mesh
from repro_torch.models import build
from repro_torch.optim import OptConfig, lr_schedules
from repro_torch.train import TrainLoopConfig, init_state, train_loop
from repro_torch.train.step import StepConfig

ARCH_CHOICES = ("gemma2_2b", "internlm2_20b", "qwen1_5_110b", "phi3_medium_14b",
                "mixtral_8x22b", "qwen3_moe_235b_a22b", "hymba_1_5b", "xlstm_1_3b",
                "seamless_m4t_large_v2", "llama3_2_vision_11b")


def _not_ported(ap, what: str):
    ap.error(f"{what} is not ported to the PyTorch package yet; see ROADMAP.md")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b", choices=ARCH_CHOICES)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers at full width")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="pjit", choices=["pjit", "compressed_dp", "hierarchical"])
    ap.add_argument("--reducer", default="fft",
                    choices=["fft", "timedomain", "terngrad", "qsgd", "dense"])
    ap.add_argument("--theta", type=float, default=0.7)
    ap.add_argument("--theta-schedule", default="constant",
                    choices=["constant", "step", "thm35"])
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--bucket-mb", type=float, default=None)
    ap.add_argument("--transport", default="allgather",
                    choices=["allgather", "sequenced", "psum", "hierarchical",
                             "reduce_scatter", "auto"])
    ap.add_argument("--backend", default="auto", choices=["reference", "cuda", "auto"])
    ap.add_argument("--no-stacked", action="store_true")
    ap.add_argument("--schedule", default="stacked", choices=["stacked", "streamed", "auto"])
    ap.add_argument("--stream-groups", type=int, default=None)
    ap.add_argument("--selector", default="auto", choices=["sort", "sampled", "bisect", "auto"])
    ap.add_argument("--sample-rate", type=float, default=1.0 / 64.0)
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--calibration-path", default=None)
    ap.add_argument("--publish-dir", default=None)
    ap.add_argument("--publish-every", type=int, default=1)
    ap.add_argument("--publish-theta", type=float, default=0.0)
    ap.add_argument("--publish-capacity", type=int, default=64)
    ap.add_argument("--publish-snapshot-every", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="local", choices=["local", "production", "multi_pod"])
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a GPU the default raises")
    return ap


def _check_ported(ap, args) -> None:
    if args.mode == "hierarchical":
        _not_ported(ap, f"--mode {args.mode}")
    if args.publish_dir:
        _not_ported(ap, "--publish-dir")
    if args.mesh != "local":
        _not_ported(ap, f"--mesh {args.mesh}")
    if args.transport == "hierarchical" and args.nodes is None:
        ap.error("--transport hierarchical needs a two-level mesh: give --nodes")


def _theta_schedule(args):
    """The theta schedule of ``--theta-schedule``, as the reference builds
    it; None in ``--mode pjit``, which compresses nothing."""
    if args.mode == "pjit":
        return None
    if args.theta_schedule == "constant":
        return theta_schedules.constant(args.theta)
    if args.theta_schedule == "step":
        return theta_schedules.step_decay([(0, args.theta), (args.steps // 2, 0.0)])
    return theta_schedules.thm35_schedule(
        1.0, lambda s: args.lr * lr_schedules.rsqrt_decay()(s))


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    _check_ported(ap, args)
    dev = device_mod.resolve(args.device)
    group = None
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized() and dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if args.nodes is not None:
        try:
            group = make_two_level_mesh(args.nodes)
        except ValueError as e:
            ap.error(f"--nodes {args.nodes}: {e}")

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build(cfg, device=dev, generator=gen)

    reducer = None
    if args.mode != "pjit":
        reducer = ReducerConfig(
            kind=args.reducer, theta=args.theta, error_feedback=args.error_feedback,
            bucket_bytes=int(args.bucket_mb * (1 << 20)) if args.bucket_mb else None,
            transport=args.transport, backend=args.backend, stacked=not args.no_stacked,
            schedule=args.schedule, stream_groups=args.stream_groups,
            selector=args.selector, sample_rate=args.sample_rate)
    step_cfg = StepConfig(mode=args.mode, reducer=reducer,
                          calibration_path=args.calibration_path)
    opt_cfg = OptConfig(kind="adamw", lr=args.lr)
    stream = SyntheticStream(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                             global_batch=args.batch, seed=args.seed),
                             device=dev)
    state = init_state(model, opt_cfg,
                       error_feedback=reducer is not None and reducer.error_feedback)
    calibration = None
    if args.calibrate and args.mode != "pjit":
        step_cfg, calibration = _calibrate(args, step_cfg, model, stream, dev, group)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=max(1, args.steps // 20), theta_schedule=_theta_schedule(args),
        lr_schedule=lr_schedules.warmup_cosine(max(2, args.steps // 10), args.steps))
    result = train_loop(model, opt_cfg, step_cfg, state, stream, loop_cfg, group=group)
    result["calibration"] = calibration
    if reducer is not None and reducer.transport == "auto":
        decision = result["transport_decision"]
        print(f"[transport] auto -> {result['reducer_config'].transport} "
              f"{decision.to_dict() if decision else '(no two-level topology to price)'}")
    if result["schedule_decision"] is not None:
        print(f"[schedule] {result['schedule_decision'].to_dict()}")
    for row in result["history"]:
        print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in row.items()})
    return result


def _calibrate(args, step_cfg, model, stream, dev, group):
    """``--calibrate``: load the artifact at ``--calibration-path`` when it
    exists (key-checked against this card, group, topology, model and
    torch), else run the profiling pass over the process group (a one-rank
    group of its own when none is initialized; with ``--nodes``, over the
    two-level mesh, whose axes are also swept one by one) and write it
    there (or to a temporary file).  Returns the step config that loads it
    and ``{"path", "profiled", "profile"}``."""
    import tempfile

    from repro_torch.comms import calibrate as cal

    path = args.calibration_path
    if path is not None and os.path.exists(path):
        profile = cal.load_profile_for(path, model=model, group=group, device=dev)
        profiled = False
    else:
        live = dist.is_initialized()
        with cal.process_group(dev):
            # a mesh built before the pass's own one-rank group has no groups
            # to sweep: build its twin inside it
            cal_group = group if live or args.nodes is None else make_two_level_mesh(args.nodes)
            profile = cal.calibrate(cal_group, model=model, batch=stream.batch_at(0),
                                    reducer=step_cfg.reducer, device=dev)
        profiled = True
        if path is None:
            fd, path = tempfile.mkstemp(suffix=".calibration.json")
            os.close(fd)
        profile.save(path)
    for fit in profile.fits:
        print(f"[calibrate] {fit.family}{'' if fit.axis is None else ' over ' + fit.axis}: "
              f"alpha={fit.alpha_s * 1e6:.1f} us  "
              f"1/beta={fit.t_comm / 1e9:.2f} GB/s")
    print(f"[calibrate] {'profiled' if profiled else 'loaded'}: throughputs "
          f"{dataclasses.asdict(profile.throughputs)}, backprop "
          f"{profile.backprop_flops_per_s / 1e12:.2f} TFLOP/s; artifact at {path}")
    return (dataclasses.replace(step_cfg, calibration_path=path),
            {"path": path, "profiled": profiled, "profile": profile.to_dict()})


if __name__ == "__main__":
    main()
