"""Serving CLI of the port (the flags of ``repro.launch.serve``, plus
``--n-layers``, ``--seed`` and ``--device``).

Standalone (weights drawn from ``--seed``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \\
        --batch 8 --prompt-len 512 --new-tokens 32

Replica mode: tail a training job's delta ring (``--publish-dir`` of
``launch.train``), fold every compressed weight delta into the replica
state, and generate with the final weights once the publisher closes the
stream; arch, ``reduced`` and ``n_layers`` come from the ring's manifest:

    PYTHONPATH=src python -m repro_torch.launch.serve --follow /path/to/ring

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU.  ``--arch`` takes the arch names of ``launch.train``, and
``--n-layers`` follows its rules (an enc-dec arch's encoder gets as many
layers).  Prompts are drawn from ``--seed``; greedy unless
``--temperature``.  An arch with a frontend gets its embeddings
(``registry.frontend_len`` positions: the prompt's length of audio frames,
or a vision arch's patches), N(0, 1) x 0.02 drawn after the prompts from
the same generator, as ``registry.make_batch`` draws them; the reference
CLI passes none, and its engine raises ``KeyError: 'frontend'``.  Prints
the tokens and one ``[serve]`` line of prefill and decode times.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, device as device_mod
from repro_torch.models import build, registry
from repro_torch.serve import Engine, ReplicaSubscriber, ServeConfig


def _config(arch: str, reduced: bool, n_layers):
    cfg = configs.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = registry.with_depth(cfg, n_layers)
    return cfg


def _follow_ring(args, dev, timings):
    """-> (config, model holding the ring's final weights, subscriber);
    ``timings["follow_s"]``: from the subscriber's first manifest read to
    the weights loaded into the model."""
    t0 = time.perf_counter()
    sub = ReplicaSubscriber(args.follow, device=dev)
    meta = sub.meta
    cfg = _config(meta.get("arch", args.arch), bool(meta.get("reduced", args.reduced)),
                  meta.get("n_layers", args.n_layers))

    def on_sync(stats):
        print(f"[serve] v{stats.version}: +{stats.applied} deltas, "
              f"{stats.bytes_read} bytes, "
              f"{stats.decompress_count} decompress"
              + (", snapshot fallback" if stats.gap_detected else ""))

    final_version = sub.follow(timeout_s=args.follow_timeout, on_sync=on_sync)
    model = build(cfg, device=dev)
    with torch.no_grad():
        for name, leaf in sub.params_like(model.leaves()).items():
            model.get_parameter(name).copy_(leaf)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings["follow_s"] = time.perf_counter() - t0
    print(f"[serve] ring closed at v{final_version}; weights loaded")
    return cfg, model, sub


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b", choices=registry.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers at full width")
    ap.add_argument("--follow", default=None, metavar="RING_DIR",
                    help="replica mode: tail this delta ring until the publisher closes "
                         "it, then serve the final weights")
    ap.add_argument("--follow-timeout", type=float, default=300.0,
                    help="give up if the ring is not closed after this many seconds")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a GPU the default raises")
    return ap


def main(argv=None):
    """Returns ``{"tokens", "prompts", "frontend", "model", "config",
    "timings", "subscriber"}`` (the frontend None for an arch without one,
    the subscriber None when standalone; ``timings`` as ``Engine.generate``
    fills them, plus ``follow_s`` with ``--follow``)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.follow is None:
        registry.check_arch(ap, args.arch, args.n_layers)
    dev = device_mod.resolve(args.device)
    sub, timings = None, {}
    if args.follow is not None:
        cfg, model, sub = _follow_ring(args, dev, timings)
    else:
        cfg = _config(args.arch, args.reduced, args.n_layers)
        model = build(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(args.seed))
    engine = Engine(model, ServeConfig(max_seq=args.prompt_len + args.new_tokens + 8,
                                       batch=args.batch, temperature=args.temperature))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    fl = registry.frontend_len(cfg, args.prompt_len)
    frontend = (torch.randn((args.batch, fl, cfg.d_model), generator=gen, device=dev) * 0.02
                if fl else None)
    out = engine.generate(prompts, args.new_tokens, generator=gen, timings=timings,
                          frontend=frontend)
    print(out)
    steps = timings["decode_steps"]
    print(f"[serve] prefill {timings['prefill_s'] * 1e3:.1f} ms ({args.batch} x "
          f"{args.prompt_len}); decode {timings['decode_s'] * 1e3 / max(steps, 1):.2f} ms a "
          f"step over {steps} steps; {args.batch * steps / max(timings['decode_s'], 1e-9):.1f} "
          "decoded tokens/s")
    return {"tokens": out, "prompts": prompts, "frontend": frontend, "model": model,
            "config": cfg, "timings": timings, "subscriber": sub}


if __name__ == "__main__":
    main()
