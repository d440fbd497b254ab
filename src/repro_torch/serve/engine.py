"""Serving engine (port of ``repro.serve.engine``): batched prefill, then
decode token by token from the KV caches, greedy or with temperature.

Requests are padded into one fixed batch, prefilled together and decoded
together; ``Engine.generate`` is the batch API.

Without a mesh the model computes with its own parameters, replicated.
With one (``Engine(model, config, mesh=, fsdp=)``), as the reference's
serving cells place it (``launch/dryrun.py``): each rank keeps its block
of every parameter in bf16, placed by ``spec_tree_to_pspecs`` (with
``fsdp`` also over ``data``), gathered over ``data`` at use and split over
``model`` by the tensor-parallel plan (``models/tensor_parallel.py``, the
sharded train step's); each ``data`` rank serves its rows of a batch that
``data`` divides (else every rank serves every row); and each cache leaf is
the rank's block of the reference's placement, :func:`cache_pspecs`, read
and written in place (``models/cache_sharding.py``).  A MoE layer gathers
its input's rows over ``data`` and routes them all, then keeps the rank's
own: its token groups and their capacity are the unsplit batch's, as the
reference's global-view program has them.  The logits are
gathered over ``data`` for sampling, so every rank draws the same tokens.
The reference's ``ctx.seq = "data"`` at batch 1 shards the prefill's
activations over ``data``; the port's ``data`` ranks each compute that
prefill whole (the same values).

Greedy decoding is ``argmax``.  With ``temperature > 0`` a token is drawn
from ``softmax(logits / temperature)`` with ``torch.multinomial`` and an
explicit ``torch.Generator`` (the caller's, or one seeded with 0): the
reference's ``jax.random.categorical`` bits cannot be matched, so sampled
tokens agree with the reference's in distribution only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.models import cache_sharding as CS
from repro_torch.models.sharding import local_slice, spec_tree_to_pspecs
from repro_torch.models.tensor_parallel import plan
from repro_torch.models.transformer import LM, _map_cache, init_caches

__all__ = ["ServeConfig", "Engine", "Placement", "build_prefill_step", "build_decode_step",
           "cache_pspecs"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    batch: int = 8
    temperature: float = 0.0  # 0 = greedy
    eos_token: int = -1  # -1: never stop early (generate does not stop early, as the reference)


def cache_pspecs(caches, cfg, global_batch: int, mesh_axes) -> Dict:
    """The reference's ``_cache_pspecs``: per cache leaf (a leading
    ``n_groups`` axis) one mesh axis or None per dim, in the caches'
    structure.  A (G, B, ...) leaf of four or more dims shards its batch
    over ``data`` (when ``data`` divides a batch of more than one) and the
    first trailing dim ``model`` divides over ``model`` (the KV cache's
    sequence); at batch 1 the first trailing dim ``data`` divides takes
    ``data`` instead, and ``model`` the next (KV heads or head_dim).  The
    (G, S) positions and the smaller states are replicated."""
    data_ok = global_batch % mesh_axes.get("data", 1) == 0 and global_batch > 1
    model_n = mesh_axes.get("model", 1)

    def leaf_spec(leaf):
        shp = leaf.shape
        nd = len(shp)
        if nd >= 2 and shp[1] == global_batch and nd >= 4:
            batch_ax = "data" if data_ok else None
            rest = [None] * (nd - 2)
            if not data_ok:
                for i in range(nd - 2):
                    if shp[2 + i] % mesh_axes.get("data", 1) == 0 and shp[2 + i] > 1:
                        rest[i] = "data"
                        break
            for i in range(nd - 2):
                if rest[i] is None and shp[2 + i] % model_n == 0 and shp[2 + i] >= model_n:
                    rest[i] = "model"
                    break
            return (None, batch_ax, *rest)
        if nd == 2:  # (G, S) position arrays
            return (None, None)
        return (None,) * nd

    return {key: _map_cache(leaf_spec, c) for key, c in caches.items()}


class Placement:
    """A model served on a mesh (module docstring): this rank's bf16 block
    of every parameter, the tensor-parallel plan, and the caches' layout."""

    def __init__(self, model: LM, mesh, fsdp: bool = False):
        self.model = model
        self.mesh = mesh
        names = mesh.axis_names
        specs = model.spec()
        self.pspecs = spec_tree_to_pspecs(specs, mesh.shape, fsdp=fsdp)
        coords = dict(zip(names, mesh.coords))
        with torch.no_grad():
            self.blocks = {k: p.detach()[local_slice(self.pspecs[k], p.shape, mesh.shape,
                                                     coords)].to(torch.bfloat16, copy=True)
                           for k, p in model.leaves().items()}
        self.axes = CS.MeshAxes(groups={a: mesh.group(a) for a in names}, sizes=mesh.shape,
                                index={a: mesh.index(a) for a in names})
        model_axis = "model" in names
        self.tp = plan(self.pspecs, specs, mesh.group("model") if model_axis else None,
                       mesh.shape.get("model", 1), mesh.index("model") if model_axis else 0)
        self._specs: Dict = {}

    def data_split(self, global_batch: int) -> bool:
        """Whether each ``data`` rank serves its own rows of the batch."""
        d = self.mesh.shape.get("data", 1)
        return d > 1 and global_batch > 1 and global_batch % d == 0

    def rows(self, t: torch.Tensor, global_batch: int) -> torch.Tensor:
        """This rank's rows of a batch tensor every rank holds whole."""
        return CS.take(t, 0, "data", self.axes) if self.data_split(global_batch) else t

    def all_rows(self, t: torch.Tensor, global_batch: int) -> torch.Tensor:
        """Every rank's rows of a per-rank batch tensor."""
        return CS.gather(t, 0, "data", self.axes) if self.data_split(global_batch) else t

    def cache_specs(self, global_batch: int, max_seq: int, memory_len: Optional[int]):
        """:func:`cache_pspecs` of the whole caches (built on ``meta``, once
        for each shape)."""
        key = (global_batch, max_seq, memory_len)
        if key not in self._specs:
            full = init_caches(self.model.cfg, global_batch, max_seq, memory_len=memory_len,
                               device="meta")
            self._specs[key] = cache_pspecs(full, self.model.cfg, global_batch, self.mesh.shape)
        return self._specs[key]

    def local_caches(self, caches, specs, own_rows: bool = False):
        """This rank's blocks of caches laid out as ``specs``: of whole
        caches, or (``own_rows``) of caches of this rank's rows of a split
        batch, whose replicated leaves are gathered over ``data`` (every
        leaf but the (G, S) positions has its rows on dim 1)."""
        def block(t, spec):
            src = [None] * t.dim()
            if own_rows and t.dim() >= 3:
                src[1] = "data"
            return CS.relayout(t, tuple(src), spec, self.axes).clone()

        return {key: _zip_cache(block, caches[key], specs[key]) for key in caches}

    def new_caches(self, global_batch: int, max_seq: int, memory_len: Optional[int], device):
        """Empty caches, this rank's blocks (one group's whole caches built
        for this rank's rows, sliced, then stacked over the groups), and
        their specs."""
        specs = self.cache_specs(global_batch, max_seq, memory_len)
        rows = global_batch // self.mesh.shape["data"] if self.data_split(global_batch) else (
            global_batch)
        one_group = dataclasses.replace(self.model.cfg, n_layers=len(self.model.pattern))
        one = self.local_caches(init_caches(one_group, rows, max_seq, memory_len=memory_len,
                                            device=device), specs,
                                own_rows=self.data_split(global_batch))
        n = self.model.n_groups
        return {key: _map_cache(lambda t: t.expand((n,) + t.shape[1:]).clone(), c)
                for key, c in one.items()}, specs

    @contextlib.contextmanager
    def placed(self, specs, global_batch: int):
        """The model computing with this rank's blocks (gathered over
        ``data`` where FSDP placed them) under the plan, its caches laid out
        as ``specs``."""
        from repro_torch.train.step import _swapped

        use = {}
        for k, t in self.blocks.items():
            for d, a in enumerate(self.pspecs[k]):
                if a is not None and a != "model":
                    t = CS.gather(t, d, a, self.axes)
            use[k] = t
        per_group = {key: _map_specs(lambda spec: tuple(spec[1:]), s) for key, s in specs.items()}
        self.model._serve = CS.ServeLayout(self.axes, per_group, self.data_split(global_batch))
        try:
            with _swapped(self.model, use, self.tp):
                yield
        finally:
            self.model._serve = None


def _map_specs(fn, specs):
    """A tree of cache specs with ``fn`` applied to every leaf's spec."""
    if isinstance(specs, tuple) and specs and dataclasses.is_dataclass(specs[0]):
        return tuple(_map_specs(fn, s) for s in specs)
    return type(specs)(**{f.name: fn(v) if isinstance(v, tuple) else v
                          for f in dataclasses.fields(specs) for v in (getattr(specs, f.name),)})


def _zip_cache(fn, cache, spec):
    """``cache`` with ``fn(leaf, its spec)`` applied to every tensor leaf."""
    if isinstance(cache, tuple):
        return tuple(_zip_cache(fn, c, s) for c, s in zip(cache, spec))
    return type(cache)(**{f.name: fn(v, getattr(spec, f.name)) if isinstance(v, torch.Tensor)
                          else v for f in dataclasses.fields(cache)
                          for v in (getattr(cache, f.name),)})


def _placement(model: LM, mesh, fsdp: bool) -> Optional[Placement]:
    if mesh is None or isinstance(mesh, Placement):
        return mesh
    return Placement(model, mesh, fsdp)


def build_prefill_step(model: LM, max_seq: Optional[int] = None, *, mesh=None,
                       fsdp: bool = False):
    """``prefill_step(batch) -> (last-position logits (B,1,V), caches)``;
    an arch with a frontend reads ``batch["frontend"]``, which an enc-dec
    arch encodes first (the memory its cross blocks cache).  With ``mesh``
    (a ``launch.mesh.Mesh``, or an engine's :class:`Placement`) the batch
    is this rank's rows of a batch of ``global_batch`` (default: its own
    size), and the caches are the rank's blocks."""
    placement = _placement(model, mesh, fsdp)

    def prefill_step(batch, global_batch: Optional[int] = None):
        if placement is None:
            with torch.no_grad():
                memory = model.frontend_memory(batch.get("frontend"))
            return model.prefill(batch["tokens"], memory=memory, max_seq=max_seq,
                                 last_only=True)
        tokens = batch["tokens"]
        b, s = tokens.shape
        global_batch = global_batch or b
        frontend = batch.get("frontend")
        memory_len = None if frontend is None else frontend.shape[1]
        caches, specs = placement.new_caches(global_batch, max_seq or s, memory_len,
                                             tokens.device)
        with placement.placed(specs, global_batch), torch.no_grad():
            memory = model.frontend_memory(frontend)
            return model.prefill(tokens, memory=memory, max_seq=max_seq, last_only=True,
                                 caches=caches)

    prefill_step.placement = placement
    return prefill_step


def build_decode_step(model: LM, *, mesh=None, fsdp: bool = False):
    """``decode_step(caches, token (B,1), pos) -> (logits (B,1,V), caches)``;
    with ``mesh`` (as :func:`build_prefill_step`'s) ``caches`` are the
    rank's blocks of caches for ``global_batch`` rows and ``max_seq``
    positions (and ``memory_len`` cross slots), ``token`` its rows."""
    placement = _placement(model, mesh, fsdp)

    def decode_step(caches, token, pos, global_batch: Optional[int] = None,
                    max_seq: Optional[int] = None, memory_len: Optional[int] = None):
        if placement is None:
            return model.decode_step(caches, token, pos)
        global_batch = global_batch or token.shape[0]
        specs = placement.cache_specs(global_batch, max_seq, memory_len)
        with placement.placed(specs, global_batch):
            return model.decode_step(caches, token, pos)

    decode_step.placement = placement
    return decode_step


class Engine:
    """Batched generation on top of prefill and decode."""

    def __init__(self, model: LM, config: ServeConfig, *, mesh=None, fsdp: bool = False):
        self.model = model
        self.config = config
        self.placement = _placement(model, mesh, fsdp)
        self._prefill = build_prefill_step(model, config.max_seq, mesh=self.placement)
        self._decode = build_decode_step(model, mesh=self.placement)

    def _sample(self, logits: torch.Tensor, generator: Optional[torch.Generator]):
        last = logits[:, -1]
        if self.config.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / self.config.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(self, prompts: torch.Tensor, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 timings: Optional[dict] = None,
                 frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompts (B, S_prompt) -> (B, S_prompt + max_new_tokens) int64;
        ``frontend`` (B, S_front, D): the frontend embeddings of an arch that
        takes them.

        ``timings``, when given, receives ``prefill_s`` (the encoder's pass
        included) and ``decode_s`` (the host clock around each part,
        synchronized on the card) and ``decode_steps``."""
        if generator is None and self.config.temperature > 0.0:
            generator = torch.Generator(device=prompts.device).manual_seed(0)
        prompts = prompts.long()
        b, s = prompts.shape
        sync = (torch.cuda.synchronize if prompts.device.type == "cuda" and timings is not None
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        place = self.placement
        rows = (lambda t: t) if place is None else (lambda t: place.rows(t, b))
        every = (lambda t: t) if place is None else (lambda t: place.all_rows(t, b))
        batch = {"tokens": rows(prompts)}
        if frontend is not None:
            batch["frontend"] = rows(frontend)
        if place is None:
            logits, caches = self._prefill(batch)
            decode = self._decode
        else:
            logits, caches = self._prefill(batch, global_batch=b)
            memory_len = None if frontend is None else frontend.shape[1]
            max_seq = self.config.max_seq

            def decode(c, t, pos):
                return self._decode(c, t, pos, global_batch=b, max_seq=max_seq,
                                    memory_len=memory_len)
        tok = self._sample(every(logits), generator)[:, None]
        sync()
        t1 = time.perf_counter()
        tokens = [prompts]
        for i in range(max_new_tokens):
            tokens.append(tok)
            if i == max_new_tokens - 1:
                break
            logits, caches = decode(caches, rows(tok), s + i)
            tok = self._sample(every(logits), generator)[:, None]
        sync()
        if timings is not None:
            timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                           decode_steps=max(max_new_tokens - 1, 0))
        return torch.cat(tokens, dim=1)
