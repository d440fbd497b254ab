"""``remat`` in the port: ``cfg.remat`` checkpoints each group of the stack
(and each encoder layer) as the reference's ``jax.checkpoint`` of its scan
body, ``"dots"`` keeping the weight products as
``dots_with_no_batch_dims_saveable`` does.

* ``full``, ``dots`` and ``none`` give bitwise-equal losses and gradients
  (backward recomputes the same ops on the same inputs) on gemma2, hymba,
  seamless and llama-vision at ``reduced()`` size.
* What each mode keeps and recomputes, counted on gemma2: the autograd
  graph's saved bytes under ``full`` are a fraction of ``none``'s; in the
  backward pass ``full`` reruns the forward pass's weight products and its
  batched (attention) products, ``dots`` only the batched ones.
* The port under ``full`` against the reference under ``full`` on the same
  weights and batch, at ``tests/test_torch_zoo.py``'s bounds (loss 1e-2
  relative, every gradient leaf 5e-2 relative L2), the reference compiled
  with ``xla_allow_excess_precision`` off as in
  ``tests/test_torch_encdec.py`` (llama-vision's ``cross_gate`` held there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import registry as jreg
from repro_torch import configs, convert
from repro_torch.models import LM, registry as treg

ARCHS = ("gemma2_2b", "hymba_1_5b", "seamless_m4t_large_v2", "llama3_2_vision_11b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models are tiny: one intra-op thread runs them as fast as a pool
    and keeps the parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _model(arch, remat):
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), remat=remat)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("cross_gate"):
                p.fill_(0.5)
    return model


def _batch(cfg):
    return treg.make_batch(cfg, 2, 20, generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_number(arch, remat):
    plain = _model(arch, "none")
    batch = _batch(plain.cfg)
    loss, metrics = plain.loss(batch)
    loss.backward()
    model = _model(arch, remat)
    got, got_metrics = model.loss(batch)
    got.backward()
    assert torch.equal(got.detach(), loss.detach())
    assert all(torch.equal(got_metrics[k], metrics[k]) for k in metrics)
    for name, p in plain.named_parameters():
        assert torch.equal(model.get_parameter(name).grad, p.grad), name


class _Products(TorchDispatchMode):
    """Counts the matrix products run: ``weight`` (``mm``, ``addmm`` and an
    einsum's ``bmm`` of one batch) and ``batched`` (``bmm`` over batch and
    heads)."""

    def __init__(self):
        super().__init__()
        self.counts = {"weight": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.counts["weight"] += 1
        elif func == torch.ops.aten.bmm.default:
            self.counts["weight" if args[0].shape[0] == 1 else "batched"] += 1
        return func(*args, **(kwargs or {}))


def test_what_each_mode_keeps_and_recomputes():
    batch = _batch(configs.get_config("gemma2_2b").reduced())
    saved, backward = {}, {}
    for remat in ("none", "full", "dots"):
        model = _model("gemma2_2b", remat)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss(batch)[0]
        saved[remat] = total[0]
        with _Products() as products:
            loss.backward()
        backward[remat] = products.counts
    assert saved["full"] < saved["none"] / 4
    # a layer's forward pass runs 7 weight products (q, k, v and o as
    # einsums, the MLP's gate, up and down as mm) and 2 batched ones; the
    # recompute stops once every saved tensor is back (a group's last
    # product is not needed)
    assert backward["full"]["weight"] > backward["none"]["weight"]
    assert backward["dots"]["weight"] == backward["none"]["weight"]
    assert backward["dots"]["batched"] == backward["full"]["batched"] \
        == backward["none"]["batched"] + 2 * 2 * 2


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


@pytest.mark.parametrize("arch", ["gemma2_2b", "seamless_m4t_large_v2"])
def test_full_remat_matches_reference(arch):
    jcfg = dataclasses.replace(jreg.get_config(arch).reduced(), remat="full")
    jmodel = jreg.build(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if jcfg.frontend != "none":
        batch["frontend"] = (rng.normal(size=(2, 24, jcfg.d_model)) * 0.02).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0])
    jloss, jgrads = _compiled(loss_fn, params, jbatch)(params, jbatch)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), remat="full")
    model = LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params))
    loss, _ = model.loss({k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                          else torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-2 * abs(float(jloss))
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = ".".join(k.key for k in path)
        assert _rel(model.get_parameter(name).grad, jg) <= 5e-2, name
