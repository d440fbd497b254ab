"""The dry-run's inputs and cache placement against the reference's, for
every arch x shape: ``cell_is_supported``; ``registry.input_specs``' names,
shapes and dtypes (each decode cache leaf against the reference's
``jax.eval_shape``); and the serving caches' placement,
``serve.engine.cache_pspecs``, against the reference's ``_cache_pspecs`` on
the axis sizes of both production meshes, exactly.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when it is imported; it is imported here with JAX's backend
already up and the variable restored after, so no later test in the
worker sees another device count.
"""

import dataclasses
import os

import jax
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.models import registry as jreg
from repro_torch.configs import SHAPES
from repro_torch.models import registry
from repro_torch.models.transformer import init_caches
from repro_torch.serve.engine import cache_pspecs

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
CELLS = [(a, s) for a in registry.ARCH_NAMES for s in SHAPES]


def _reference_dryrun():
    jax.devices()  # the backend is up: the import's XLA_FLAGS cannot change it
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _leaves(tree, prefix=""):
    """path -> leaf over dicts, pairs and cache dataclasses (tensors, shape
    structs or specs: whatever is not a bool)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)) and tree and dataclasses.is_dataclass(tree[0]):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if not isinstance(v, bool):
                out.update(_leaves(v, f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: tree}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    assert registry.cell_is_supported(arch, SHAPES[shape]) == jreg.cell_is_supported(
        arch, JSHAPES[shape])
    ours = registry.input_specs(registry.get_config(arch), SHAPES[shape])
    ref = jreg.input_specs(jreg.get_config(arch), JSHAPES[shape])
    assert list(ours) == list(ref)
    ours, ref = _leaves(ours), _leaves(ref)
    assert list(ours) == list(ref)
    for path, t in ours.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", path
        assert tuple(t.shape) == tuple(ref[path].shape), path
        assert _dtype(t) == str(ref[path].dtype), path


def test_input_specs_under_fake_mode_are_fakes():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    with FakeTensorMode():
        specs = registry.input_specs(registry.get_config("hymba_1_5b"), SHAPES["decode_32k"],
                                     device="cpu")
    leaves = _leaves(specs)
    assert leaves and all(isinstance(t, FakeTensor) for t in leaves.values())


@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
def test_cache_pspecs_equal_reference(mesh):
    dryrun = _reference_dryrun()
    for arch, shape in CELLS:
        if registry.cell_is_supported(arch, SHAPES[shape]):
            continue
        sh, jsh = SHAPES[shape], JSHAPES[shape]
        jcfg = jreg.get_config(arch)
        jmodel = jreg.build(jcfg)
        jcaches = jax.eval_shape(lambda: jmodel.init_caches(jsh.global_batch, jsh.seq_len))
        ref = _leaves(dryrun._cache_pspecs(jcaches, jcfg, jsh, mesh))
        cfg = registry.get_config(arch)
        ours = _leaves(cache_pspecs(init_caches(cfg, sh.global_batch, sh.seq_len, device="meta"),
                                    cfg, sh.global_batch, mesh))
        assert list(ours) == list(ref), (arch, shape)
        for path, spec in ours.items():
            assert spec == tuple(ref[path]), (arch, shape, path, spec, ref[path])


@pytest.mark.parametrize("arch", ["gemma2_2b", "qwen1_5_110b", "mixtral_8x22b",
                                  "qwen3_moe_235b_a22b"])
def test_active_param_count_equals_reference(arch):
    """The roofline's useful-flops count: the reference's analytic count,
    where its ``param_count`` is the spec's (ROADMAP §3 lists the archs
    where it is not)."""
    assert registry.get_config(arch).active_param_count() == jreg.get_config(
        arch).active_param_count()
