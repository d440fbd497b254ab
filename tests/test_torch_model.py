"""Port parity of the model: reduced gemma2 loss and gradients against the
reference through ``convert.params_from_jax``, and the flat gradient order.

Tolerances: the loss within 1e-2 relative and every gradient leaf within
5e-2 relative L2 error -- both frameworks compute in bf16 (params cast at
use, f32 reductions), but round and accumulate bf16 matmuls and the
attention softmax at different places; bf16 keeps about 3 significant
digits.  The flat vector order is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import reducers as jred
from repro.models import registry
from repro_torch import configs, convert
from repro_torch.comms import reducers as tred
from repro_torch.models import LM


@pytest.fixture(scope="module")
def pair():
    jcfg = registry.get_config("gemma2_2b").reduced()
    jmodel = registry.build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = LM(configs.get_config("gemma2_2b").reduced(), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 40)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return jmodel, params, tmodel, batch


def test_param_layout_matches(pair):
    jmodel, params, tmodel, _ = pair
    flat_j = {".".join(k.key for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    flat_t = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert flat_t == flat_j
    # the sliding window (32) is shorter than the sequence, so it matters
    assert tmodel.cfg.sliding_window == 32 and tmodel.cfg.layer_pattern() == (
        "attn_local_mlp", "attn_mlp")
    back = convert.params_to_jax(tmodel.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))


def test_loss_and_gradients_match(pair):
    jmodel, params, tmodel, batch = pair

    def loss_fn(p):
        return jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    tloss, metrics = tmodel.loss({k: torch.from_numpy(v).long() for k, v in batch.items()})
    tloss.backward()
    assert abs(float(tloss) - float(jloss)) <= 1e-2 * abs(float(jloss))
    assert float(metrics["aux"]) == 0.0
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = ".".join(k.key for k in path)
        tg = dict(tmodel.named_parameters())[name].grad.numpy()
        jg = np.asarray(jg)
        rel = np.linalg.norm(tg - jg) / max(np.linalg.norm(jg), 1e-12)
        assert rel <= 5e-2, (name, rel)


def test_flatten_tree_order_matches(pair):
    _, params, tmodel, _ = pair
    jflat, _, _ = jred.flatten_tree(params)
    tflat, specs = tred.flatten_tree(tmodel.leaves())
    np.testing.assert_array_equal(np.asarray(jflat), tflat.detach().numpy())
    back = tred.unflatten_tree(tflat, specs)
    for name, p in tmodel.leaves().items():
        assert torch.equal(back[name], p.detach())
    assert tred.residual_size(tmodel.leaves()) == jflat.shape[0]


def test_full_width_parameter_count():
    """gemma2_2b at full width: 4 layers give 901,271,808 parameters."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_config("gemma2_2b"), n_layers=4)
    assert cfg.param_count() == 901_271_808
    jcfg = dataclasses.replace(registry.get_config("gemma2_2b"), n_layers=4)
    assert jcfg.param_count() == cfg.param_count()
