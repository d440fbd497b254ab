"""Port parity of what the convergence lab trains: the convnet
(``models/convnet.py``) and its image stream (``data/synthetic.py``), the
LM's untied output head, ``convert.py`` over both, and the training loop on
an image stream.

Tolerances.  The convnet computes in float32 in both packages; its
convolutions (cuDNN or oneDNN against XLA's) sum in other orders: logits,
loss and every gradient leaf within 1e-5 relative L2 (measured 1.3e-7 and
4.3e-6), ``acc`` exactly.  The prototype upsample against
``jax.image.resize(..., "linear")`` within 1e-6 absolute (measured 2.4e-7).
The untied LM computes in bf16 as the tied one does
(``tests/test_torch_model.py``): the loss within 1e-2 relative, each
gradient leaf within 5e-2 relative L2, prefill and decode logits within
5e-2 absolute (``tests/test_torch_serve.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.models.convnet import ConvConfig as JConvCfg, ConvNet as JConvNet
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.comms.reducers import flatten_tree
from repro_torch.configs.base import ArchConfig
from repro_torch.data import ImageConfig, ImageStream
from repro_torch.data.synthetic import upsample_prototypes
from repro_torch.models.convnet import ConvConfig, ConvNet
from repro_torch.models.transformer import LM
from repro_torch.optim import OptConfig
from repro_torch.train import StepConfig, TrainLoopConfig, init_state, train_loop
from repro_torch.train.loop import _batch_tokens

LAB_CONV = dict(n_classes=8, widths=(8, 16), blocks_per_stage=1, img_size=16)
REL_L2 = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kw", [LAB_CONV, {}], ids=["lab", "default"])
def test_convnet_matches_reference(kw):
    jmodel = JConvNet(JConvCfg(**kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = ConvNet(ConvConfig(**kw))
    tmodel.load_state_dict(convert.params_from_jax(_params(params)))
    cfg = jmodel.cfg
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((4, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 4).astype(np.int32)
    jbatch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    tbatch = {"images": torch.from_numpy(imgs), "labels": torch.from_numpy(labels).long()}

    jlogits = jax.jit(jmodel.forward)(params, jbatch["images"])
    assert _rel(tmodel(tbatch["images"]).detach(), jlogits) <= REL_L2
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch), has_aux=True))(params)
    tloss, taux = tmodel.loss(tbatch)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= REL_L2 * abs(float(jloss))
    assert float(taux["acc"]) == float(jaux["acc"])
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert _rel(g, jgrads[k]) <= REL_L2, k
    # the flat gradient in the reference's leaf order
    jflat = np.concatenate([np.asarray(jgrads[k]).reshape(-1) for k in sorted(jgrads)])
    tflat, _ = flatten_tree(grads)
    assert _rel(tflat, jflat) <= REL_L2


def test_convnet_convert_roundtrip_and_layout():
    params = _params(JConvNet(JConvCfg(**LAB_CONV)).init(jax.random.PRNGKey(1)))
    tmodel = ConvNet(ConvConfig(**LAB_CONV))
    shapes = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert shapes == {k: v.shape for k, v in params.items()}
    assert shapes["s1b0_proj"] == (1, 1, 8, 16) and shapes["head"] == (16, 8)
    tmodel.load_state_dict(convert.params_from_jax(params))
    back = convert.params_to_jax(tmodel.state_dict())
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    # seeded init: conv kernels He-scaled, head 0.02
    a = ConvNet(ConvConfig(**LAB_CONV), generator=torch.Generator().manual_seed(3))
    b = ConvNet(ConvConfig(**LAB_CONV), generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in shapes)
    assert abs(float(a.state_dict()["stem"].std()) - (2.0 / 27) ** 0.5) < 0.1


@pytest.mark.parametrize("size", [16, 32])
def test_prototype_upsample_matches_jax_resize(size):
    coarse = np.random.default_rng(size).standard_normal((8, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (8, size, size, 3),
                                       method="linear"))
    got = upsample_prototypes(torch.from_numpy(coarse), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_image_stream_is_a_function_of_seed_step_and_host():
    cfg = ImageConfig(n_classes=8, img_size=16, global_batch=8, seed=5)
    a, b = ImageStream(cfg), ImageStream(cfg)
    x, y = a.batch_at(3), b.batch_at(3)
    assert x["images"].shape == (8, 16, 16, 3) and x["images"].dtype == torch.float32
    assert x["labels"].shape == (8,) and x["labels"].dtype == torch.int64
    assert int(x["labels"].max()) < 8 and int(x["labels"].min()) >= 0
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a.batch_at(4)["images"], x["images"])
    h0, h1 = a.batch_at(3, host_index=0, num_hosts=2), a.batch_at(3, host_index=1, num_hosts=2)
    assert h0["images"].shape == (4, 16, 16, 3)
    assert not torch.equal(h0["images"], h1["images"])
    assert torch.equal(a.batch_at(3, 1, 2)["labels"], h1["labels"])
    other = ImageStream(dataclasses.replace(cfg, seed=6)).batch_at(3)
    assert not torch.equal(other["images"], x["images"])
    # the class signal: each image is its prototype plus noise of scale 0.5
    resid = x["images"] - a._protos[x["labels"]]
    assert abs(float(resid.std()) - 0.5) < 0.05
    assert a.entropy_floor() == 0.0


def test_train_loop_runs_on_image_stream():
    model = ConvNet(ConvConfig(**LAB_CONV), generator=torch.Generator().manual_seed(0))
    stream = ImageStream(ImageConfig(n_classes=8, img_size=16, global_batch=8))
    assert _batch_tokens(stream.batch_at(0)) == 8
    assert _batch_tokens({"tokens": torch.zeros(2, 5), "targets": torch.zeros(2, 5)}) == 10
    opt = OptConfig(kind="sgd", lr=0.1)
    out = train_loop(model, opt, StepConfig(mode="pjit"), init_state(model, opt), stream,
                     TrainLoopConfig(total_steps=3, log_every=1))
    losses = [row["loss"] for row in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all("acc" in row for row in out["history"])


def _untied_pair():
    kw = dict(name="lab-lm", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=64, tie_embeddings=False)
    jmodel = JLM(JArch(**kw, remat="none"))
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = LM(ArchConfig(**kw), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(_params(params)))
    return jmodel, params, tmodel


def test_untied_lm_matches_reference():
    jmodel, params, tmodel = _untied_pair()
    assert tuple(tmodel.embed["head"].shape) == (64, 128)
    assert tmodel.cfg.param_count() == sum(p.numel() for p in tmodel.parameters())
    toks = np.random.default_rng(0).integers(0, 64, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    tloss, _ = tmodel.loss({k: torch.from_numpy(v).long() for k, v in batch.items()})
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-2 * abs(float(jloss))
    named = dict(tmodel.named_parameters())
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = ".".join(k.key for k in path)
        assert _rel(named[name].grad, jg) <= 5e-2, name
    assert float(named["embed.head"].grad.norm()) > 0

    prompt = toks[:, :24]
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, t, max_seq=32))(params, jnp.asarray(prompt))
    tl, tc = tmodel.prefill(torch.from_numpy(prompt).long(), max_seq=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=5e-2)
    nxt = toks[:, 24:25]
    jd, _ = jax.jit(jmodel.decode_step)(params, jc, jnp.asarray(nxt), 24)
    td, _ = tmodel.decode_step(tc, torch.from_numpy(nxt).long(), 24)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=5e-2)
    # the head, not the table's transpose, makes the logits
    with torch.no_grad():
        tmodel.embed["head"].zero_()
    assert float(tmodel(torch.from_numpy(prompt).long())[0].abs().max()) == 0.0
