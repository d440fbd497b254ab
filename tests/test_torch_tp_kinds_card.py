"""The card's ``train-tp-kinds`` phase (``chip_smoke.tp_kinds_phase``), run
on the CPU over two gloo processes at reduced widths: each of its six cases
(qwen3-moe's and mixtral's MoE layers, expert- and ff-parallel; hymba's
hybrid layer; an xLSTM group; seamless's decoder layer with an encoder
layer; llama-vision's cross layer) split over a ``(1, 2)`` ``("data",
"model")`` mesh (the MoE routers at ``TP_ROUTER_SCALE`` times their init
scale, ROADMAP §3 fault 14), its loss and gradient held against the
unsplit model's at the phase's tolerances (``TP_LOSS_REL`` 1e-3,
``TP_NORM_REL`` 2e-3, ``TP_GRAD_REL`` 0.1, ``TP_SIGNS`` 0.99, replicated
leaves bitwise across the ranks; measured: at most 3.4e-5, 9.9e-4, 2.6e-2
(seamless's relu, fault 15; the rest below 4.5e-3) and 99.30% of signs).
Then every case marked ``f32``, as the card marks xlstm's: the model also
computing in f32 (``chip_smoke.compute_dtype``), where the split agrees
with the unsplit model to f32 rounding -- held here at 1e-6 relative for
the loss and 1e-5 relative L2 for the gradient (measured: the loss at most
8.5e-8, the gradient at most 3.3e-7) -- and the bf16 split's gradient is
as far from the f32 gradient as the bf16 unsplit one is, within 1.2x
(measured 0.95x to 1.05x).

Also ROADMAP §3 fault 15, which the seamless parity case of
``tests/test_torch_tp_kinds_c.py`` steps around.

The phase's sequence (32) is even, so its split runs also carry the stream
between groups sequence-parallel over the two ranks; the values are those
of the stream kept replicated, bit for bit.
"""

import importlib.util
import os

from helpers import REPO

# the card phase's cases at reduced widths, each branch split at model 2
TINY = {
    "qwen3-moe": {"arch": "qwen3_moe_235b_a22b", "reduced": True, "changes": {"n_layers": 1},
                  "split": {"l0_attn_moe.moe": "experts", "l0_attn_moe.attn": "heads"}},
    "mixtral-moe": {"arch": "mixtral_8x22b", "reduced": True,
                    "changes": {"n_layers": 1, "n_experts": 3},
                    "split": {"l0_attn_local_moe.moe": "ff"}},
    "hymba": {"arch": "hymba_1_5b", "reduced": True,
              "changes": {"n_layers": 1, "n_heads": 5, "n_kv_heads": 5},
              "split": {"l0_hybrid.ssm": "inner"}},
    "xlstm": {"arch": "xlstm_1_3b", "reduced": True,
              "changes": {"n_layers": 2, "slstm_every": 2, "d_model": 48},
              "split": {"l0_mlstm.cell": "inner", "l1_slstm.cell": "ff"}},
    "seamless": {"arch": "seamless_m4t_large_v2", "reduced": True,
                 "changes": {"n_layers": 1, "n_encoder_layers": 1},
                 "split": {"encoder.attn": "heads", "l0_dec_cross_mlp.cross": "heads"}},
    "vision": {"arch": "llama3_2_vision_11b", "reduced": True,
               "changes": {"n_layers": 1, "cross_attn_period": 1, "n_kv_heads": 1},
               "split": {"l0_cross_attn_mlp.cross": "heads"}},
}
SHAPE = (2, 32)



def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gradients(cfg, f32: bool):
    """The reduced model's gradient of one batch, in bf16 or in f32."""
    import torch

    from repro_torch.models import LM, registry

    with _chip_smoke().compute_dtype(torch.float32 if f32 else torch.bfloat16):
        model = LM(cfg, generator=torch.Generator().manual_seed(0))
        batch = registry.make_batch(cfg, 4, 32, generator=torch.Generator().manual_seed(1))
        model.loss(batch)[0].backward()
    return torch.cat([p.grad.double().ravel() for p in model.leaves().values()])


def test_relu_mlp_gradient_parts_with_rounding():
    """ROADMAP §3 fault 15: seamless's relu MLP switches a unit on or off
    where its pre-activation rounds across zero, so the reduced model's bf16
    gradient is 4.4% (relative L2) from its own f32 gradient with 98.7% of
    signs equal (measured), where the same layers with a swiglu MLP are
    0.71% and 99.7% -- gemma2's level, at which the update tolerance of
    these files was set.  Any two implementations that round differently
    part so: the port's unsplit step from the reference by an update of
    relative L2 0.14 at the tolerances' 0.1.  The parity case runs
    seamless's layers with a swiglu MLP; the relu MLP's split is held
    exactly by ``test_card_phase_in_f32_agrees_to_f32_rounding``."""
    import dataclasses

    from repro_torch import configs

    relu = configs.get_config("seamless_m4t_large_v2").reduced()
    gaps = {}
    for name, cfg in (("relu", relu),
                      ("swiglu", dataclasses.replace(relu, mlp_activation="swiglu"))):
        bf16, f32 = _gradients(cfg, False), _gradients(cfg, True)
        gaps[name] = float((bf16 - f32).norm() / f32.norm())
    assert gaps["relu"] > 0.03 and gaps["swiglu"] < 0.01, gaps


def test_card_phase_on_the_cpu():
    rows = _chip_smoke().tp_kinds_phase("cpu", TINY, SHAPE)
    assert [r["case"] for r in rows] == list(TINY)
    for r in rows:
        assert r["loss_rank1"] == r["loss"]
        assert r["signs"] >= 0.99 and r["grad_rel_l2"] <= 0.1, r


def test_card_phase_in_f32_agrees_to_f32_rounding():
    """Every case marked ``f32``: the phase holds the split's f32 loss to
    ``TP_F32_LOSS_REL``, its f32 gradient to ``TP_F32_GRAD_SHARE`` of the
    bf16 rounding's distance and its bf16 gradient's distance from the f32
    one to ``TP_ACCURACY_RATIO`` times the unsplit's; at these widths the
    f32 gradient is well conditioned, and each is held tighter here."""
    rows = _chip_smoke().tp_kinds_phase("cpu", {k: {**v, "f32": True} for k, v in TINY.items()},
                                        SHAPE)
    assert [r["case"] for r in rows] == list(TINY)
    for r in rows:
        f = r["f32"]
        assert f["loss_rel"] <= 1e-6 and f["grad_rel_l2"] <= 1e-5, r
        assert f["bf16_vs_f32_split"] <= 1.2 * f["bf16_vs_f32_unsplit"], r
