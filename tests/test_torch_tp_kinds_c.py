"""Tensor parallelism for every layer kind, continued
(``tests/test_torch_tp_kinds.py`` holds the machinery, the tolerances and
the MoE cases): seamless's ``dec_cross_mlp`` with its encoder (self and
cross attention, the MLP and the encoder's attention and MLP all split, the
memory ``copy``'d into the cross blocks; under ``remat="full"``; its layers
with a swiglu MLP in place of the relu, ROADMAP §3 fault 15) and
llama-vision's group with its ``cross_attn_mlp`` over 16 patches, at one
kv head, which ``model`` 2 does not divide (the cross ``wk``/``wv``
replicate and each rank gathers the kv head of its query heads) and its
``cross_gate`` opened to 0.5 in both packages (at zero it takes the cross
block out of the loss), each with FSDP off and on, against the
reference's ``pjit`` and the port's replicated step.
"""

import pytest

from test_torch_tp_kinds import (_runs_for, check_local_blocks, check_matches_reference,
                                 check_matches_replicated_port)

CASES = {
    # seamless's layers with a swiglu MLP in place of its relu: ROADMAP §3
    # fault 15 (tests/test_torch_tp_kinds_card.py)
    "seamless": ("seamless_m4t_large_v2", {"remat": "full", "mlp_activation": "swiglu"}),
    "vision": ("llama3_2_vision_11b", {"n_kv_heads": 1}),
}
SPLITS = {
    "seamless": {"layers.l0_dec_cross_mlp.attn": "heads",
                 "layers.l0_dec_cross_mlp.cross": "heads", "layers.l0_dec_cross_mlp.mlp": "ff",
                 "encoder.attn": "heads", "encoder.mlp": "ff"},
    "vision": {"layers.l4_cross_attn_mlp.cross": "heads", "layers.l4_cross_attn_mlp.mlp": "ff"},
}
KEYS = [n + f for n in CASES for f in ("", "_fsdp")]



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs_for(CASES, tmp_path_factory)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_match_reference(runs, key):
    check_matches_reference(runs, key)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_match_replicated_port(runs, key):
    check_matches_replicated_port(runs, key)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_local_blocks_are_their_placements_slices(runs, key):
    check_local_blocks(runs, key, SPLITS[key.removesuffix("_fsdp")])
