"""Tensor parallelism for every layer kind, continued
(``tests/test_torch_tp_kinds.py`` holds the machinery, the tolerances and
the MoE cases): hymba's ``hybrid`` layer (5 heads, which ``model`` 2 does
not divide: the attention replicates and the SSM splits over ``d_inner``)
and an xLSTM group of one mLSTM and one sLSTM layer (``d_model`` 48: the
mLSTM splits over ``d_inner``, its 4 heads' gate biases gathered whole, and
the sLSTM's FFN of 64 splits over ``ff``), each with FSDP off and on,
against the reference's ``pjit`` and the port's replicated step.

A naive ``torch.chunk`` of a split ``in_proj``'s local block -- at
``model`` 2, rank 0's block is all of ``x`` and rank 1's all of ``z`` -- is
caught: the hybrid case run so moves its update 0.95 relative L2 from the
reference's, with 76% of its signs equal (measured on the CPU; the SSM's
output is small at init, so the loss moves by 3.9e-4 relative only).
"""

import numpy as np
import pytest

from test_torch_tp_kinds import (_check_update, _full, _initial, _port, _runs_for, _update,
                                 check_local_blocks, check_matches_reference,
                                 check_matches_replicated_port)

CASES = {
    "hymba": ("hymba_1_5b", {"n_heads": 5, "n_kv_heads": 5}),
    "xlstm": ("xlstm_1_3b", {"slstm_every": 2, "d_model": 48}),
}
SPLITS = {
    "hymba": {"layers.l0_hybrid.ssm": "inner"},
    "xlstm": {"layers.l0_mlstm.cell": "inner", "layers.l1_slstm.cell": "ff"},
}
KEYS = [n + f for n in CASES for f in ("", "_fsdp")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs_for(CASES, tmp_path_factory, naive=("hymba",))


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_match_reference(runs, key):
    check_matches_reference(runs, key)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_match_replicated_port(runs, key):
    check_matches_replicated_port(runs, key)


@pytest.mark.parametrize("key", KEYS)
def test_tp_kinds_local_blocks_are_their_placements_slices(runs, key):
    check_local_blocks(runs, key, SPLITS[key.removesuffix("_fsdp")])


def test_naive_chunk_of_a_split_in_proj_is_caught(runs):
    """The hybrid case with ``TensorParallel.halves`` replaced by the local
    block as it is: its update leaves the reference's tolerance, where
    ``halves`` keeps it within."""
    p0 = _initial(runs, "hymba")
    ref = np.load(f"{runs}.hymba.jax.npz")
    upd_j = _update({k: ref[k] for k in p0}, p0)
    upd_t = _update(_full(_port(runs, "hymba_naive")[0]), p0)
    assert np.linalg.norm(upd_t - upd_j) > 0.5 * np.linalg.norm(upd_j)
    assert np.mean(np.sign(upd_t) == np.sign(upd_j)) < 0.9
    _check_update(_update(_full(_port(runs, "hymba")[0]), p0), upd_j)
