"""``chip_smoke.serve_sharded_phase`` -- the card's ``serve-sharded`` --
on the CPU at the archs' reduced widths: its two gloo processes on a
``(1, 2)`` ``("data", "model")`` mesh, the f32 gap to the unsplit model,
the bf16 accuracy hold, the greedy tokens and each rank's cache bytes.
``tests/test_torch_serve_sharded.py`` holds the sharded engine against
the reference."""

import sys

from helpers import REPO


def test_card_phase_at_reduced_widths():
    """``chip_smoke.serve_sharded_phase`` on the CPU at the archs' reduced
    widths: its two gloo processes, the f32 gap, the accuracy hold, the
    greedy tokens and the cache bytes."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cases = {"gemma2": ("gemma2_2b", 4, 4, 40, 6), "gemma2-batch1": ("gemma2_2b", 4, 1, 40, 6),
             "xlstm-group": ("xlstm_1_3b", 8, 2, 24, 4)}
    rows = chip_smoke.serve_sharded_phase("cpu", cases, reduced=True)
    assert [r["case"] for r in rows] == list(cases)
    for r in rows:
        assert r["gap_f32"] <= 1e-5 and r["tokens_equal"] and not r["launched"], r
        # each rank holds about half the caches; the positions are replicated
        assert r["cache_bytes_whole"] <= r["cache_bytes_total"] < 1.05 * r["cache_bytes_whole"]
