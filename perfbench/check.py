"""The comparison that decides ``correct``.

Three numbers, each a relative gap between the program and the reference
over the first ``warmup_steps`` steps (the same weights and rows on both
sides):

* ``loss``: the largest |program - reference| / reference of a step's loss
  (read in every cell, compared where a control or a fault reads ten times
  its sound runs: ``limits/<cell>.json``);
* ``grad``: the first gradient as the optimizer receives it (the mean the
  exchange gives, clipped), by the worst leaf: |the program's norm - the
  reference's| over the larger of the reference's norm of that leaf and of
  the median leaf;
* ``change``: the parameters' change after the steps, by the worst leaf,
  measured the same way, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (the others move under AdamW by
  round-off alone).

A leaf missing on either side, or of another shape, reads 1; so does a
number that is not finite.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

MOVED = 1e-3  # a leaf counts for `change` if its gradient is >= this x the median leaf's


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> float:
    if not keys:
        return 1.0
    floor = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        if k not in prog:
            return 1.0
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        if not math.isfinite(gap):
            return 1.0
        worst = max(worst, gap)
    return worst


def numbers(prog, ref) -> Dict[str, float]:
    """``prog``: the program's readings (``loss``, ``grad``, ``change``,
    ``shapes``); ``ref``: the reference's."""
    if {k: list(v) for k, v in prog["shapes"].items()} != ref["shapes"]:
        return {"loss": 1.0, "grad": 1.0, "change": 1.0}
    loss = 1.0
    if len(prog["loss"]) == len(ref["loss"]):
        loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
        loss = loss if math.isfinite(loss) else 1.0
    keys = sorted(ref["grad"])
    floor = statistics.median(ref["grad"].values())
    moved = [k for k in keys if ref["grad"][k] >= MOVED * floor]
    return {"loss": loss, "grad": _leaf_gap(prog["grad"], ref["grad"], keys),
            "change": _leaf_gap(prog["change"], ref["change"], moved)}


def compared(limits: Dict) -> List[str]:
    """The numbers a cell holds to a limit; a number with no upper reading
    (no control or fault reads far enough above its sound runs) is read
    and printed, not compared."""
    return [k for k, v in limits.items() if v.get("compared", True)]


def verdict(nums: Dict[str, float], limits: Dict) -> bool:
    return all(nums[k] <= limits[k]["limit"] for k in compared(limits))
