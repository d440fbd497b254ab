"""Cells at reduced widths for the CPU tests: the cell's own traffic and
code path, with the model cut to a few thousand parameters, 32 positions a
row and buckets of 0.05 MiB (four chunks), so a run takes seconds."""

from __future__ import annotations

import copy
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.append(path)

from perfbench import program, spec  # noqa: E402

SEQ = 32
BUCKET_MB = 0.05
# the limits of the reduced cells, from their readings on the CPU (seeds 1-3):
# program against reference loss <= 4.5e-5, grad <= 3.3e-3, change <= 4.2e-3;
# the control (float32 state in bfloat16) change >= 0.128; half the batch
# grad >= 0.034, change >= 0.042
TINY_LIMIT = 0.02


def cell(name: str):
    """(cell at reduced widths, its ArchConfig)."""
    c = spec.load_cell(name)
    c.traffic.data = copy.deepcopy(c.traffic.data)
    c.traffic.data["seq"] = c.traffic.data["frames"] = SEQ
    if "reducer" in c.traffic.data:
        c.traffic.data["reducer"]["bucket_mb"] = BUCKET_MB
    over = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                n_layers=2)
    if c.config.arch.get("n_encoder_layers"):
        over.update(n_kv_heads=4, n_encoder_layers=2)
    arch = program.arch_config(c, over)
    c.config.data = dict(c.config.data, arch=dataclasses.asdict(arch))
    c.limits = {k: {"limit": TINY_LIMIT} for k in ("loss", "grad", "change")}
    return c, arch
