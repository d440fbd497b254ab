"""Three-term roofline of a traced step (port of ``repro.analysis.roofline``),
priced for the NVIDIA H100.

Hardware model (:data:`H100`, per GPU; data-sheet figures of the H100 SXM
80GB at its 700 W limit, not measurements):
    peak bf16 dense compute  989.4 TFLOP/s
    HBM3 bandwidth           3.35 TB/s
    NVLink                   450 GB/s a direction (intra-node collectives)
    InfiniBand NDR           50 GB/s a GPU (inter-node)
    8 GPUs a node

Terms (seconds, per training/serving step), the reference's formulas:
    compute    = flops_per_device / peak_flops
    memory     = bytes_per_device / hbm_bw
    collective = ici_link_bytes / ici_bw + dcn_link_bytes / dcn_bw

The charge rule is the reference code's: every link byte at the intra-island
rate (``ici_bw``, here NVLink) and ``dcn_bytes`` 0.  The reference's
docstring promises ``group_size > chips_per_pod -> DCN``, which its code
never applies (ROADMAP.md §3); the port keeps the code's rule.

MODEL_FLOPS (the "useful" numerator): 6*N*D for a train step, 2*N*D for a
decode/prefill forward (N = active params for MoE, D = tokens in the step).
ratio = MODEL_FLOPS / (flops_per_device * chips).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["HW", "H100", "RooflineTerms", "compute_roofline", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989.4e12  # bf16 dense, H100 SXM
    hbm_bw: float = 3.35e12  # HBM3
    ici_bw: float = 450e9  # NVLink, a direction
    dcn_bw: float = 50e9  # InfiniBand NDR, a GPU
    chips_per_pod: int = 8  # GPUs a node


H100 = HW()


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    ici_bytes: float
    dcn_bytes: float
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (flops * chips)
    dominant: str
    step_time_s: float  # max of the three (perfect-overlap lower bound)
    roofline_fraction: float  # compute_s / step_time_s

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(n_active_params: float, tokens: float, kind: str) -> float:
    """6ND for train (fwd+bwd), 2ND for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def compute_roofline(*, cost: Dict, collectives: Dict, chips: int, n_active_params: float,
                     tokens: float, kind: str, hw: HW = H100) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))

    ici = dcn = 0.0
    for st in collectives.values():
        ici += st["link_bytes"] if isinstance(st, dict) else st.link_bytes

    compute_s = flops / hw.peak_flops
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = ici / hw.ici_bw + dcn / hw.dcn_bw

    mf = model_flops(n_active_params, tokens, kind)
    total = flops * chips
    useful = mf / total if total else 0.0

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(terms.values())
    frac = compute_s / step if step else 0.0
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops_per_device=flops, hlo_bytes_per_device=bytes_accessed,
        ici_bytes=ici, dcn_bytes=dcn, model_flops=mf, useful_ratio=useful,
        dominant=dominant, step_time_s=step, roofline_fraction=frac)
