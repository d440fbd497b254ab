# Frozen copy of src/repro_torch/analysis/collectives.py at commit 9055aa7: the
# yardstick of wire_mb_per_step.
"""Per-device collective bytes by kind (the counterpart of the reference's
``repro/analysis/hlo.py``).

The reference parses the collectives out of XLA's optimized HLO.  An eager
PyTorch step has no HLO: :class:`CollectiveRecorder`, a
``TorchDispatchMode``, records each collective the traced step dispatches --
the ``c10d.*`` ops that ``torch.distributed``'s calls reach (the tensor-
parallel blocks, the reducers, the transports) and the
``_c10d_functional.*`` ops that ``DTensor.redistribute`` reaches (the
sharded ``pjit`` step) -- with its kind, its payload bytes and its group's
size.  A ``send``/``recv`` pair is one ``collective-permute``, counted at its
``send``; the functional ops' ``wait_tensor`` (the reference's ``-done``)
is not a collective.  Run it under a ``FakeTensorMode`` over the ``fake``
process group and nothing moves: the records are what the step would send.

:class:`CollectiveStats`, :func:`summarize` and the ring model are the
reference's, formula for formula (bytes that cross links per device):

    all-reduce         2 * bytes * (n-1)/n
    all-gather         result_bytes * (n-1)/n
    reduce-scatter     result_bytes * (n-1)   (the result is the shard)
    all-to-all         bytes * (n-1)/n
    collective-permute bytes
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveStats", "Collective", "CollectiveRecorder", "link_bytes", "stats_of",
           "summarize", "OP_KINDS"]

OP_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "ragged-all-to-all")


@dataclasses.dataclass
class CollectiveStats:
    kind: str
    count: int = 0
    raw_bytes: float = 0.0  # sum of payload bytes (per device program)
    link_bytes: float = 0.0  # ring-model bytes crossing links per device


@dataclasses.dataclass(frozen=True)
class Collective:
    """One dispatched collective: its kind, payload (the result's bytes, as
    the reference reads them off the HLO) and group size."""

    kind: str
    payload: float
    group: int
    op: str


def link_bytes(kind: str, payload: float, n: int) -> float:
    """The ring model's bytes crossing links per device for one collective."""
    n = max(int(n), 1)
    if kind == "all-reduce":
        return 2.0 * payload * (n - 1) / n
    if kind == "all-gather":
        return payload * (n - 1) / n
    if kind == "reduce-scatter":
        return payload * (n - 1)
    if kind in ("all-to-all", "ragged-all-to-all"):
        return payload * (n - 1) / n
    return payload  # collective-permute


def stats_of(records: Iterable[Collective]) -> Dict[str, CollectiveStats]:
    """Per-kind stats of the records (kinds with none left out)."""
    stats = {k: CollectiveStats(kind=k) for k in OP_KINDS}
    for r in records:
        st = stats[r.kind]
        st.count += 1
        st.raw_bytes += r.payload
        st.link_bytes += link_bytes(r.kind, r.payload, r.group)
    return {k: v for k, v in stats.items() if v.count}


def summarize(stats: Dict[str, CollectiveStats]) -> Dict:
    return {
        k: {"count": v.count, "raw_bytes": v.raw_bytes, "link_bytes": v.link_bytes}
        for k, v in stats.items()
    }


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0.0


def _pg_size(pg) -> int:
    return torch.distributed.ProcessGroup.unbox(pg).size()


def _named_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


# op name -> (kind, the argument whose bytes are the payload, group size of args)
_C10D = {
    "allreduce_": ("all-reduce", 0, lambda a: _pg_size(a[1])),
    "allreduce_coalesced_": ("all-reduce", 0, lambda a: _pg_size(a[1])),
    "allgather_": ("all-gather", 0, lambda a: _pg_size(a[2])),
    "_allgather_base_": ("all-gather", 0, lambda a: _pg_size(a[2])),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, lambda a: _pg_size(a[2])),
    "reduce_scatter_": ("reduce-scatter", 0, lambda a: _pg_size(a[2])),
    "_reduce_scatter_base_": ("reduce-scatter", 0, lambda a: _pg_size(a[2])),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, lambda a: _pg_size(a[2])),
    "alltoall_": ("all-to-all", 0, lambda a: _pg_size(a[2])),
    "alltoall_base_": ("all-to-all", 0, lambda a: _pg_size(a[2])),
    "send": ("collective-permute", 0, lambda a: _pg_size(a[1])),
}
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", lambda a: _named_size(a[2])),
    "all_reduce_coalesced": ("all-reduce", lambda a: _named_size(a[2])),
    "all_gather_into_tensor": ("all-gather", lambda a: int(a[1])),
    "all_gather_into_tensor_out": ("all-gather", lambda a: int(a[1])),
    "all_gather_into_tensor_coalesced": ("all-gather", lambda a: int(a[1])),
    "reduce_scatter_tensor": ("reduce-scatter", lambda a: int(a[2])),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", lambda a: int(a[2])),
    "all_to_all_single": ("all-to-all", lambda a: _named_size(a[3])),
}
_IGNORED = {"wait_tensor", "recv_", "recv_any_source_", "barrier", "monitored_barrier_"}


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched under it in ``records``.  A
    collective it cannot price (a broadcast, a gather to one root) raises,
    so no traffic goes unseen."""

    def __init__(self):
        super().__init__()
        self.records: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            name = func._opname
            if name in _IGNORED:
                return out
            if ns == "c10d" and name in _C10D:
                kind, at, size = _C10D[name]
                self.records.append(Collective(kind, _nbytes(args[at]), size(args), name))
            elif ns == "_c10d_functional" and name in _FUNCTIONAL:
                kind, size = _FUNCTIONAL[name]
                self.records.append(Collective(kind, _nbytes(out), size(args), name))
            else:
                raise NotImplementedError(f"collective {func} has no ring-model price")
        return out

    def stats(self) -> Dict[str, CollectiveStats]:
        return stats_of(self.records)

    def summary(self) -> Dict:
        return summarize(self.stats())
