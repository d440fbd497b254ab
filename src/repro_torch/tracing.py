"""Stage spans and counters inside the train step, off unless switched on.

A span is a ``torch.profiler.record_function`` range named
``<layer>.<stage>`` (``step.forward``, ``exchange.fft``, ``optim.update``
...), so under a profiler it sits on the same timeline as the device's
kernels and idle gaps; the loop's ``train_step`` range is their parent.  A
counter is a number kept in memory (``exchange.compress_passes``,
``exchange.payload_bytes``, ``host_syncs``: each place in a step where the
host waits on the device), or a number a kernel adds to on the device
(``exchange.bracket_fallback_rows``: the rows whose sampled bracket B4 had
to widen), read once by :func:`counters`.

Tracing is off by default, and the program never switches it on: an
operator (or a benchmark) calls :func:`enable` around the steps it profiles.
Off, :func:`span` returns one shared no-op context after one flag check and
:func:`count` returns at once.  Nothing is written while a step runs.

    from repro_torch import tracing
    tracing.enable(True); tracing.reset()
    with torch.profiler.profile(...) as prof:
        train_loop(...)
    tracing.enable(False)
    prof.export_chrome_trace("steps.json"); print(tracing.counters())
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

__all__ = ["span", "count", "device_counter", "enable", "enabled", "counters", "reset"]

_on = False
_NOOP = contextlib.nullcontext()
_counts: Dict[str, int] = {}
# counters kept on a device: (name, device) -> a one-element int64 tensor
_device_counts: Dict[Tuple[str, torch.device], torch.Tensor] = {}
# each kernel's Kernel.launches at the last reset()
_launch_base: Dict[str, int] = {}


def span(name: str):
    """A profiler range named ``name`` while tracing is on, else a shared
    no-op context."""
    if not _on:
        return _NOOP
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def device_counter(name: str, device) -> Optional[torch.Tensor]:
    """While tracing is on, the one-element int64 tensor on ``device`` that
    holds the counter ``name``, for a kernel to add to without a host wait;
    None while off."""
    if not _on:
        return None
    key = (name, torch.device(device))
    t = _device_counts.get(key)
    if t is None:
        t = _device_counts[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return t


def enable(on: bool) -> None:
    """Switch spans and counters on or off (the counters keep their values)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _kernels():
    from repro_torch.kernels import all_kernels

    return all_kernels()


def reset() -> None:
    """Clear the counters; kernel launches count from here on."""
    _counts.clear()
    _device_counts.clear()
    _launch_base.clear()
    _launch_base.update({k.name: k.launches for k in _kernels()})


def counters() -> Dict[str, int]:
    """A snapshot of the counters (each device counter read once, which
    waits for its device), and ``kernels.<name>``: the launches of each
    kernel launched since the last :func:`reset`, read from its
    ``Kernel.launches``."""
    out = dict(_counts)
    for (name, _), t in _device_counts.items():
        out[name] = out.get(name, 0) + int(t.item())
    for k in _kernels():
        n = k.launches - _launch_base.get(k.name, 0)
        if n:
            out[f"kernels.{k.name}"] = n
    return out
