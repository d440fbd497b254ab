"""Device policy of the port's entry points.

Every entry point takes a ``device`` argument that defaults to ``cuda``.  A
caller that wants the CPU asks for it (``device="cpu"``, ``--device cpu``);
asking for the default without a GPU raises instead of falling back, so a
run that was meant for the card can never quietly measure the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve"]

DEFAULT_DEVICE = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is requested but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the port on the CPU")
    return dev
