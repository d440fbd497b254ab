"""Paper-era convnet (port of ``repro.models.convnet``): a compact residual
CNN on synthetic images, the family the paper trained (AlexNet, VGG16,
ResNet32 in Fig. 11/12); the gradient compressor is architecture-agnostic.

The parameters keep the reference's names and layout -- ``stem``,
``s{s}b{b}_c1``, ``s{s}b{b}_c2``, ``s{s}b{b}_proj`` as HWIO kernels
``(k, k, cin, cout)`` and ``head`` as ``(width, classes)`` -- one
``nn.Parameter`` per leaf, so ``convert.params_from_jax`` is a rename and
``reducers.flatten_tree`` lays the flat gradient out in the reference's
order.  Images come in NHWC, as the reference takes them.

Convolutions run through ``F.conv2d`` (cuDNN on the card; the reference's
``lax.conv_general_dilated`` is outside any Pallas kernel too), with the
reference's ``"SAME"`` padding spelled out: at stride 2 on an even size a
3x3 kernel pads (0, 1), not (1, 1).  The norm is per-channel over the
spatial axes with the population variance (``jnp.var``), no batch
statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.sharding import ParamSpec

__all__ = ["ConvConfig", "ConvNet"]


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    n_classes: int = 10
    widths: Tuple[int, ...] = (16, 32, 64)
    blocks_per_stage: int = 2  # resnet-32 analog: deeper if desired
    img_size: int = 32


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW activations, HWIO kernel, ``"SAME"`` padding."""
    k = w.shape[0]
    ph, pw = _same_pad(x.shape[2], k, stride), _same_pad(x.shape[3], k, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _param_specs(cfg: ConvConfig) -> Dict[str, ParamSpec]:
    """Leaf name -> ParamSpec, in the reference's spec order."""
    def conv(cin, cout, k=3):
        return ParamSpec((k, k, cin, cout), (None, None, None, "ff"),
                         scale=(2.0 / (k * k * cin)) ** 0.5)

    spec = {"stem": conv(3, cfg.widths[0])}
    cin = cfg.widths[0]
    for s, w in enumerate(cfg.widths):
        for b in range(cfg.blocks_per_stage):
            spec[f"s{s}b{b}_c1"] = conv(cin if b == 0 else w, w)
            spec[f"s{s}b{b}_c2"] = conv(w, w)
            if b == 0 and cin != w:
                spec[f"s{s}b{b}_proj"] = conv(cin, w, k=1)
        cin = w
    spec["head"] = ParamSpec((cfg.widths[-1], cfg.n_classes), ("embed", None))
    return spec


class ConvNet(nn.Module):
    """Residual CNN: stem, ``len(widths)`` stages of ``blocks_per_stage``
    blocks (the first block of every stage after the first strides 2),
    global average pool, linear head."""

    def __init__(self, cfg: ConvConfig = ConvConfig(), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for name, spec in _param_specs(cfg).items():
            t = torch.empty(spec.shape, dtype=torch.float32, device=device)
            t.normal_(0.0, 0.02 if spec.scale is None else spec.scale, generator=generator)
            self.register_parameter(name, nn.Parameter(t))

    def spec(self) -> Dict[str, ParamSpec]:
        """Leaf name -> ParamSpec (shape, logical axes, init)."""
        return _param_specs(self.cfg)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Leaf path -> parameter, as a flat mapping."""
        return dict(self.named_parameters())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) NHWC -> logits (B, classes)."""
        cfg = self.cfg
        p = self.leaves()
        x = _conv(p["stem"], images.float().permute(0, 3, 1, 2).contiguous())
        for s in range(len(cfg.widths)):
            for b in range(cfg.blocks_per_stage):
                stride = 2 if (b == 0 and s > 0) else 1
                h = F.relu(_norm(_conv(p[f"s{s}b{b}_c1"], x, stride)))
                h = _norm(_conv(p[f"s{s}b{b}_c2"], h))
                skip = x
                if f"s{s}b{b}_proj" in p:
                    skip = _conv(p[f"s{s}b{b}_proj"], x, stride)
                elif stride != 1:
                    skip = x[:, :, ::2, ::2]
                x = F.relu(h + skip)
        return torch.mean(x, dim=(2, 3)) @ p["head"]

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {images, labels} -> (mean cross-entropy, {acc})."""
        logits = self.forward(batch["images"])
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, labels[:, None])
        acc = (torch.argmax(logits, -1) == labels).float().mean()
        return ce.mean(), {"acc": acc}
