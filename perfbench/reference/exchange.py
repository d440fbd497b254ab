"""Plain PyTorch reference of the compressed gradient exchange (the paper's
Algorithm: chunked rFFT, frequency drop-out, range-based N-bit floats),
with error feedback and the mean over workers.

* The flat gradient concatenates the parameter leaves in the order of their
  dotted paths compared part by part (the tree order of the JAX original),
  each flattened row-major.
* It is cut into buckets of ``bucket_mb`` MiB of float32, each a whole
  number of ``chunk``-point chunks but the last, which takes the remainder
  (a remainder shorter than a chunk joins the bucket before it); a bucket's
  last chunk is zero-padded.
* Each chunk's rFFT gives ``chunk/2 + 1`` bins; the ``keep`` =
  round((1 - theta) * bins) bins of largest energy-weighted magnitude
  (|X| x 2, DC and Nyquist x 1) are kept.
* Each bucket fits one quantizer to the kept bins' real and imaginary parts:
  P positive codes of 2^N, P = round((2^N - 1 + 2^m log2(max / |min|)) / 2),
  the top code pinned to the range's max; code i > 0 stands for
  eps * 2^(i // 2^m) * (1 + (i % 2^m) / 2^m), rounded to nearest; values
  below eps round to 0 or eps.
* A worker sends its quantized kept bins; every worker's dense spectra are
  averaged in worker order and inverted.  With error feedback a worker
  compresses its gradient plus its residual, and keeps as its new residual
  what its own payload does not carry back.

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    theta: float = 0.7
    chunk: int = 4096
    bucket_mb: float = 64.0
    n_bits: int = 8
    m_bits: int = 3

    @classmethod
    def of(cls, reducer: dict) -> "ExchangeConfig":
        return cls(theta=float(reducer["theta"]), chunk=int(reducer["chunk"]),
                   bucket_mb=float(reducer["bucket_mb"]), n_bits=int(reducer["n_bits"]),
                   m_bits=int(reducer["m_bits"]))

    @property
    def bins(self) -> int:
        return self.chunk // 2 + 1

    @property
    def keep(self) -> int:
        return max(1, int(round((1.0 - self.theta) * self.bins)))


def leaf_order(names) -> List[str]:
    return sorted(names, key=lambda n: tuple(n.split(".")))


def buckets(total: int, cfg: ExchangeConfig) -> List[Tuple[int, int]]:
    """[lo, hi) of every bucket of a flat gradient ``total`` long."""
    per = int(cfg.bucket_mb * (1 << 20)) // 4
    per = max(cfg.chunk, -(-per // cfg.chunk) * cfg.chunk)
    if per >= total:
        return [(0, total)]
    starts = list(range(0, total, per))
    if total - starts[-1] < cfg.chunk and len(starts) > 1:
        starts.pop()
    ends = starts[1:] + [total]
    return list(zip(starts, ends))


def _weights(cfg: ExchangeConfig, device) -> torch.Tensor:
    w = torch.full((cfg.bins,), 2.0, device=device)
    w[0] = w[-1] = 1.0
    return w


def _fit(lo: torch.Tensor, hi: torch.Tensor, cfg: ExchangeConfig):
    """(eps, P) of the range [lo, hi] (each side kept at least a millionth
    of the span, so both signs have codes)."""
    span = torch.clamp_min(hi - lo, 1e-30)
    vmax = torch.clamp_min(torch.maximum(hi, span * 1e-6), 1e-30)
    vmag = torch.clamp_min(-torch.minimum(lo, -span * 1e-6), 1e-30)
    n_codes, m_scale = 1 << cfg.n_bits, 1 << cfg.m_bits
    p = torch.round((n_codes - 1 + m_scale * (torch.log2(vmax) - torch.log2(vmag))) / 2.0)
    p = torch.clamp(p, 1, n_codes - 2)
    eps = torch.clamp_min(vmax / torch.exp2(torch.clamp_max((p - 1.0) / m_scale, 96.0)), 1e-30)
    return eps, p


def _quantize(x: torch.Tensor, eps: torch.Tensor, p: torch.Tensor,
              cfg: ExchangeConfig) -> torch.Tensor:
    """``x`` rounded to the nearest value its quantizer represents."""
    m_scale = float(1 << cfg.m_bits)
    n_neg = torch.clamp_min((1 << cfg.n_bits) - 1 - p, 1)
    a = x.abs()
    top = torch.where(x >= 0, p, n_neg) - 1  # largest index on this side
    q = torch.floor(torch.log2(torch.maximum(a, eps) / eps) + 1e-6)
    r = torch.round((torch.maximum(a, eps) / (eps * torch.exp2(q)) - 1.0) * m_scale)
    q, r = torch.where(r >= m_scale, q + 1, q), torch.where(r >= m_scale, 0.0, r)
    idx = torch.minimum(q * m_scale + r, top)
    value = eps * torch.exp2(torch.floor(idx / m_scale)) * (1.0 + torch.remainder(idx, m_scale)
                                                              / m_scale)
    value = torch.where(a < eps, torch.where(a * 2.0 >= eps, eps, 0.0), value)
    return torch.where(x >= 0, value, -value)


def bucket_spectrum(x: torch.Tensor, cfg: ExchangeConfig) -> torch.Tensor:
    """One bucket's flat values -> the dense spectrum its payload carries,
    (chunks, bins) complex: the kept bins quantized, the rest 0."""
    n = x.shape[0]
    rows = -(-n // cfg.chunk)
    padded = torch.zeros(rows * cfg.chunk, dtype=torch.float32, device=x.device)
    padded[:n] = x
    spec = torch.fft.rfft(padded.view(rows, cfg.chunk), dim=-1)
    mag = spec.abs() * _weights(cfg, x.device)
    idx = torch.topk(mag, cfg.keep, dim=-1).indices
    kept = torch.gather(spec, -1, idx)
    re, im = kept.real, kept.imag
    eps, p = _fit(torch.minimum(re.min(), im.min()), torch.maximum(re.max(), im.max()), cfg)
    kept = torch.complex(_quantize(re, eps, p, cfg), _quantize(im, eps, p, cfg))
    out = torch.zeros_like(spec)
    out.scatter_(-1, idx, kept)
    return out


def invert(spec: torch.Tensor, n: int, cfg: ExchangeConfig) -> torch.Tensor:
    return torch.fft.irfft(spec, n=cfg.chunk, dim=-1).reshape(-1)[:n]


def exchange(corrected: Sequence[torch.Tensor], cfg: ExchangeConfig,
             own_only: bool = False) -> torch.Tensor:
    """Every worker's flat corrected gradient -> the mean the workers
    receive; each worker's buffer is left holding its new residual (what its
    own payload does not carry back).  ``own_only`` leaves the exchange
    out: the mean is worker 0's own payload (a fault the harness reads)."""
    total = corrected[0].shape[0]
    mean = torch.empty(total, dtype=torch.float32, device=corrected[0].device)
    for lo, hi in buckets(total, cfg):
        acc = None
        for w, flat in enumerate(corrected):
            spec = bucket_spectrum(flat[lo:hi], cfg)
            flat[lo:hi] -= invert(spec, hi - lo, cfg)
            if own_only and w > 0:
                continue
            acc = spec if acc is None else acc + spec
        count = 1 if own_only else len(corrected)
        mean[lo:hi] = invert(acc * (1.0 / count), hi - lo, cfg)
    return mean
