"""The reference's first training steps: the same weights and rows the
program gets (drawn again from the seed), each worker's loss and gradient,
the exchange (``compressed_dp``) or the plain mean (``pjit``), clipping to
the global norm, and AdamW with bias correction.

``state_dtype`` is where the configuration states float32 (the parameters,
the gradients as exchanged, the error-feedback residual and the AdamW
moments): the control runs it at bfloat16.  ``fault`` plants one of the
faults a training step can have, for the readings that set the limits:
``half_batch`` (the loss over half of each worker's rows) and
``no_exchange`` (each worker steps on its own payload alone).

Returns what the comparison reads: every step's loss (the workers' mean),
each leaf's norm of the first gradient as the optimizer receives it, and
each leaf's norm of the parameters' change after the steps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench import weights
from perfbench.reference import exchange as ex

FLOAT32 = torch.float32


def _adamw(params, grads, m, v, count: int, opt: Dict, dtype=FLOAT32) -> None:
    lr, b1, b2, eps, wd = (opt[k] for k in ("lr", "b1", "b2", "eps", "weight_decay"))
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].float()
            m_new = b1 * m[k].float() + (1.0 - b1) * g
            v_new = b2 * v[k].float() + (1.0 - b2) * g * g
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + wd * p.float()
            m[k].copy_(m_new.to(dtype))
            v[k].copy_(v_new.to(dtype))
            p.copy_((p.float() - lr * upd).to(dtype))


def run(lm, arch: Dict, traffic: Dict, seed: int, feed, *, workers: int, steps: int, device,
        state_dtype=FLOAT32, fault: Optional[str] = None) -> Dict:
    """``lm``: the configuration's reference model module (``leaf_shapes``,
    ``loss``)."""
    shapes = lm.leaf_shapes(arch)
    names = ex.leaf_order(shapes)
    params = {k: weights.leaf(seed, k, shapes[k], device).to(state_dtype).requires_grad_()
              for k in names}
    m = {k: torch.zeros(shapes[k], dtype=state_dtype, device=device) for k in names}
    v = {k: torch.zeros(shapes[k], dtype=state_dtype, device=device) for k in names}
    mode = traffic["mode"]
    cfg = ex.ExchangeConfig.of(traffic["reducer"]) if mode == "compressed_dp" else None
    ef = cfg is not None and traffic["reducer"]["error_feedback"]
    total = sum(p.numel() for p in params.values())
    residual = [torch.zeros(total, dtype=state_dtype, device=device) for _ in range(workers)]
    rows = slice(0, traffic["batch_per_worker"] // 2) if fault == "half_batch" else None
    losses, first_grad = [], None
    for step in range(steps):
        flats, step_loss = [], 0.0
        for w in range(workers):
            batch = feed.batch_at(step, w, workers)
            for p in params.values():
                p.grad = None
            loss = lm.loss(params, batch, arch, rows)
            loss.backward()
            step_loss += float(loss.detach()) / workers
            flat = torch.cat([params[k].grad.to(state_dtype).float().reshape(-1)
                              for k in names])
            for p in params.values():
                p.grad = None
            if ef:  # corrected in place, and the old residual let go at once
                flat.add_(residual[w].float())
                residual[w] = None
            flats.append(flat)
        losses.append(step_loss)
        with torch.no_grad():
            if cfg is None:
                mean = flats[0]
                for f in flats[1:]:
                    mean = mean + f
                mean = mean / workers
            else:
                # the exchange leaves each worker's new residual in its buffer
                mean = ex.exchange(flats, cfg, own_only=fault == "no_exchange")
                if ef:
                    residual = [f.to(state_dtype) for f in flats]
            del flats
            mean = mean.to(state_dtype).float()
            norm = torch.linalg.vector_norm(mean)
            mean = mean * torch.clamp_max(traffic["clip_norm"] / torch.clamp_min(norm, 1e-12),
                                          1.0)
            grads, at = {}, 0
            for k in names:
                n = params[k].numel()
                grads[k] = mean[at:at + n].view(shapes[k])
                at += n
            if step == 0:
                first_grad = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            _adamw(params, grads, m, v, step + 1, traffic["optimizer"], dtype=state_dtype)
            del mean, grads
    change = {}
    with torch.no_grad():
        for k in names:
            p0 = weights.leaf(seed, k, shapes[k], device).to(state_dtype).float()
            change[k] = float(torch.linalg.vector_norm(params[k].float() - p0))
    return {"loss": losses, "grad": first_grad, "change": change,
            "shapes": {k: list(s) for k, s in shapes.items()}}
