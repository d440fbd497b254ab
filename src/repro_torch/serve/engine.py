"""Serving engine (port of ``repro.serve.engine``): batched prefill, then
decode token by token from the KV caches, greedy or with temperature.

Requests are padded into one fixed batch, prefilled together and decoded
together; ``Engine.generate`` is the batch API.  The model holds its own
parameters and keeps them replicated: there is no mesh context.

Greedy decoding is ``argmax``.  With ``temperature > 0`` a token is drawn
from ``softmax(logits / temperature)`` with ``torch.multinomial`` and an
explicit ``torch.Generator`` (the caller's, or one seeded with 0): the
reference's ``jax.random.categorical`` bits cannot be matched, so sampled
tokens agree with the reference's in distribution only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.models.transformer import LM

__all__ = ["ServeConfig", "Engine", "build_prefill_step", "build_decode_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    batch: int = 8
    temperature: float = 0.0  # 0 = greedy
    eos_token: int = -1  # -1: never stop early (generate does not stop early, as the reference)


def build_prefill_step(model: LM, max_seq: Optional[int] = None):
    """``prefill_step(batch) -> (last-position logits (B,1,V), caches)``;
    an arch with a frontend reads ``batch["frontend"]``, which an enc-dec
    arch encodes first (the memory its cross blocks cache)."""
    def prefill_step(batch):
        with torch.no_grad():
            memory = model.frontend_memory(batch.get("frontend"))
        return model.prefill(batch["tokens"], memory=memory, max_seq=max_seq, last_only=True)

    return prefill_step


def build_decode_step(model: LM):
    """``decode_step(caches, token (B,1), pos) -> (logits (B,1,V), caches)``."""
    def decode_step(caches, token, pos):
        return model.decode_step(caches, token, pos)

    return decode_step


class Engine:
    """Batched generation on top of prefill and decode."""

    def __init__(self, model: LM, config: ServeConfig):
        self.model = model
        self.config = config
        self._prefill = build_prefill_step(model, config.max_seq)
        self._decode = build_decode_step(model)

    def _sample(self, logits: torch.Tensor, generator: Optional[torch.Generator]):
        last = logits[:, -1]
        if self.config.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / self.config.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(self, prompts: torch.Tensor, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 timings: Optional[dict] = None,
                 frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompts (B, S_prompt) -> (B, S_prompt + max_new_tokens) int64;
        ``frontend`` (B, S_front, D): the frontend embeddings of an arch that
        takes them.

        ``timings``, when given, receives ``prefill_s`` (the encoder's pass
        included) and ``decode_s`` (the host clock around each part,
        synchronized on the card) and ``decode_steps``."""
        if generator is None and self.config.temperature > 0.0:
            generator = torch.Generator(device=prompts.device).manual_seed(0)
        prompts = prompts.long()
        b, s = prompts.shape
        sync = (torch.cuda.synchronize if prompts.device.type == "cuda" and timings is not None
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        batch = {"tokens": prompts}
        if frontend is not None:
            batch["frontend"] = frontend
        logits, caches = self._prefill(batch)
        tok = self._sample(logits, generator)[:, None]
        sync()
        t1 = time.perf_counter()
        tokens = [prompts]
        for i in range(max_new_tokens):
            tokens.append(tok)
            if i == max_new_tokens - 1:
                break
            logits, caches = self._decode(caches, tok, s + i)
            tok = self._sample(logits, generator)[:, None]
        sync()
        if timings is not None:
            timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                           decode_steps=max(max_new_tokens - 1, 0))
        return torch.cat(tokens, dim=1)
