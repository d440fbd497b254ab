"""The rows of every step, drawn from (seed, step, worker) on the device.

The one generator of the training traffic: a traffic file gives the rows a
worker, the sequence and (for a configuration with an audio frontend) the
frames a row; each step's tokens are uniform over the vocabulary and its
frames N(0, 1) x 0.02.  Every step and every worker draws other rows, of
the same shapes, so every seed does the same work.  ``batch_at`` is the
program's stream interface (``train_loop`` calls it once a step, again for
a step it retries), and the reference draws the same rows from it.
"""

from __future__ import annotations

import collections

import torch


def rows_seed(seed: int, step: int, worker: int) -> int:
    return ((int(seed) * 1_000_003 + 7919 * step) * 1_009 + worker + 1) % (2 ** 63 - 1)


class Feed:
    def __init__(self, vocab: int, rows: int, seq: int, frames: int, d_model: int, seed: int,
                 device):
        self.vocab, self.rows, self.seq, self.frames = vocab, rows, seq, frames
        self.d_model, self.seed, self.device = d_model, seed, torch.device(device)
        self.calls = collections.Counter()
        self._probed = False

    def batch_at(self, step: int, host_index: int = 0, num_hosts: int = 1):
        if self._probed:
            self.calls[(step, host_index)] += 1
        else:  # the loop's first call reads the batch's size, before any step
            self._probed = True
        gen = torch.Generator(device=self.device).manual_seed(
            rows_seed(self.seed, step, host_index))
        toks = torch.randint(0, self.vocab, (self.rows, self.seq + 1), generator=gen,
                             device=self.device)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.frames:
            batch["frontend"] = torch.randn((self.rows, self.frames, self.d_model),
                                            generator=gen, device=self.device) * 0.02
        return batch

    def retries(self) -> int:
        """Steps asked for again: each is a step that raised and was retried."""
        return sum(n - 1 for n in self.calls.values())
