"""Training batches of token ids drawn from a Zipf law over the
vocabulary, as words of text are.

The ranks' order over the vocabulary is a permutation drawn from the
seed; each step draws its rows from a generator of its own on the
device, so every step's rows differ and a step can be drawn again alone
(the correctness check does).  A draw is the law's float64 cumulative
distribution, made once, searched with uniform numbers: the same step
gives the same ids every time in a process (``torch.multinomial``
builds its cumulative sum on every call).  ``labels`` are the one-hot
next tokens.
"""

from __future__ import annotations

import torch

from ..weights import stream_seed


class Batches:
    def __init__(self, params: dict, seed: int, vocab: int, device):
        self.seq = int(params["seq_len"])
        self.rows = int(params["sequences"])
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.device = device
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, "zipf-ranks"))
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device=device)
        cdf = torch.cumsum(ranks ** -float(params["zipf_s"]), 0)
        self.cdf = cdf / cdf[-1]
        self.ids = torch.randperm(vocab, generator=gen, device=device)

    def tokens(self, step: int) -> torch.Tensor:
        """Ids [rows, seq + 1] of step ``step`` (1-based), int64."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, "zipf-step", step))
        u = torch.rand(self.rows * (self.seq + 1), generator=gen,
                       dtype=torch.float64, device=self.device)
        rank = torch.searchsorted(self.cdf, u).clamp(max=self.vocab - 1)
        return self.ids[rank].view(self.rows, self.seq + 1)

    def args(self, step: int) -> dict:
        """The program's inputs: float ids [rows, seq] and one-hot labels
        [rows, seq, vocab] of the next tokens."""
        ids = self.tokens(step)
        labels = torch.zeros(self.rows, self.seq, self.vocab,
                             device=self.device)
        labels.scatter_(2, ids[:, 1:, None], 1.0)
        return {"tokens": ids[:, :-1].float(), "labels": labels}
