"""Token selection for the serving runtime.

Counterpart of ``exprgrad_tpu/models/_sample.py``: greedy argmax, or
temperature sampling restricted by top-k and/or top-p (nucleus) filters,
drawing from a ``torch.Generator``.  The filter semantics are the JAX
package's; the random stream is not (``jax.random`` cannot be
reproduced in torch).
"""

from __future__ import annotations

from typing import Optional

import torch

from exprgrad_tpu.errors import ModelRuntimeError


def check_top_p(top_p: Optional[float]) -> None:
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ModelRuntimeError(f"top_p must lie in (0, 1] (got {top_p})")


def make_picker(vocab: int, temperature: float,
                top_k: Optional[int], top_p: Optional[float]):
    """Return ``pick(logits [b, vocab], generator) -> token ids [b]``.

    ``temperature <= 0`` is greedy argmax.  Otherwise sample from
    ``softmax(logits / temperature)`` restricted to the ``top_k`` most
    likely tokens and/or the smallest nucleus reaching ``top_p`` mass
    (top_k filter first, then top_p over the survivors).
    """

    def pick(logits, generator):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits.float() / float(temperature)
        use_k = top_k is not None and top_k < vocab
        use_p = top_p is not None and top_p < 1.0
        if use_k or use_p:
            sl = torch.sort(logits, dim=-1, descending=True).values
        if use_k:
            logits = logits.masked_fill(
                logits < sl[:, top_k - 1:top_k], -torch.inf)
            ranks = torch.arange(sl.shape[-1], device=sl.device)
            sl = sl.masked_fill(ranks[None, :] >= top_k, -torch.inf)
        if use_p:
            # nucleus: keep the smallest descending-prob prefix with mass
            # >= top_p; the cutoff is the smallest kept logit (the top
            # token always stays)
            probs = torch.softmax(sl, dim=-1)
            keep = torch.cumsum(probs, dim=-1) - probs < top_p
            kth = torch.where(keep, sl, torch.inf).amin(dim=-1, keepdim=True)
            logits = logits.masked_fill(logits < kth, -torch.inf)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return pick
