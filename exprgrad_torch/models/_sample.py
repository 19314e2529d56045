"""Token selection for the serving runtime.

Counterpart of ``exprgrad_tpu/models/_sample.py``: greedy argmax, or
temperature sampling restricted by top-k and/or top-p (nucleus) filters,
drawing from a ``torch.Generator``.  The filter semantics are the JAX
package's; the random stream is not (``jax.random`` cannot be
reproduced in torch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import ModelRuntimeError


def check_top_p(top_p: Optional[float]) -> None:
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ModelRuntimeError(f"top_p must lie in (0, 1] (got {top_p})")


def make_row_picker(vocab: int):
    """Return ``pick(logits [b, vocab], generator, temp [b], top_k [b],
    top_p [b]) -> token ids [b]`` with per-row sampling parameters: one
    function serves any mix of greedy (``temp <= 0``), plain
    temperature, top-k (``top_k >= vocab`` disables) and nucleus
    (``top_p >= 1`` disables) rows — the continuous batcher's
    per-request knobs.  The parameters are host arrays (numpy or
    sequences): when no row samples, the pick is the argmax alone and
    draws nothing.  Greedy rows are the argmax of the logits bit for
    bit; the filters are :func:`make_picker`'s."""

    def pick(logits, generator, temp, top_k, top_p):
        temp = np.asarray(temp, np.float32)
        sampled = temp > 0.0
        if not sampled.any():
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        scale = torch.as_tensor(np.where(sampled, temp, 1.0)[:, None],
                                device=dev)
        sl_in = logits.float() / scale
        greedy = torch.argmax(sl_in, dim=-1)
        sl = torch.sort(sl_in, dim=-1, descending=True).values
        # top-k: threshold at the k-th logit where active
        kk = torch.as_tensor(np.clip(np.asarray(top_k, np.int64), 1, vocab),
                             device=dev)
        kth = torch.gather(sl, 1, kk[:, None] - 1)
        k_on = (kk < vocab)[:, None]
        filt = sl_in.masked_fill(k_on & (sl_in < kth), -torch.inf)
        ranks = torch.arange(vocab, device=dev)[None, :]
        sl = sl.masked_fill(k_on & (ranks >= kk[:, None]), -torch.inf)
        # nucleus over the survivors: the smallest prefix reaching top_p
        probs = torch.softmax(sl, dim=-1)
        pp = torch.as_tensor(np.asarray(top_p, np.float32)[:, None],
                             device=dev)
        keep = torch.cumsum(probs, dim=-1) - probs < pp
        kth_p = torch.where(keep, sl, torch.inf).amin(dim=-1, keepdim=True)
        filt = filt.masked_fill((pp < 1.0) & (filt < kth_p), -torch.inf)
        drawn = torch.multinomial(torch.softmax(filt, dim=-1), 1,
                                  generator=generator)[:, 0]
        return torch.where(torch.as_tensor(sampled, device=dev), drawn,
                           greedy)

    return pick


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
