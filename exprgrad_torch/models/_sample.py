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


def draw(probs: torch.Tensor, generator) -> torch.Tensor:
    """One token a row from ``probs`` [b, vocab]: the argmax of ``probs /
    q`` with ``q ~ Exp(1)``, which is how ``torch.multinomial`` draws one
    sample (the same tokens from the same generator state), without its
    check of the probabilities, which reads a value back to the host."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def sample_rows(logits, generator, temp, top_k, top_p, vocab: int):
    """Per-row temperature, top-k and nucleus sampling with the
    parameters as tensors [b] on the logits' device (``temp <= 0`` rows
    take the argmax): device work only, no host decision and no read
    back, so a CUDA graph can capture it."""
    dev = logits.device
    sampled = temp > 0.0
    scale = torch.where(sampled, temp, torch.ones_like(temp))[:, None]
    sl_in = logits.float() / scale
    greedy = torch.argmax(sl_in, dim=-1)
    sl = torch.sort(sl_in, dim=-1, descending=True).values
    # top-k: threshold at the k-th logit where active
    kk = top_k.long().clamp(1, vocab)
    kth = torch.gather(sl, 1, kk[:, None] - 1)
    k_on = (kk < vocab)[:, None]
    filt = sl_in.masked_fill(k_on & (sl_in < kth), -torch.inf)
    ranks = torch.arange(vocab, device=dev)[None, :]
    sl = sl.masked_fill(k_on & (ranks >= kk[:, None]), -torch.inf)
    # nucleus over the survivors: the smallest prefix reaching top_p
    probs = torch.softmax(sl, dim=-1)
    pp = top_p.float()[:, None]
    keep = torch.cumsum(probs, dim=-1) - probs < pp
    kth_p = torch.where(keep, sl, torch.inf).amin(dim=-1, keepdim=True)
    filt = filt.masked_fill((pp < 1.0) & (filt < kth_p), -torch.inf)
    drawn = draw(torch.softmax(filt, dim=-1), generator)
    return torch.where(sampled, drawn, greedy)


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
        if not (temp > 0.0).any():
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        return sample_rows(
            logits, generator, torch.as_tensor(temp, device=dev),
            torch.as_tensor(np.asarray(top_k, np.int64), device=dev),
            torch.as_tensor(np.asarray(top_p, np.float32), device=dev),
            vocab)

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
