"""Speculative-decoding loop for the serving runtime.

Counterpart of ``exprgrad_tpu/models/_spec.py``: one implementation of
the propose / verify / accept / rewind round, with greedy acceptance
(the target's exact greedy output) and temperature rejection sampling
(the target's exact distribution; Leviathan et al.), consumed by
``FlashLMServer.generate_speculative`` and ``generate_lookup`` through
step closures:

    draft_step(tokens [1, 1], dstate)  -> (logits [1, t, V], dstate)
    target_step(tokens [1, k], tstate) -> (logits [1, k, V], tstate)
    rewind(state, new_len)             -> state  (KV length rewind)
    length_of(state)                   -> int cache length

The JAX package runs the rounds as one ``lax.while_loop``; here each
round is eager work on the device followed by one read back of the
round's tokens and acceptance count (the host decides the next round).
The rewind is load-bearing: ``ops.decode.decode_attention`` attends only
a cache's first ``length`` rows, and ``append`` writes the next round at
``length``, so rejected rows are never read and are overwritten.
Sampled rounds take every draw from one ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def lookup_propose(hist: np.ndarray, k: int, ngram: int) -> np.ndarray:
    """Prompt-lookup proposals over an int64 token history: the ``k``
    tokens that followed the most recent earlier occurrence of the last
    ``ngram`` tokens.  A match window must end before the query ngram
    does (only the self-match is excluded); no match repeats the last
    token.  The JAX package's in-graph ``propose`` (``serve.py``) and its
    batcher's ``_lookup_propose`` compute the same."""
    pos = hist.size
    last = hist[-1]
    if pos - 1 < ngram:
        return np.full(k, last, np.int64)
    from numpy.lib.stride_tricks import sliding_window_view

    wins = sliding_window_view(hist[:pos - 1], ngram)
    match = np.all(wins == hist[pos - ngram:pos][None, :], axis=1)
    starts = np.nonzero(match)[0]
    if not starts.size:
        return np.full(k, last, np.int64)
    best = int(starts[-1])
    prop_idx = np.minimum(best + ngram + np.arange(k), pos - 1)
    return hist[prop_idx]


def _draft_props(draft_step, dstate, cur, k, temperature, generator):
    """``k`` draft steps from ``cur`` [1]: (proposals [k], the draft's
    distributions [k, V] when sampling else None, dstate)."""
    sampled = temperature > 0.0
    tok, props, qs = cur, [], []
    for _ in range(k):
        dlogits, dstate = draft_step(tok[:, None].float(), dstate)
        row = dlogits[:, -1].float()
        if sampled:
            q = torch.softmax(row / temperature, dim=-1)
            tok = torch.multinomial(q, 1, generator=generator)[:, 0]
            qs.append(q[0])
        else:
            tok = torch.argmax(row, dim=-1)
        props.append(tok)
    return torch.cat(props), (torch.stack(qs) if sampled else None), dstate


def speculative_loop(
    draft_step: Optional[Callable],
    target_step: Callable,
    rewind: Callable,
    length_of: Callable,
    dstate,
    tstate,
    first: torch.Tensor,
    n_new: int,
    k: int,
    temperature: float,
    generator: torch.Generator,
    propose_fn: Optional[Callable] = None,
):
    """Run speculative rounds until ``n_new`` tokens are emitted.

    ``first`` [1] (int64, on the device) is the already-chosen first
    token, its K/V not yet appended to either state.  Returns ``(tokens
    [1, n_new] int32 on the device, target_steps)``.

    ``propose_fn(out, count) -> [k] ints`` replaces the draft with
    draft-free proposals from the host history ``out[:count]`` (prompt
    lookup); ``draft_step``/``dstate`` are then unused and acceptance must
    be greedy (fixed proposals carry no draft distribution)."""
    sampled = temperature > 0.0
    if propose_fn is not None and sampled:
        raise ValueError("propose_fn requires greedy acceptance")
    dev = first.device
    T = float(temperature) if sampled else 1.0
    j = torch.arange(k, device=dev)
    out = np.zeros(n_new + k, np.int64)
    out[0] = int(first[0])
    count, steps, cur = 1, 0, first
    while count < n_new:
        if propose_fn is not None:
            props = torch.as_tensor(propose_fn(out, count), dtype=torch.long,
                                    device=dev)
            qs = None
        else:
            props, qs, dstate = _draft_props(draft_step, dstate, cur, k,
                                             temperature, generator)
        len0 = length_of(tstate)
        seq_in = torch.cat([cur, props[:k - 1]])[None].float()  # [1, k]
        vlogits, tstate = target_step(seq_in, tstate)
        if sampled:
            p = torch.softmax(vlogits[0].float() / T, dim=-1)     # [k, V]
            ratio = p[j, props] / qs[j, props].clamp(min=1e-30)
            acc = torch.rand(k, generator=generator, device=dev) < ratio
            m = torch.cumprod(acc.long(), 0).sum()
            row = m.clamp(max=k - 1)
            resid = (p[row] - qs[row]).clamp(min=0.0)
            rs = resid.sum()
            resid = torch.where(rs > 1e-30, resid / rs, p[row])
            last = torch.multinomial(resid, 1, generator=generator)[0]
        else:
            targets = torch.argmax(vlogits[0], dim=-1)
            m = torch.cumprod((props == targets).long(), 0).sum()
            last = targets[m.clamp(max=k - 1)]                     # bonus
        emit = props.clone()
        emit[m.clamp(max=k - 1)] = torch.where(m == k, props[k - 1], last)
        # the one read back of the round: its tokens and acceptance count
        host = torch.cat([emit, m[None]]).cpu().numpy()
        n_emit = min(int(host[k]) + 1, k)
        out[count:count + k] = host[:k]
        cur = emit[n_emit - 1:n_emit]
        tstate = rewind(tstate, len0 + n_emit)
        if propose_fn is None:
            dstate = rewind(dstate, len0 + n_emit)
        count += n_emit
        steps += 1
    return torch.as_tensor(out[None, :n_new], dtype=torch.int32,
                           device=dev), steps


def check_spec_args(batch: int, target_vocab: int, draft_vocab: int,
                    k: int, n_new: int, error_cls):
    if batch != 1:
        raise error_cls(
            "speculative decoding serves one sequence at a time "
            f"(got batch {batch}); per-row acceptance lengths would "
            "make the batch ragged"
        )
    if draft_vocab != target_vocab:
        raise error_cls(
            f"draft vocab {draft_vocab} != target vocab {target_vocab}"
        )
    if k < 1:
        raise error_cls(f"k must be >= 1 (got {k})")
    if n_new < 1:
        raise error_cls(f"n_new must be >= 1 (got {n_new})")


__all__ = ["speculative_loop", "check_spec_args", "lookup_propose"]
