"""Beam-search machinery for the serving runtime.

Counterpart of ``exprgrad_tpu/models/_beam.py``: the per-step beam
expansion (the top ``beams`` of ``beams * vocab`` candidates), the
parent-row KV-cache gather (int8 scales included), stop-token freezing
and the reverse parent-pointer backtrace, driven through a
``step(flat_tokens, caches) -> (logits, caches)`` closure.  The JAX
package's ``lax.scan`` is a Python loop here.

Ties: ``jax.lax.top_k`` returns the lowest index among equal values,
and a finished beam's candidates tie exactly (the stop token at score 0,
everything else ``-inf``).  ``torch.topk`` promises no order among ties,
so :func:`_top` takes the head of a stable descending sort instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _top(x: torch.Tensor, n: int):
    """The ``n`` largest entries of each row of ``x`` and their indices,
    largest first, the lowest index first among equal values (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _take_rows(caches, rows: torch.Tensor):
    """Each cache with batch rows ``rows`` gathered into new tensors: the
    source rows may repeat, so nothing is reordered in place."""

    def take(x):
        return None if x is None else x[rows]

    return [c._replace(k=take(c.k), v=take(c.v), k_scale=take(c.k_scale),
                       v_scale=take(c.v_scale)) for c in caches]


def beam_search_loop(
    step: Callable,
    caches,
    logp0: torch.Tensor,
    n_new: int,
    beams: int,
    vocab: int,
    stop_token: Optional[int],
):
    """Run ``n_new - 1`` beam steps from the first-token distribution.

    ``caches`` must already be replicated per beam (batch-major
    ``[batch * beams, ...]`` rows); ``logp0`` [batch, V] is the log-prob of
    the first generated position.  ``step(tokens [b*beams, 1], caches)``
    returns logits ``[b*beams, t, V]`` (position 0 is used) and the
    caches.

    Returns ``(tokens [batch, beams, n_new] int32, scores [batch, beams])``
    best first."""
    batch = logp0.shape[0]
    dev = logp0.device
    V = vocab

    scores, tok0 = _top(logp0, beams)                   # [batch, beams]
    tok = tok0
    done = (tok == stop_token if stop_token is not None
            else torch.zeros(tok.shape, dtype=torch.bool, device=dev))
    if stop_token is not None:
        # finished beams extend only with the stop token, at zero score
        frozen = torch.full((V,), -torch.inf, device=dev)
        frozen[stop_token] = 0.0
    base = torch.arange(batch, device=dev)[:, None] * beams
    toks, parents = [], []
    for _ in range(n_new - 1):
        logits, caches = step(tok.reshape(batch * beams, 1), caches)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(
            batch, beams, V)
        if stop_token is not None:
            logp = torch.where(done[:, :, None], frozen, logp)
        cand = scores[:, :, None] + logp                # [b, beams, V]
        scores, idx = _top(cand.reshape(batch, beams * V), beams)
        parent = idx // V
        tok = idx % V
        caches = _take_rows(caches, (base + parent).reshape(-1))
        if stop_token is not None:
            done = torch.gather(done, 1, parent) | (tok == stop_token)
        toks.append(tok)
        parents.append(parent)

    # walk the parents back from the last step to recover each final
    # beam's token path
    beam_of = torch.arange(beams, device=dev)[None, :].expand(batch, beams)
    rev = []
    for step_tok, step_parent in zip(reversed(toks), reversed(parents)):
        rev.append(torch.gather(step_tok, 1, beam_of))
        beam_of = torch.gather(step_parent, 1, beam_of)
    first = torch.gather(tok0, 1, beam_of)
    seq = torch.stack([first] + rev[::-1], dim=-1)      # [b, beams, n_new]
    return seq.to(torch.int32), scores


def replicate_caches(caches, beams: int):
    """Repeat every cache row ``beams`` times (batch-major), int8 scales
    included."""

    def rep(x):
        return None if x is None else x.repeat_interleave(beams, dim=0)

    return [c._replace(k=rep(c.k), v=rep(c.v), k_scale=rep(c.k_scale),
                       v_scale=rep(c.v_scale)) for c in caches]
