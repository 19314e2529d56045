"""Open-loop requests: a fixed count at a fixed mean rate, with lengths
drawn log-uniform.

The schedule is the traffic's, the same for every seed: the count's
quantiles of each log-uniform law (prompt and output lengths paired by
one fixed permutation), in one fixed order, arriving after gaps that are
the count's quantiles of the exponential law of a Poisson process (in
one fixed order, scaled so that the arrivals fill the window).  The seed
draws the token ids (uniform over the vocabulary), as it draws the
weights.  Answers are greedy, of fixed length, with no stop token, so
the ids do not change the work: every seed offers the same work, and
runs of two seeds spread as two runs of one seed do.  (When the seed
also ordered the requests, `tpot_p95_ms` spread 20% across six seeds
against at most 7% between two runs of one seed.)
"""

from __future__ import annotations

import numpy as np


def _loglen(lo: int, hi: int, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
                   ).astype(np.int64)


def generate(params: dict, seed: int, seconds: float, vocab: int) -> list:
    """Requests ``{"due", "prompt", "max_new"}`` sorted by ``due`` (seconds
    after the window opens)."""
    n = max(1, int(round(params["rate_per_s"] * seconds)))
    fixed = np.random.default_rng(0x5e7e)
    pairing = fixed.permutation(n)
    prompts = _loglen(params["prompt_min"], params["prompt_max"], n)
    outputs = _loglen(params["output_min"], params["output_max"], n)[pairing]
    order = fixed.permutation(n)
    prompts, outputs = prompts[order], outputs[order]
    gaps = fixed.permutation(-np.log1p(-(np.arange(n) + 0.5) / n))
    rng = np.random.default_rng([int(seed), 0x5e7e])
    due = np.cumsum(gaps) * (seconds * n / (n + 1)) / gaps.sum()
    return [{"due": float(due[i]),
             "prompt": rng.integers(0, vocab, int(prompts[i])),
             "max_new": int(outputs[i])} for i in range(n)]


def warmup(params: dict, seed: int, vocab: int, buckets) -> list:
    """One request per prompt bucket the traffic can reach, each long
    enough to dispatch a decode chunk."""
    rng = np.random.default_rng([int(seed), 0x3a4f])
    return [{"due": 0.0, "prompt": rng.integers(0, vocab, int(w)),
             "max_new": 2 * int(params.get("decode_chunk", 1)) + 1}
            for w in buckets]
