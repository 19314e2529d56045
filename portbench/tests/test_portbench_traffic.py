"""The traffic generators: one seed gives the same traffic, two seeds
give different traffic with the same work."""

import numpy as np
import pytest
import torch

from portbench.generators import open_loglen, zipf_tokens

CHAT = {"rate_per_s": 5.0, "prompt_min": 32, "prompt_max": 1024,
        "output_min": 32, "output_max": 512}


def _key(reqs):
    return [(r["due"], tuple(r["prompt"]), r["max_new"]) for r in reqs]


def test_open_loglen_is_deterministic_and_differs_by_seed():
    a = open_loglen.generate(CHAT, 2**33 + 5, 40, 32000)
    b = open_loglen.generate(CHAT, 2**33 + 5, 40, 32000)
    c = open_loglen.generate(CHAT, 2**33 + 6, 40, 32000)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)
    # the same work: the same schedule of sizes and arrivals, other ids
    assert len(a) == len(c) == 200
    assert [(r["due"], len(r["prompt"]), r["max_new"]) for r in a] == \
        [(r["due"], len(r["prompt"]), r["max_new"]) for r in c]
    dues = [r["due"] for r in a]
    assert dues == sorted(dues) and 0 <= dues[0] and dues[-1] < 40
    # the gaps are a Poisson process's quantiles: mean 40 / 201
    assert np.mean(np.diff([0.0] + dues)) == pytest.approx(40 / 201)
    # another rate is another schedule of the same laws
    other = open_loglen.generate({**CHAT, "rate_per_s": 2.4}, 1, 50, 32000)
    assert len(other) == 120


def test_open_loglen_lengths_follow_the_law():
    reqs = open_loglen.generate(CHAT, 7, 200, 32000)
    prompts = np.array([len(r["prompt"]) for r in reqs])
    outs = np.array([r["max_new"] for r in reqs])
    assert prompts.min() >= 32 and prompts.max() <= 1024
    assert outs.min() >= 32 and outs.max() <= 512
    # log-uniform means: (hi - lo) / ln(hi / lo)
    assert abs(prompts.mean() - 992 / np.log(32)) < 3
    assert abs(outs.mean() - 480 / np.log(16)) < 2
    assert all(0 <= t < 32000 for r in reqs[:20] for t in r["prompt"])


def test_zipf_batches_are_deterministic_per_step_and_differ():
    params = {"sequences": 2, "seq_len": 64, "zipf_s": 1.1}
    a = zipf_tokens.Batches(params, 2**40 + 3, 512, torch.device("cpu"))
    b = zipf_tokens.Batches(params, 2**40 + 3, 512, torch.device("cpu"))
    c = zipf_tokens.Batches(params, 2**40 + 4, 512, torch.device("cpu"))
    assert torch.equal(a.tokens(1), b.tokens(1))
    assert not torch.equal(a.tokens(1), a.tokens(2))
    assert not torch.equal(a.tokens(1), c.tokens(1))
    args = a.args(3)
    ids = a.tokens(3)
    assert args["tokens"].shape == (2, 64)
    assert torch.equal(args["tokens"], ids[:, :-1].float())
    assert torch.equal(args["labels"].argmax(-1), ids[:, 1:])
    assert torch.equal(args["labels"].sum(-1), torch.ones(2, 64))


def test_zipf_law_is_skewed():
    params = {"sequences": 1, "seq_len": 4096, "zipf_s": 1.1}
    feed = zipf_tokens.Batches(params, 11, 32768, torch.device("cpu"))
    ids = feed.tokens(1).flatten()
    counts = torch.bincount(ids, minlength=32768).sort(descending=True)[0]
    # the most frequent id takes about 1/H(32768, 1.1) of the draws
    assert counts[0] > 400 and counts[100] < 60
