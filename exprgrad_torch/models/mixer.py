"""MLP-Mixer in the kernel DSL (Tolstikhin et al. 2021).

A second modern architecture written entirely in the language (alongside
models/transformer.py): token-mixing and channel-mixing MLPs with residual
connections, mean pooling and a softmax classifier head — every matmul
becomes an MXU einsum through the standard lowering, every gradient kernel
is compiler-derived.  The reference's model zoo stops at CNNs
(examples/fashion_mnist/fashion_mnist.nim); this demonstrates the language
scales to architectures the reference never shipped.
"""

from __future__ import annotations

from ..expr import iters, maximum
from ..fun import Fun, cond, input, make_opt, param
from ..layers import adam, cross_entropy, softmax

__all__ = ["tiny_mixer"]


def _token_mix(x: Fun, tokens: int, hidden: int, rng, tag: str) -> Fun:
    """x + W2 @ relu(W1 @ x) along the TOKEN axis (per channel)."""
    w1 = param([hidden, tokens], init_range=rng, name=f"{tag}.w1")
    n, s, c, t = iters("n", "s", "c", "t")
    h = Fun(f"{tag}.h")
    h[n, s, c] = w1[s, t] * x[n, t, c]
    hr = Fun()
    i = iters("i")
    hr.raw[i] = maximum(h.raw[i], 0.1 * h.raw[i])
    hr.copy_shape(h)

    w2 = param([tokens, hidden], init_range=rng, name=f"{tag}.w2")
    n, t, c, s = iters("n", "t", "c", "s")
    out = Fun(f"{tag}.out")
    out[n, t, c] = w2[t, s] * hr[n, s, c]
    n, t, c = iters("n", "t", "c")
    out[n, t, c] = x[n, t, c]  # residual (second kernel accumulates)
    return out


def _channel_mix(x: Fun, dim: int, hidden: int, rng, tag: str) -> Fun:
    """x + W2 @ relu(W1 @ x) along the CHANNEL axis (per token)."""
    w1 = param([dim, hidden], init_range=rng, name=f"{tag}.w1")
    n, t, k, c = iters("n", "t", "k", "c")
    h = Fun(f"{tag}.h")
    h[n, t, k] = x[n, t, c] * w1[c, k]
    hr = Fun()
    i = iters("i")
    hr.raw[i] = maximum(h.raw[i], 0.1 * h.raw[i])
    hr.copy_shape(h)

    w2 = param([hidden, dim], init_range=rng, name=f"{tag}.w2")
    n, t, c, k = iters("n", "t", "c", "k")
    out = Fun(f"{tag}.out")
    out[n, t, c] = hr[n, t, k] * w2[k, c]
    n, t, c = iters("n", "t", "c")
    out[n, t, c] = x[n, t, c]  # residual
    return out


def tiny_mixer(
    tokens: int = 9,
    dim: int = 16,
    hidden: int = 32,
    classes: int = 4,
    blocks: int = 2,
    eta: float = 0.01,
    init: float = 0.15,
) -> list[Fun]:
    """Inputs: "x" [batch, tokens, dim], "labels" [batch, classes] one-hot.
    Targets: "predict", "loss", "train"."""
    rng = (-init, init)
    x: Fun = input("x")
    for b in range(blocks):
        x = _token_mix(x, tokens, hidden, rng, f"tok{b}")
        x = _channel_mix(x, dim, hidden, rng, f"chan{b}")

    # mean-pool tokens, classify
    n, t, c = iters("n", "t", "c")
    pooled = Fun("pooled")
    pooled[n, c] = x[n, t, c] * (1.0 / tokens)

    head = param([dim, classes], init_range=rng, name="head")
    bias = param([classes], init_range=rng, name="head.b")
    n, c, k = iters("n", "c", "k")
    logits = Fun("logits")
    logits[n, k] = pooled[n, c] * head[c, k]
    n, k = iters("n", "k")
    logits[n, k] = bias[k]

    probs = softmax(logits)
    predict = probs.target("predict")
    loss = cross_entropy(predict, input("labels")).target("loss")
    train = loss.backwards().optimize(make_opt(adam, eta=eta)).target("train")
    return [predict, loss, train]
