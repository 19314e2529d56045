"""Vision Transformer in the kernel DSL (Dosovitskiy et al. 2021).

The vision entry in the attention model zoo: images are cut into
non-overlapping patches by an index-remapping kernel (pure index
arithmetic — the gather never materializes an im2col buffer bigger than
the patch tensor itself), linearly embedded, tagged with a learned
position table, and run through pre-norm NON-causal transformer blocks
(the same fused flash/XLA attention extern the causal LMs use, so the
attention-weight matrix never hits HBM on the flash path).  Mean-pool +
softmax classifier head.  The reference's vision story stops at CNNs
(examples/fashion_mnist/fashion_mnist.nim); this shows the language
spans the post-CNN vision family too.
"""

from __future__ import annotations

from ..expr import iters
from ..fun import Fun, input, make_opt, param
from ..layers import adam, cross_entropy, dense, relu, rms_norm, softmax

__all__ = ["tiny_vit", "patchify"]


def patchify(images: Fun, image: int, patch: int) -> Fun:
    """[batch, image, image] -> [batch, (image/patch)^2, patch*patch].

    Token ``t`` is patch row ``t // grid``, column ``t % grid``; element
    ``q`` is in-patch row ``q // patch``, column ``q % patch`` — one
    kernel of computed reads, no intermediate copies.  (Indices are
    non-negative, so the language's Nim-style truncated div/mod agree
    with floor semantics here.)
    """
    if image % patch != 0:
        raise ValueError(f"patch {patch} must divide image size {image}")
    grid = image // patch
    n, t, q = iters("n", "t", "q")
    out = Fun("patches")
    out[n, t, q] = images[
        n,
        (t // grid) * patch + q // patch,
        (t % grid) * patch + q % patch,
    ]
    out.with_shape([images.shape[0], grid * grid, patch * patch])
    return out


def _residual(a: Fun, b: Fun, name: str) -> Fun:
    n, t, d = iters("n", "t", "d")
    out = Fun(name)
    out[n, t, d] = a[n, t, d]
    n, t, d = iters("n", "t", "d")
    out[n, t, d] = b[n, t, d]  # second kernel accumulates
    return out


def tiny_vit(
    image: int = 12,
    patch: int = 4,
    dim: int = 16,
    heads: int = 2,
    hidden: int = 32,
    blocks: int = 2,
    classes: int = 4,
    eta: float = 0.01,
    init: float = 0.15,
    impl: str = "auto",
) -> list[Fun]:
    """Inputs: "x" [batch, image, image] and "labels" [batch, classes]
    one-hot.  Targets: "predict", "loss", "train"."""
    from ..layers import multi_head_attention

    rng = (-init, init)
    grid = image // patch
    tokens = grid * grid

    x = patchify(input("x"), image, patch)
    x = dense(x, patch * patch, dim, rank=3, prefix="embed.")

    # learned position table (second kernel accumulates it onto x)
    pos = param([tokens, dim], init_range=rng, name="pos")
    n, t, d = iters("n", "t", "d")
    emb = Fun("embedded")
    emb[n, t, d] = x[n, t, d]
    n, t, d = iters("n", "t", "d")
    emb[n, t, d] = pos[t, d]
    x = emb

    for b in range(blocks):
        att = multi_head_attention(
            rms_norm(x, dim, rank=3, prefix=f"blk{b}.att."),
            dim, heads, causal=False, impl=impl, prefix=f"blk{b}.",
        )
        x = _residual(att, x, f"blk{b}.att")
        ff = dense(
            relu(dense(
                rms_norm(x, dim, rank=3, prefix=f"blk{b}.ffn."),
                dim, hidden, rank=3, prefix=f"blk{b}.ffn1.",
            )),
            hidden, dim, rank=3, prefix=f"blk{b}.ffn2.",
        )
        x = _residual(ff, x, f"blk{b}.ffn")

    n, t, c = iters("n", "t", "c")
    pooled = Fun("pooled")
    pooled[n, c] = x[n, t, c] * (1.0 / tokens)

    logits = dense(pooled, dim, classes, prefix="head.")
    probs = softmax(logits)
    predict = probs.target("predict")
    loss = cross_entropy(predict, input("labels")).target("loss")
    train = loss.backwards().optimize(make_opt(adam, eta=eta)).target("train")
    return [predict, loss, train]
