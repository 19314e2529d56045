"""Neural-network layers (parity: reference exprgrad/layers/dnn.nim).

Layers applying along the LAST dimension (dense / softmax / layer_norm /
rms_norm) are rank-polymorphic: the number of leading batch dimensions is
inferred from the graph (``fun.static_rank``) or given via ``rank=``, so
rank-3 transformer activations flow through without manual reshapes
(the reference's layers are fixed to rank 2, dnn.nim:19-100).
"""

from __future__ import annotations

from typing import Optional

from ..errors import ParserError
from ..expr import exp, iters, maximum, select
from ..fun import Fun, grad, layer, param, rand, static_rank


def _lead(values: Fun, rank: Optional[int]) -> list:
    """Leading (batch) iterators for a layer applied along the last dim."""
    r = rank if rank is not None else (static_rank(values) or 2)
    if r < 1:
        r = 2
    names = ["y"] if r == 2 else [f"b{i}" for i in range(r - 1)]
    got = iters(*names)
    return [got] if len(names) == 1 else list(got)


def _row_schedule(funs, inp: Fun, rank: Optional[int],
                  row_tile: Optional[int]) -> None:
    """Attach a row-tile schedule to every kernel of a row-family layer.

    Marks the layer's kernels scheduled so the backend fuses the whole
    chain (max/sum/normalize) into ONE Pallas kernel (PallasRowChain:
    the input row block is read once, intermediates stay in VMEM).  The
    tile lands on the innermost leading dim (the sublane dim)."""
    if row_tile is None:
        return
    r = rank if rank is not None else (static_rank(inp) or 2)
    if r < 2:
        raise ParserError(
            "row_tile requires rank >= 2 (a rank-1 input has no row "
            "dimension to tile)"
        )
    name = "y" if r == 2 else f"b{r - 2}"
    for f in funs:
        f.schedule(tile={name: int(row_tile)})


@layer
def dense(values: Fun, inp: int, outp: int, has_bias: bool = True,
          rank: Optional[int] = None, prefix: str = "") -> Fun:
    """Affine map along the last dim over any number of leading dims.

    ``prefix`` namespaces the parameter names ("<prefix>weights"/"bias")
    so servers can extract weights by unique name (the encoder-decoder
    serving contract, models/seq2seq_serve.py)."""
    weights = param([inp, outp], name=prefix + "weights")
    lead = _lead(values, rank)
    x, it = iters("x", "it")
    out = Fun()
    out[(*lead, x)] = values[(*lead, it)] * weights[it, x]
    if has_bias:
        bias = param([outp], name=prefix + "bias")
        lead = _lead(values, rank)
        x = iters("x")
        out[(*lead, x)] = bias[x]
    return out


@layer
def lora_dense(values: Fun, inp: int, outp: int, rank: int,
               alpha: Optional[float] = None, has_bias: bool = True,
               train_bias: bool = False, lead_rank: Optional[int] = None,
               prefix: str = "") -> Fun:
    """Low-rank-adapted dense layer for fine-tuning (LoRA, Hu et al. 2021).

    The base weight ``<prefix>weights`` is a FROZEN parameter (excluded
    from optimizer updates — the ``param(frozen=)`` seam); two small
    trainable adapters ``<prefix>lora_a`` ([inp, rank], scaled-uniform
    init) and ``<prefix>lora_b`` ([rank, outp], zero init) add the
    low-rank update::

        out = x @ W  +  (alpha / rank) * (x @ A) @ B  (+ bias)

    With B zero-initialized the layer starts exactly equal to the frozen
    base, and only ``2 * rank * (inp + outp)`` values train.  After
    training, ``merge_lora(model, alpha=...)`` folds the adapters into
    the base weight in place.  ``alpha`` defaults to ``rank`` (scale 1).
    The bias (if any) is frozen too unless ``train_bias=True``.

    No reference analog — the reference trains every parameter
    (parser.nim:741-775); this is fine-tuning infrastructure built on
    the same optimize() seam."""
    if rank < 1:
        raise ParserError("lora_dense() needs rank >= 1")
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    bound = float(inp) ** -0.5
    weights = param([inp, outp], name=prefix + "weights", frozen=True)
    lora_a = param([inp, rank], (-bound, bound), name=prefix + "lora_a")
    lora_b = param([rank, outp], (0.0, 0.0), name=prefix + "lora_b")

    lead = _lead(values, lead_rank)
    rr, it = iters("rr", "it")
    mid = Fun(prefix + "lora_mid" if prefix else "lora_mid")
    mid[(*lead, rr)] = values[(*lead, it)] * lora_a[it, rr]

    lead = _lead(values, lead_rank)
    x, it = iters("x", "it")
    out = Fun()
    out[(*lead, x)] = values[(*lead, it)] * weights[it, x]
    lead = _lead(values, lead_rank)
    x, rr = iters("x", "rr")
    out[(*lead, x)] = scale * mid[(*lead, rr)] * lora_b[rr, x]
    if has_bias:
        bias = param([outp], name=prefix + "bias",
                     frozen=not train_bias)
        lead = _lead(values, lead_rank)
        x = iters("x")
        out[(*lead, x)] = bias[x]
    return out


def merge_lora(model, alpha: Optional[float] = None) -> list:
    """Fold every trained LoRA adapter pair into its frozen base weight,
    in place: ``W += (alpha / rank) * A @ B``, then zero ``lora_b`` so the
    model's forward outputs are UNCHANGED (the adapter branch now adds 0).

    Matches adapters to bases by the ``lora_dense`` naming contract
    (``<p>weights`` / ``<p>lora_a`` / ``<p>lora_b``).  Pass the same
    ``alpha`` the layer was built with (default: the layer's rank, i.e.
    scale 1 — read from A's shape).  Returns the merged base-weight
    names; the merged arrays can then serve without the adapter compute
    via a plain ``dense`` model of the same names."""
    import numpy as np

    by_name: dict = {}
    for tid in model.program.params:
        nm = model.program.tensors[tid].name
        if nm:
            by_name.setdefault(nm, []).append(tid)
    merged = []
    for nm, tids in sorted(by_name.items()):
        if not nm.endswith("lora_a"):
            continue
        pre = nm[: -len("lora_a")]
        for other in (pre + "lora_b", pre + "weights"):
            if len(by_name.get(other, ())) != len(tids):
                raise ParserError(
                    f"merge_lora: {nm!r} has no matching {other!r} "
                    "(lora_dense names adapters <prefix>lora_a/lora_b/"
                    "weights)"
                )
        if len(tids) != 1:
            raise ParserError(
                f"merge_lora: {len(tids)} parameters named {nm!r}; "
                "give each lora_dense a unique prefix to merge"
            )
        a_tid = tids[0]
        b_tid = by_name[pre + "lora_b"][0]
        w_tid = by_name[pre + "weights"][0]
        a = np.asarray(model.params[a_tid])
        b = np.asarray(model.params[b_tid])
        r = a.shape[1]
        scale = (alpha if alpha is not None else float(r)) / float(r)
        w = np.asarray(model.params[w_tid])
        model.params[w_tid] = (w + scale * (a @ b)).astype(w.dtype)
        model.params[b_tid] = np.zeros_like(b)
        merged.append(pre + "weights")
    if not merged:
        raise ParserError("merge_lora: model has no lora_a parameters")
    return merged


@layer
def relu(inp: Fun) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = select(inp.raw[it] >= 0.0, inp.raw[it], 0.0)
    return out


@layer
def leaky_relu(inp: Fun, leak: float = 0.01) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = select(inp.raw[it] >= 0.0, 1.0, leak) * inp.raw[it]
    return out


@layer
def sigmoid(inp: Fun) -> Fun:
    """Logistic sigmoid; the exponent is clamped so the derived gradient
    (which multiplies exp terms) cannot overflow at large |x|."""
    from ..expr import minimum

    it = iters("it")
    out = Fun()
    out.raw[it] = 1.0 / (1.0 + exp(minimum(-inp.raw[it], 30.0)))
    return out


@layer
def silu(inp: Fun) -> Fun:
    """SiLU / swish: ``x * sigmoid(x)`` (the modern default activation;
    the gated form lives fused inside flash_transformer's SwiGLU FFN).
    Clamped like :func:`sigmoid` so large negatives don't overflow."""
    from ..expr import minimum

    it = iters("it")
    out = Fun()
    out.raw[it] = inp.raw[it] / (1.0 + exp(minimum(-inp.raw[it], 30.0)))
    return out


@layer
def tanh(inp: Fun) -> Fun:
    """tanh via clamped exponentials: the reference form (dnn.nim:36-40)
    evaluates exp(x) directly and returns NaN (inf/inf) for |x| > ~88."""
    from ..expr import minimum

    it = iters("it")
    out = Fun()
    a = exp(minimum(inp.raw[it], 30.0))
    b = exp(minimum(-inp.raw[it], 30.0))
    out.raw[it] = (a - b) / (a + b)
    return out


@layer
def sin_layer(inp: Fun) -> Fun:
    from ..expr import sin

    it = iters("it")
    out = Fun()
    out.raw[it] = sin(inp.raw[it])
    return out


@layer
def conv2(images: Fun, filters_or_chans, w: int = 0, h: int = 0,
          filters: int = 0) -> Fun:
    """2D convolution, NHWC images and [filter, dy, dx, chan] filters.

    Two forms, like the reference (dnn.nim:45-53):
    ``conv2(images, filters_fun)`` or ``conv2(images, chans, w, h, filters)``.
    """
    if isinstance(filters_or_chans, Fun):
        flt = filters_or_chans
    else:
        chans = int(filters_or_chans)
        flt = param([filters, h, w, chans], name="filters")
    image, y, x, f, dx, dy, chan = iters(
        "image", "y", "x", "filter", "dx", "dy", "chan"
    )
    out = Fun()
    out[image, y, x, f] = (
        images[image, y + dy, x + dx, chan] * flt[f, dy, dx, chan]
    )
    return out


@layer
def depthwise_conv2(images: Fun, filters_or_chans, w: int = 0,
                    h: int = 0) -> Fun:
    """Depthwise 2D convolution: one [dy, dx] filter per channel (MobileNet
    -style; beyond the reference's layer set).  The conv matcher recognizes
    the shared channel axis as a feature group and lowers the forward AND
    derived gradient kernels to grouped ``lax.conv_general_dilated`` calls.
    """
    if isinstance(filters_or_chans, Fun):
        flt = filters_or_chans
    else:
        chans = int(filters_or_chans)
        flt = param([h, w, chans], name="dw_filters")
    image, y, x, dx, dy, chan = iters("image", "y", "x", "dx", "dy", "chan")
    out = Fun()
    out[image, y, x, chan] = (
        images[image, y + dy, x + dx, chan] * flt[dy, dx, chan]
    )
    return out


def _max4(a, b, c, d):
    return maximum(maximum(a, b), maximum(c, d))


@layer
def maxpool2(images: Fun) -> Fun:
    """2x2 max pooling with a custom gradient (reference dnn.nim:58-71)."""
    image, y, x, chan = iters("image", "y", "x", "chan")
    out = Fun()
    out[image, y, x, chan] = _max4(
        images[image, y * 2, x * 2, chan],
        images[image, y * 2 + 1, x * 2, chan],
        images[image, y * 2, x * 2 + 1, chan],
        images[image, y * 2 + 1, x * 2 + 1, chan],
    )
    with out.custom_grad():
        # bound y/x to the POOLED extent *2: odd trailing rows/cols never
        # contributed to the forward max and get zero gradient.  (The
        # reference's unbounded loop, dnn.nim:64-70, reads grad(out) out of
        # bounds for odd inputs — silently clamped on GPU, a latent bug.)
        from ..expr import irange

        image, chan = iters("image", "chan")
        y = irange("y", 0, out.shape[1] * 2)
        x = irange("x", 0, out.shape[2] * 2)
        grad(images)[image, y, x, chan] = select(
            images[image, y, x, chan] == out[image, y // 2, x // 2, chan],
            grad(out)[image, y // 2, x // 2, chan],
            0.0,
        )
    out.lock()
    return out


@layer
def avgpool2(images: Fun) -> Fun:
    image, y, x, chan = iters("image", "y", "x", "chan")
    out = Fun()
    out[image, y, x, chan] = (
        images[image, y * 2, x * 2, chan]
        + images[image, y * 2 + 1, x * 2, chan]
        + images[image, y * 2, x * 2 + 1, chan]
        + images[image, y * 2 + 1, x * 2 + 1, chan]
    ) / 4.0
    return out


@layer
def upsample2(images: Fun) -> Fun:
    image, y, x, chan = iters("image", "y", "x", "chan")
    out = Fun()
    out[image, y, x, chan] = images[image, y // 2, x // 2, chan]
    out.with_shape([
        images.shape[0],
        images.shape[1] * 2,
        images.shape[2] * 2,
        images.shape[3],
    ])
    return out


@layer
def softmax(inp: Fun, rank: Optional[int] = None,
            row_tile: Optional[int] = None) -> Fun:
    """Numerically exact softmax along the last dim, any leading dims.

    The row max is computed with a max-accumulation kernel (``maximize``, a
    language extension; the reference's sum-only language cannot express it
    and its unshifted softmax, dnn.nim:90, NaNs during training: the derived
    gradient of exp(u) contains exp(u)^2, overflowing f32 at logit spread
    ~44 while the forward pass still looks fine).
    """
    lead = _lead(inp, rank)
    x = iters("x")
    row_max = Fun("softmax.max")
    row_max.maximize[tuple(lead)] = inp[(*lead, x)]
    lead = _lead(inp, rank)
    x = iters("x")
    sums = Fun("softmax.sums")
    sums[tuple(lead)] = exp(inp[(*lead, x)] - row_max[tuple(lead)])
    lead = _lead(inp, rank)
    x = iters("x")
    out = Fun()
    out[(*lead, x)] = (
        exp(inp[(*lead, x)] - row_max[tuple(lead)]) / sums[tuple(lead)]
    )
    _row_schedule((row_max, sums, out), inp, rank, row_tile)
    return out


@layer
def layer_norm(inp: Fun, dim: int, eps: float = 1e-5,
               init: float = 0.1, rank: Optional[int] = None,
               row_tile: Optional[int] = None) -> Fun:
    """Layer normalization along the last dim (Ba et al. 2016) with
    learned scale/shift — beyond the reference's layer set (dnn.nim tops
    out at softmax).  Applies over any number of leading dims.
    The mean/variance reductions and the normalization are plain kernels;
    the compiler derives the (nontrivial) gradient through both
    reductions symbolically."""
    from ..expr import sq, sqrt

    inv_d = 1.0 / dim
    n = Fun("ln.mean")
    lead = _lead(inp, rank)
    x = iters("x")
    n[tuple(lead)] = inp[(*lead, x)] * inv_d

    v = Fun("ln.var")
    lead = _lead(inp, rank)
    x = iters("x")
    v[tuple(lead)] = sq(inp[(*lead, x)] - n[tuple(lead)]) * inv_d

    gamma = param([dim], init_range=(1.0 - init, 1.0 + init), name="ln.g")
    beta = param([dim], init_range=(-init, init), name="ln.b")
    lead = _lead(inp, rank)
    x = iters("x")
    out = Fun("ln.out")
    out[(*lead, x)] = (
        (inp[(*lead, x)] - n[tuple(lead)]) / sqrt(v[tuple(lead)] + eps)
        * gamma[x] + beta[x]
    )
    _row_schedule((n, v, out), inp, rank, row_tile)
    return out


@layer
def rms_norm(inp: Fun, dim: int, eps: float = 1e-5,
             init: float = 0.1, rank: Optional[int] = None,
             prefix: str = "", row_tile: Optional[int] = None) -> Fun:
    """RMS normalization along the last dim (Zhang & Sennrich 2019):
    x / rms(x) * gamma, no mean subtraction — the norm used by modern LMs.
    Applies over any number of leading dims."""
    from ..expr import sq, sqrt

    ms = Fun("rms.ms")
    lead = _lead(inp, rank)
    x = iters("x")
    ms[tuple(lead)] = sq(inp[(*lead, x)]) * (1.0 / dim)

    gamma = param([dim], init_range=(1.0 - init, 1.0 + init),
                  name=prefix + "rms.g")
    lead = _lead(inp, rank)
    x = iters("x")
    out = Fun("rms.out")
    out[(*lead, x)] = inp[(*lead, x)] / sqrt(ms[tuple(lead)] + eps) * gamma[x]
    _row_schedule((ms, out), inp, rank, row_tile)
    return out


@layer
def dropout(inp: Fun, prob: float) -> Fun:
    noise = rand(inp, (0.0, 1.0))
    noise.name = "dropout.rand"
    it = iters("it")
    out = Fun()
    out.raw[it] = select(
        prob <= noise.raw[it], inp.raw[it] / (1.0 - prob), 0.0
    )
    out.copy_shape(inp)
    return out
