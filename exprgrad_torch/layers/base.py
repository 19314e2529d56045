"""Elementwise ops, matmul, optimizers and losses.

Parity: reference exprgrad/layers/base.nim.  Also wires Python operators
onto ``Fun`` (+, -, * for matmul/scalar-scale, / for scalar division).
"""

from __future__ import annotations

from ..expr import (
    epoch,
    iters,
    ln,
    maximum,
    minimum,
    pow_,
    select,
    sq,
    sqrt,
    to_scalar,
)
from ..fun import Fun, cache, layer


@layer
def add(a: Fun, b: Fun) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = a.raw[it] + b.raw[it]
    return out


@layer
def sub(a: Fun, b: Fun) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = a.raw[it] - b.raw[it]
    return out


@layer
def minimum_elems(a: Fun, b: Fun) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = minimum(a.raw[it], b.raw[it])
    return out


@layer
def maximum_elems(a: Fun, b: Fun) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = maximum(a.raw[it], b.raw[it])
    return out


@layer
def mul_scalar(a: Fun, factor: float) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = a.raw[it] * factor
    return out


@layer
def div_scalar(a: Fun, factor: float) -> Fun:
    it = iters("it")
    out = Fun()
    out.raw[it] = a.raw[it] / factor
    return out


@layer
def matmul(a: Fun, b: Fun) -> Fun:
    y, x, it = iters("y", "x", "it")
    out = Fun()
    out[y, x] = a[y, it] * b[it, x]
    return out


@layer
def transpose(mat: Fun) -> Fun:
    y, x = iters("y", "x")
    out = Fun()
    out[y, x] = mat[x, y]
    return out


# --- optimizers -----------------------------------------------------------

def gradient_descent(param: Fun, grad: Fun, rate: float = 0.01) -> None:
    it = iters("it")
    param.raw[it] = -grad.raw[it] * rate


def decayed_gradient_descent(
    param: Fun,
    grad: Fun,
    rate: float = 0.01,
    decay: float = 0.5,
    every: int = 10,
) -> None:
    """SGD with step decay WRITTEN IN THE LANGUAGE: the learning rate is a
    kernel expression of ``epoch()`` (``rate * decay^(epoch // every)``),
    so the schedule compiles into the training program itself — no host
    callback per step.  Any schedule expressible with scalar ops works the
    same way (cosine via ``cos``, warmup via ``select``)."""
    it = iters("it")
    lr = rate * pow_(decay, to_scalar(epoch() // every))
    param.raw[it] = -grad.raw[it] * lr


def adam(
    param: Fun,
    grad: Fun,
    eta: float = 0.01,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> None:
    """Kingma & Ba, "Adam: A Method for Stochastic Optimization", 2014.

    Optimizer state lives in cache tensors; bias correction uses the
    ``epoch()`` instruction (reference layers/base.nim:40-53).
    """
    m = cache(param, "adam.m")
    v = cache(param, "adam.v")
    it = iters("it")
    m.raw[it] = m.raw[it] * (beta1 - 1.0) + (1.0 - beta1) * grad.raw[it]
    it = iters("it")
    v.raw[it] = v.raw[it] * (beta2 - 1.0) + (1.0 - beta2) * sq(grad.raw[it])
    it = iters("it")
    m_hat = m.raw[it] / (1.0 - pow_(beta1, to_scalar(epoch())))
    v_hat = v.raw[it] / (1.0 - pow_(beta2, to_scalar(epoch())))
    param.raw[it] = -eta * m_hat / (sqrt(v_hat) + eps)


def momentum(
    param: Fun,
    grad: Fun,
    eta: float = 0.01,
    mu: float = 0.9,
    nesterov: bool = False,
) -> None:
    """Polyak momentum SGD, optionally Nesterov.

    Velocity lives in a cache tensor (``v <- mu*v + g``; cache writes
    accumulate, so the statement adds ``v*(mu-1) + g``).  The update is
    ``-eta*v``, or ``-eta*(g + mu*v)`` with the Nesterov look-ahead.
    Beyond the reference's gd/adam pair (layers/base.nim:33-53) but built
    from the same cache + accumulate-write seam.
    """
    vel = cache(param, "momentum.v")
    it = iters("it")
    vel.raw[it] = vel.raw[it] * (mu - 1.0) + grad.raw[it]
    it = iters("it")
    if nesterov:
        param.raw[it] = -eta * (grad.raw[it] + mu * vel.raw[it])
    else:
        param.raw[it] = -eta * vel.raw[it]


def rmsprop(
    param: Fun,
    grad: Fun,
    eta: float = 0.001,
    rho: float = 0.9,
    eps: float = 1e-8,
) -> None:
    """Tieleman & Hinton RMSProp: leaky average of squared gradients in a
    cache tensor, update scaled by its root."""
    avg = cache(param, "rmsprop.sq")
    it = iters("it")
    avg.raw[it] = avg.raw[it] * (rho - 1.0) + (1.0 - rho) * sq(grad.raw[it])
    it = iters("it")
    param.raw[it] = -eta * grad.raw[it] / (sqrt(avg.raw[it]) + eps)


def adamw(
    param: Fun,
    grad: Fun,
    eta: float = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> None:
    """Loshchilov & Hutter, "Decoupled Weight Decay Regularization", 2019.

    Adam moments + bias correction exactly as :func:`adam`, plus a decay
    term read from the pre-step parameter value in the same statement
    (reads see the old buffer; the write accumulates), i.e.
    ``p <- p - eta*(m_hat/(sqrt(v_hat)+eps) + wd*p)``.  Applied uniformly
    to every parameter ``make_opt`` hands it — exclude biases/norm gains
    by optimizing those targets with a separate optimizer if needed.
    """
    m = cache(param, "adamw.m")
    v = cache(param, "adamw.v")
    it = iters("it")
    m.raw[it] = m.raw[it] * (beta1 - 1.0) + (1.0 - beta1) * grad.raw[it]
    it = iters("it")
    v.raw[it] = v.raw[it] * (beta2 - 1.0) + (1.0 - beta2) * sq(grad.raw[it])
    it = iters("it")
    m_hat = m.raw[it] / (1.0 - pow_(beta1, to_scalar(epoch())))
    v_hat = v.raw[it] / (1.0 - pow_(beta2, to_scalar(epoch())))
    param.raw[it] = -eta * (
        m_hat / (sqrt(v_hat) + eps) + weight_decay * param.raw[it]
    )


def lion(
    param: Fun,
    grad: Fun,
    eta: float = 1e-4,
    beta1: float = 0.9,
    beta2: float = 0.99,
    weight_decay: float = 0.0,
) -> None:
    """Chen et al., "Symbolic Discovery of Optimization Algorithms"
    (Lion), 2023: ``u = sign(beta1*m + (1-beta1)*g); p -= eta*(u + wd*p);
    m <- beta2*m + (1-beta2)*g``.

    The lowering emits a cache's writer kernels before any reader kernel
    (statement source order does NOT survive), so a read of ``m`` in the
    update always sees the NEW momentum.  The paper's interpolation of
    the OLD momentum is therefore recovered algebraically:
    ``m_old = (m_new - (1-beta2)*g)/beta2``, giving
    ``u = (beta1/beta2)*m_new + ((1-beta1) - beta1*(1-beta2)/beta2)*g``
    (which is why ``beta2`` must be nonzero).
    """
    if not 0.0 < beta2 <= 1.0:
        raise ValueError(f"beta2 must be in (0, 1] (got {beta2})")
    m = cache(param, "lion.m")
    it = iters("it")
    m.raw[it] = m.raw[it] * (beta2 - 1.0) + (1.0 - beta2) * grad.raw[it]
    it = iters("it")
    c_m = beta1 / beta2
    c_g = (1.0 - beta1) - beta1 * (1.0 - beta2) / beta2
    u = c_m * m.raw[it] + c_g * grad.raw[it]
    s = select(u > 0.0, 1.0, select(u < 0.0, -1.0, 0.0))
    param.raw[it] = -eta * (s + weight_decay * param.raw[it])


def adafactor(
    param: Fun,
    grad: Fun,
    eta: float | None = None,
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    clip_threshold: float = 1.0,
    decay_power: float = 0.8,
    weight_decay: float = 0.0,
    factored: bool = True,
    scale_by_param: bool | None = None,
) -> None:
    """Shazeer & Stern, "Adafactor: Adaptive Learning Rates with Sublinear
    Memory Cost", 2018 — the TPU-classic memory-frugal optimizer.

    For a rank>=2 parameter the second moment is FACTORED into per-row and
    per-column leaky means over the trailing two dims (``vr``/``vc`` cache
    tensors via :func:`exprgrad_torch.cache`'s explicit-shape seam), so the
    optimizer state is O(R+C) instead of O(R*C); ``v_hat = vr*vc/mean(vr)``
    reconstructs the rank-1 estimate (Alg. 4 of the paper, mean form).
    Rank<2 parameters (and ``factored=False``) keep a full-shape moment.
    Everything else follows the paper's defaults: decay
    ``rho_t = 1 - t^-decay_power`` with ``t = epoch()``, update clipping by
    ``max(1, RMS(u)/clip_threshold)``, relative step size
    ``min(1e-2, 1/sqrt(t))`` when ``eta`` is None, scaled by
    ``max(eps2, RMS(param))`` (``scale_by_param``, default: on exactly when
    the relative step is used).

    The whole update — factored moments, three scalar reductions, the
    parameter write — compiles into the one-jit training program like any
    other optimizer in this zoo (cache recurrences + dataflow ordering;
    see :func:`adam`).  Beyond the reference's gd/adam pair
    (layers/base.nim:33-53).
    """
    if scale_by_param is None:
        scale_by_param = eta is None
    p_node = getattr(param, "effect", None)
    shape = list(getattr(p_node, "param_shape", None) or [])
    total = 1
    for d in shape:
        total *= d

    def rho_m1():
        # rho_t - 1 = -t^-decay_power; fresh nodes per kernel statement
        return -pow_(to_scalar(epoch()), -decay_power)

    u = Fun()
    if factored and len(shape) >= 2:
        n = len(shape)
        r_count, c_count = float(shape[-2]), float(shape[-1])
        vr = cache(param, "adafactor.vr", shape=shape[:-1])
        vc = cache(param, "adafactor.vc", shape=shape[:-2] + [shape[-1]])

        def axes():
            idx = iters(*[f"i{k}" for k in range(n)])
            idx = idx if isinstance(idx, tuple) else (idx,)
            return idx, idx[:-2], idx[-2], idx[-1]

        # vr <- rho*vr + (1-rho) * mean_c(g^2 + eps1)   (write accumulates
        # over the c loop; the old-value decay term is split across it)
        idx, lead, r, c = axes()
        d = rho_m1()
        g2 = sq(grad[idx]) + eps1
        vr[lead + (r,)] = (vr[lead + (r,)] * d - d * g2) / c_count

        idx, lead, r, c = axes()
        d = rho_m1()
        g2 = sq(grad[idx]) + eps1
        vc[lead + (c,)] = (vc[lead + (c,)] * d - d * g2) / r_count

        # mean over rows of the fresh vr (writers order before readers)
        vrm = Fun()
        idx, lead, r, c = axes()
        vrm[lead if lead else (0,)] = vr[lead + (r,)] / r_count

        idx, lead, r, c = axes()
        v_hat = (
            vr[lead + (r,)] * vc[lead + (c,)]
            / vrm[lead if lead else (0,)]
        )
        u[idx] = grad[idx] / sqrt(v_hat)
    else:
        v = cache(param, "adafactor.v")
        it = iters("it")
        d = rho_m1()
        v.raw[it] = v.raw[it] * d - d * (sq(grad.raw[it]) + eps1)
        it = iters("it")
        u.raw[it] = grad.raw[it] / sqrt(v.raw[it])

    # scalar reductions: RMS of the update and of the parameter
    usq = Fun()
    it = iters("it")
    usq[0] = sq(u.raw[it]) / float(total or 1)
    if scale_by_param:
        # read the underlying PARAM node (same tensor id as the effect):
        # reading the effect from a separate kernel would make the effect
        # a child of psq AND psq a child of the effect — a flatten cycle
        p_read = p_node if p_node is not None else param
        psq = Fun()
        it = iters("it")
        psq[0] = sq(p_read.raw[it]) / float(total or 1)
        # psq reads nothing on the loss path, so flatten would emit its
        # kernel BEFORE the backwards generator — where autodiff would try
        # to differentiate it.  An explicit dependency on the gradient
        # orders it after the backward pass (numerically inert: psq still
        # reads the pre-update parameter, which only this optimizer writes).
        psq.children.insert(0, grad)

    it = iters("it")
    if eta is None:
        lr = minimum(0.01, 1.0 / sqrt(to_scalar(epoch())))
    else:
        lr = eta
    alpha = maximum(sqrt(psq.raw[0]), eps2) * lr if scale_by_param else lr
    denom = maximum(sqrt(usq.raw[0]) / clip_threshold, 1.0)
    param.raw[it] = -alpha * (
        u.raw[it] / denom + weight_decay * param.raw[it]
    )


def muon(
    param: Fun,
    grad: Fun,
    eta: float = 0.02,
    mu: float = 0.95,
    nesterov: bool = True,
    ns_steps: int = 5,
    eps: float = 1e-7,
) -> None:
    """Jordan et al., "Muon: MomentUm Orthogonalized by Newton-Schulz"
    (2024) — the matmul-native optimizer: the momentum buffer of a
    rank-2 parameter is approximately ORTHOGONALIZED by ``ns_steps``
    quintic Newton-Schulz iterations before the update, all expressed as
    DSL matmul kernels the compiler lowers onto the MXU like any other
    contraction (A = X X^T, B = b A + c A^2, X <- a X + B X).

    Rank-2 parameters get the full treatment (orthogonalizing over the
    SMALLER side when rows > cols, update scaled by sqrt(max(1, R/C)));
    other ranks fall back to plain (Nesterov) momentum — the standard
    Muon deployment recipe (embeddings/norms/biases use a conventional
    optimizer).  Step-exact against a numpy replica
    (tests/test_optimizers.py).
    """
    a_c, b_c, c_c = 3.4445, -4.7750, 2.0315
    m = cache(param, "muon.m")
    it = iters("it")
    m.raw[it] = m.raw[it] * (mu - 1.0) + grad.raw[it]
    shape = list(getattr(getattr(param, "effect", None), "param_shape",
                         None) or [])
    if len(shape) != 2:
        it = iters("it")
        if nesterov:
            param.raw[it] = -eta * (grad.raw[it] + mu * m.raw[it])
        else:
            param.raw[it] = -eta * m.raw[it]
        return

    rows, cols = shape
    flip = rows > cols  # orthogonalize over the smaller dimension
    n = cols if flip else rows  # X is [n, k] with n <= k

    def mat(write_fn):
        out = Fun()
        write_fn(out)
        return out

    # g_used, laid out as X's [n, k] (transposed when flip)
    def read_g(i, j):
        gi, gj = (j, i) if flip else (i, j)
        if nesterov:
            return grad[gi, gj] + mu * m[gi, gj]
        return m[gi, gj]

    i, j = iters("i", "j")
    nrm = Fun()
    nrm[0] = sq(read_g(i, j))
    i, j = iters("i", "j")
    x = Fun()
    x[i, j] = read_g(i, j) / (sqrt(nrm.raw[0]) + eps)
    x.with_shape([n, shape[0] if flip else shape[1]])

    for _ in range(ns_steps):
        i, j, k = iters("i", "j", "k")
        a = mat(lambda o: o.__setitem__((i, j), x[i, k] * x[j, k]))
        i, j, k = iters("i", "j", "k")
        aa = mat(lambda o: o.__setitem__((i, j), a[i, k] * a[k, j]))
        i, j = iters("i", "j")
        b = mat(lambda o: o.__setitem__(
            (i, j), b_c * a[i, j] + c_c * aa[i, j]))
        i, j, k = iters("i", "j", "k")
        bx = mat(lambda o: o.__setitem__((i, j), b[i, k] * x[k, j]))
        i, j = iters("i", "j")
        x = mat(lambda o: o.__setitem__(
            (i, j), a_c * x[i, j] + bx[i, j]))

    scale = eta * max(1.0, rows / cols) ** 0.5
    i, j = iters("i", "j")
    if flip:
        param[i, j] = -scale * x[j, i]
    else:
        param[i, j] = -scale * x[i, j]


def clip_gradients(opt, bound: float):
    """Wrap any bound optimizer with elementwise gradient clipping to
    ``[-bound, bound]``: the clipped gradient is an ordinary intermediate
    kernel the wrapped optimizer consumes.

    ``net.backprop(clip_gradients(make_opt(adam, eta=1e-3), 1.0))``
    """
    def wrapped(param: Fun, grad: Fun) -> None:
        it = iters("it")
        clipped = Fun()
        clipped.raw[it] = minimum(maximum(grad.raw[it], -bound), bound)
        opt(param, clipped)

    return wrapped


def clip_by_global_norm(opt, max_norm: float, eps: float = 1e-12):
    """Wrap any bound optimizer with GLOBAL-norm gradient clipping
    (the torch ``clip_grad_norm_`` / optax ``clip_by_global_norm``
    semantics): every gradient is scaled by
    ``min(1, max_norm / ||all grads||_2)``.

    Cross-tensor reductions fall out of the dataflow: each wrapped call
    adds one accumulation kernel ``total[0] ++= g_i^2`` to ONE shared
    scalar tensor, and every scaled-gradient kernel reads ``total[0]`` —
    the lowering orders all writers of a tensor before any reader, so the
    scale sees the full sum regardless of parameter order.  The whole
    thing stays inside the one-jit training program.

    The shared tensor is keyed per ``optimize()``/``backprop()`` call
    (by the backwards node the gradients hang off), so one recipe object
    is reusable across models and across multiple backprop targets
    without cross-contaminating their norms.
    """
    import weakref

    # weakrefs so a long-lived recipe doesn't pin every graph it was
    # ever compiled into (the total Fun references the whole loss graph)
    totals: dict[int, "weakref.ref[Fun]"] = {}

    def wrapped(param: Fun, grad: Fun) -> None:
        # grad is the GRADIENT node [backwards, param]; all grads of one
        # optimize() call share the backwards child
        key = id(grad.children[0]) if grad.children else id(grad)
        total = totals.get(key, lambda: None)()
        if total is None:
            for k in [k for k, r in totals.items() if r() is None]:
                del totals[k]  # drop entries whose graphs were collected
            total = Fun()
            totals[key] = weakref.ref(total)
        it = iters("it")
        total[0] = sq(grad.raw[it])
        it = iters("it")
        scaled = Fun()
        scale = minimum(1.0, max_norm / (sqrt(total.raw[0]) + eps))
        scaled.raw[it] = grad.raw[it] * scale
        opt(param, scaled)

    return wrapped


def with_ema(opt, decay: float = 0.999):
    """Wrap any bound optimizer with an exponential moving average of the
    parameters (Polyak averaging — the standard eval/serving smoother).

    The shadow lives in a cache tensor named ``"ema"`` updated from the
    POST-update parameter via the post-effects seam
    (``ema <- decay*ema + (1-decay)*p``); a companion ``"ema.w"`` cache
    follows the same recurrence toward 1, so the exact debias factor is
    tracked IN the program — :meth:`Model.ema_params` divides the two
    and is correct no matter how steps map to ``model.epoch`` (per-step
    ``apply`` and per-epoch ``fit`` both work).  Both caches ride
    checkpoints like any optimizer state.

    ``net.backprop(with_ema(make_opt(adam, eta=1e-3), 0.999))``
    """
    if not 0.0 < decay < 1.0:
        raise ValueError(f"decay must be in (0, 1) (got {decay})")

    def wrapped(param: Fun, grad: Fun) -> None:
        opt(param, grad)
        e = cache(param, "ema")
        it = iters("it")
        e.raw[it] = e.raw[it] * (decay - 1.0) + (1.0 - decay) * param.raw[it]
        w = cache(param, "ema.w")
        it = iters("it")
        w.raw[it] = w.raw[it] * (decay - 1.0) + (1.0 - decay)
        param.post_effects.append(e)
        param.post_effects.append(w)

    return wrapped


# --- losses ---------------------------------------------------------------

@layer
def mse(a: Fun, b: Fun) -> Fun:
    it = iters("it")
    out = Fun()
    out[0] = sq(a.raw[it] - b.raw[it]) / to_scalar(a.shape[0])
    return out


@layer
def binary_cross_entropy(pred: Fun, labels: Fun) -> Fun:
    """BCE with probabilities clamped away from 0 (the reference's
    unclamped ln, base.nim:60-64, produces NaN once a confident model
    underflows a probability to exactly zero)."""
    it = iters("it")
    out = Fun()
    p = maximum(pred.raw[it], 1e-12)
    q = maximum(1.0 - pred.raw[it], 1e-12)
    out[0] = -(
        labels.raw[it] * ln(p) + (1.0 - labels.raw[it]) * ln(q)
    ) / to_scalar(pred.shape[0])
    return out


@layer
def cross_entropy(pred: Fun, labels: Fun) -> Fun:
    """Cross entropy with clamped ln (see binary_cross_entropy note;
    reference base.nim:66-67 NaNs at ~zero predicted probabilities)."""
    it = iters("it")
    out = Fun()
    out[0] = -(
        labels.raw[it] * ln(maximum(pred.raw[it], 1e-12))
    ) / to_scalar(pred.shape[0])
    return out


@layer
def smoothed_cross_entropy(pred: Fun, labels: Fun, classes: int,
                           alpha: float = 0.1) -> Fun:
    """Label-smoothed cross entropy: targets become
    ``(1-alpha)*labels + alpha/classes``.  Standard LM/vision
    regularizer; beyond the reference's loss trio."""
    it = iters("it")
    out = Fun()
    target = (1.0 - alpha) * labels.raw[it] + alpha / float(classes)
    out[0] = -(target * ln(maximum(pred.raw[it], 1e-12))) / to_scalar(
        pred.shape[0]
    )
    return out


@layer
def l1_loss(a: Fun, b: Fun) -> Fun:
    """Mean absolute error (|d| as select on the sign: no abs op needed,
    and the subgradient at 0 is 0 via the false branch)."""
    it = iters("it")
    out = Fun()
    d = a.raw[it] - b.raw[it]
    out[0] = select(d < 0.0, -d, d) / to_scalar(a.shape[0])
    return out


@layer
def huber(a: Fun, b: Fun, delta: float = 1.0) -> Fun:
    """Huber loss: quadratic within ``delta``, linear outside —
    mse's robustness fix for outlier-heavy regression."""
    it = iters("it")
    out = Fun()
    d = a.raw[it] - b.raw[it]
    ad = select(d < 0.0, -d, d)
    quad = 0.5 * sq(d)
    lin = delta * (ad - 0.5 * delta)
    out[0] = select(ad < delta, quad, lin) / to_scalar(a.shape[0])
    return out


# --- Fun operator sugar ---------------------------------------------------

def _fun_add(self: Fun, other):
    if isinstance(other, Fun):
        return add(self, other)
    return NotImplemented


def _fun_sub(self: Fun, other):
    if isinstance(other, Fun):
        return sub(self, other)
    return NotImplemented


def _fun_mul(self: Fun, other):
    if isinstance(other, Fun):
        return matmul(self, other)
    if isinstance(other, (int, float)):
        return mul_scalar(self, float(other))
    return NotImplemented


def _fun_rmul(self: Fun, other):
    if isinstance(other, (int, float)):
        return mul_scalar(self, float(other))
    return NotImplemented


def _fun_div(self: Fun, other):
    if isinstance(other, (int, float)):
        return div_scalar(self, float(other))
    return NotImplemented


Fun.__add__ = _fun_add  # type: ignore[assignment]
Fun.__sub__ = _fun_sub  # type: ignore[assignment]
Fun.__mul__ = _fun_mul  # type: ignore[assignment]
Fun.__rmul__ = _fun_rmul  # type: ignore[assignment]
Fun.__truediv__ = _fun_div  # type: ignore[assignment]
