"""XOR MLPs: the minimal end-to-end training networks.

Parity: reference examples/xor (layer API) and examples/xor_from_scratch
(hand-written kernels with derived backprop), cf. README.md:6-53.
"""

from __future__ import annotations

from ..expr import exp, iters, select, sq
from ..fun import Fun, input, make_opt, param
from ..layers import dense, gradient_descent, leaky_relu, mse, sigmoid


def xor_mlp(rate: float = 0.1, opt=None) -> Fun:
    """dense(2,4) -> leaky_relu -> dense(4,1) -> sigmoid, MSE loss; SGD by
    default, or any ``make_opt(...)`` via ``opt``."""
    return (
        input("x")
        .pipe(dense, 2, 4)
        .pipe(leaky_relu)
        .pipe(dense, 4, 1)
        .pipe(sigmoid)
        .target("predict")
        .pipe(mse, input("y"))
        .target("loss")
        .backprop(opt or make_opt(gradient_descent, rate=rate))
        .target("train")
    )


def xor_from_scratch(rate: float = 0.1) -> Fun:
    """The same network written directly in the kernel language."""
    y, x, it = iters("y", "x", "it")
    hidden = Fun("hidden")
    hidden[y, x] = input("x")[y, it] * param([2, 4])[it, x]
    y, x = iters("y", "x")
    hidden[y, x] = param([4])[x]

    it = iters("it")
    hidden_relu = Fun("hidden_relu")
    hidden_relu.raw[it] = select(
        hidden.raw[it] <= 0.0, 0.1 * hidden.raw[it], hidden.raw[it]
    )

    y, x, it = iters("y", "x", "it")
    output = Fun("output")
    output[y, x] = hidden_relu[y, it] * param([4, 1])[it, x]
    y, x = iters("y", "x")
    output[y, x] = param([1])[x]

    it = iters("it")
    output_sigmoid = Fun("output_sigmoid")
    output_sigmoid.raw[it] = 1.0 / (1.0 + exp(-output.raw[it]))
    pred = output_sigmoid.target("predict")

    it = iters("it")
    loss = Fun("loss")
    loss[0] = sq(pred.raw[it] - input("y").raw[it])

    def optim(p: Fun, g: Fun) -> None:
        i = iters("i")
        p.raw[i] = -rate * g.raw[i]

    return loss.target("loss").backprop(optim).target("train")
