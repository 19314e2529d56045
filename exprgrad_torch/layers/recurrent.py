"""Recurrent layers: LSTM / GRU / tanh-RNN over [batch, time, features].

The recurrence runs as a whole-op extern (ops/recurrent.py — a
``lax.scan`` on the jax backend, explicit loops in the numpy oracle)
with a registered BPTT backward, so training targets differentiate
through time via the symbolic autodiff pass like any other layer.
States start at zero each call; stack layers by feeding one recurrent
layer's [n, T, H] output to the next.  The reference has no recurrent
family (its layers top out at conv/dense, layers/dnn.nim); this is the
DSL-level capability its sequential-loop semantics would have implied.
"""

from __future__ import annotations

from ..fun import Fun, extern, extern_grads, grad, layer, param

__all__ = ["lstm", "gru", "rnn_tanh"]


def _recurrent(cell: str, n_gates: int, x: Fun, input_dim: int,
               hidden: int, init: float, prefix: str) -> Fun:
    if hidden < 1 or input_dim < 1:
        raise ValueError(
            f"{cell}: input_dim and hidden must be >= 1 "
            f"(got {input_dim}, {hidden})")
    rng = (-init, init)
    wx = param([input_dim, n_gates * hidden], init_range=rng,
               name=f"{prefix}{cell}.wx")
    wh = param([hidden, n_gates * hidden], init_range=rng,
               name=f"{prefix}{cell}.wh")
    b = param([n_gates * hidden], name=f"{prefix}{cell}.b")

    out = extern(cell, [x, wx, wh, b])
    out.name = prefix + cell
    out.with_shape([x.shape[0], x.shape[1], hidden])
    with out.custom_grad():
        extern_grads(
            cell + "_grad",
            [x, wx, wh, b, grad(out)],
            into=[grad(x), grad(wx), grad(wh), grad(b)],
        )
    return out


@layer
def lstm(x: Fun, input_dim: int, hidden: int, init: float = 0.1,
         prefix: str = "") -> Fun:
    """LSTM over ``[batch, T, input_dim]`` -> ``[batch, T, hidden]``
    (gate order i, f, g, o; zero initial h/c; single bias)."""
    return _recurrent("lstm", 4, x, input_dim, hidden, init, prefix)


@layer
def gru(x: Fun, input_dim: int, hidden: int, init: float = 0.1,
        prefix: str = "") -> Fun:
    """GRU over ``[batch, T, input_dim]`` -> ``[batch, T, hidden]``
    (gate order z, r, n; ``h' = (1-z) n + z h``)."""
    return _recurrent("gru", 3, x, input_dim, hidden, init, prefix)


@layer
def rnn_tanh(x: Fun, input_dim: int, hidden: int, init: float = 0.1,
             prefix: str = "") -> Fun:
    """Vanilla tanh RNN over ``[batch, T, input_dim]``."""
    return _recurrent("rnn_tanh", 1, x, input_dim, hidden, init, prefix)
