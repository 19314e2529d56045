"""Recurrent cell externs: LSTM / GRU / tanh-RNN over time.

The port's counterpart of ``exprgrad_tpu/ops/recurrent.py``.  A
recurrence cannot live inside one DSL kernel (a kernel's reads of its own
output see the contents before the kernel), so each cell is a whole-op
extern, and symbolic autodiff calls its ``_grad`` op.  The input
projection is hoisted out of the time loop as one matmul over
``[n*T, in]``, as ``_jax_cell_scan`` does; a Python loop over the T steps
is the scan, each step one ``h @ wh`` and the gate arithmetic.  The
backward is full BPTT: ``torch.autograd.grad`` through the same loop,
where the JAX package takes ``jax.vjp`` of its ``lax.scan``.

Weight layout (single-bias convention, the JAX package's):

* lstm:  wx [in, 4H], wh [H, 4H], b [4H]; gate order (i, f, g, o);
  ``c' = sig(f) c + sig(i) tanh(g)``, ``h' = sig(o) tanh(c')``.
* gru:   wx [in, 3H], wh [H, 3H], b [3H]; gate order (z, r, n);
  ``n = tanh(an + r * hn)``, ``h' = (1 - z) n + z h``.
* rnn_tanh: wx [in, H], wh [H, H], b [H]; ``h' = tanh(a)``.

States start at zero (h0 = c0 = 0); the op returns the full hidden
sequence [n, T, H].  The dtype rule is that of :mod:`.moe`: float32 for
float32 and bfloat16 programs, float64 for float64.
"""

from __future__ import annotations

import torch

from ..registry import register_extern
from .moe import compute_dtype

CELLS = ("lstm", "gru", "rnn_tanh")


def cell_forward(cell: str, x, wx, wh, b):
    """The hidden sequence ``[n, T, H]`` in ``x``'s dtype."""
    ct = compute_dtype(x.dtype)
    xf, wx, wh, b = (a.to(ct) for a in (x, wx, wh, b))
    n, steps, _ = x.shape
    hidden = wh.shape[0]
    ax = torch.einsum("nti,ij->ntj", xf, wx) + b
    h = torch.zeros((n, hidden), dtype=ct, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(steps):
        a_t = ax[:, t]
        if cell == "lstm":
            i, f, g, o = (a_t + h @ wh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif cell == "gru":
            az, ar, an = a_t.chunk(3, dim=-1)
            hz, hr, hn = (h @ wh).chunk(3, dim=-1)
            z = torch.sigmoid(az + hz)
            r = torch.sigmoid(ar + hr)
            h = (1.0 - z) * torch.tanh(an + r * hn) + z * h
        else:
            h = torch.tanh(a_t + h @ wh)
        hs.append(h)
    if not hs:
        return torch.zeros((n, 0, hidden), dtype=x.dtype, device=x.device)
    return torch.stack(hs, dim=1).to(x.dtype)


def _make(cell: str):
    def fwd(args, attrs, ctx):
        x, wx, wh, b = args
        return cell_forward(cell, x, wx, wh, b)

    def grad(args, attrs, ctx):
        *inputs, g = args
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in inputs]
            out = cell_forward(cell, *leaves)
            grads = torch.autograd.grad(out, leaves, g.to(out.dtype),
                                        allow_unused=True)
        return tuple(torch.zeros_like(a) if d is None else d.to(a.dtype)
                     for a, d in zip(inputs, grads))

    return fwd, grad


for _cell in CELLS:
    _fwd, _grad = _make(_cell)
    register_extern(_cell, 1, _fwd)
    register_extern(_cell + "_grad", 4, _grad)
