"""Stateful serving for trained tiny_recurrent_lm models on the port.

Counterpart of ``exprgrad_tpu/models/rnn_serve.py``.  A recurrent
model's whole decode state is its carried hidden (and cell) vector:
O(hidden) per sequence, no KV cache and no positions.
:class:`RecurrentServer` pulls the trained parameters out of a compiled
port model (tensors already on the model's device), matched by name, and
reproduces the recurrent extern's math (``ops/recurrent.py``: float32,
the same gate order).  The JAX package's two ``lax.scan``s (prefill over
the prompt, then generation feeding each pick back in) are Python loops
here; sampled draws come from one ``torch.Generator`` seeded with
``seed``.

Greedy output equals the argmax chain of the model's "predict" target
recomputed from scratch each step: carrying state and recomputing run
the same recurrence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..errors import ModelRuntimeError

_CELL_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1}


class _RLayer(NamedTuple):
    cell: str
    wx: torch.Tensor  # [in, gates*H]
    wh: torch.Tensor  # [H, gates*H]
    b: torch.Tensor   # [gates*H]


class RecurrentServer:
    """Incremental decoder over a trained tiny_recurrent_lm port model.

    Parameters are matched by their (name, shape) sequence — ``embed``,
    per layer ``l{i}.<cell>.wx/.wh/.b``, then ``head.weights`` /
    ``head.bias`` — and validated; a mismatch raises instead of serving
    garbage.  The server runs on the model's device."""

    def __init__(self, model):
        self.device = model.device
        seq = [(model.program.tensors[tid].name, model.params[tid])
               for tid in model.program.params]

        def take(expected: str):
            if not seq or seq[0][0] != expected:
                got = seq[0][0] if seq else "<end>"
                raise ModelRuntimeError(
                    f"unexpected parameter {got!r} (wanted {expected!r}); "
                    "RecurrentServer serves models built by "
                    "tiny_recurrent_lm")
            return seq.pop(0)[1]

        self.embed = take("embed")           # [vocab, dim]
        self.vocab, self.dim = self.embed.shape
        self.layers: list[_RLayer] = []
        li = 0
        while seq and seq[0][0].startswith(f"l{li}."):
            cell = seq[0][0].split(".")[1]
            if cell not in _CELL_GATES:
                raise ModelRuntimeError(
                    f"unknown recurrent cell {cell!r} in parameter "
                    f"{seq[0][0]!r}")
            self.layers.append(_RLayer(
                cell=cell,
                wx=take(f"l{li}.{cell}.wx").float(),
                wh=take(f"l{li}.{cell}.wh").float(),
                b=take(f"l{li}.{cell}.b").float(),
            ))
            li += 1
        if not self.layers:
            raise ModelRuntimeError(
                "no recurrent layers found; RecurrentServer serves "
                "models built by tiny_recurrent_lm")
        self.w_head = take("head.weights").float()
        self.b_head = take("head.bias").float()
        if seq:
            raise ModelRuntimeError(
                f"{len(seq)} unconsumed parameters (first: {seq[0][0]!r});"
                " RecurrentServer serves models built by tiny_recurrent_lm"
            )
        self.hidden = self.layers[0].wh.shape[0]

    # -- state ----------------------------------------------------------
    def init_state(self, batch: int):
        """Per-layer carried state: (h, c) for lstm, h otherwise."""
        state = []
        for lay in self.layers:
            h = torch.zeros((batch, lay.wh.shape[0]), dtype=torch.float32,
                            device=self.device)
            state.append((h, torch.zeros_like(h)) if lay.cell == "lstm"
                         else h)
        return state

    def _cell_step(self, lay: _RLayer, state, x):
        """One time step of one layer; the arithmetic of
        ``ops.recurrent.cell_forward`` (float32, same gate order)."""
        a_x = x @ lay.wx + lay.b
        if lay.cell == "lstm":
            h, c = state
            i, f, g, o = (a_x + h @ lay.wh).chunk(4, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            return (h2, c2), h2
        if lay.cell == "gru":
            h = state
            az, ar, an = a_x.chunk(3, dim=-1)
            hz, hr, hn = (h @ lay.wh).chunk(3, dim=-1)
            z = torch.sigmoid(az + hz)
            r = torch.sigmoid(ar + hr)
            h2 = (1.0 - z) * torch.tanh(an + r * hn) + z * h
            return h2, h2
        h2 = torch.tanh(a_x + state @ lay.wh)
        return h2, h2

    def _step(self, state, tokens):
        """Advance all layers one token; returns (state, logits [b, V])."""
        x = self.embed[tokens.long()].float()
        new_state = []
        for lay, st in zip(self.layers, state):
            st2, x = self._cell_step(lay, st, x)
            new_state.append(st2)
        return new_state, x @ self.w_head + self.b_head

    # -- serving ----------------------------------------------------------
    def generate(self, prompt, n_new: int, temperature: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
        """Greedy (or temperature-sampled) continuation.  ``prompt``
        [batch, t] token ids; returns [batch, n_new] int32 on the
        model's device."""
        prompt = torch.as_tensor(np.asarray(prompt, np.int32),
                                 device=self.device)
        if prompt.dim() != 2 or prompt.shape[1] < 1:
            raise ModelRuntimeError(
                f"prompt must be [batch, t>=1], got {tuple(prompt.shape)}")
        if n_new < 1:
            raise ModelRuntimeError(f"n_new must be >= 1 (got {n_new})")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        state = self.init_state(prompt.shape[0])
        for t in range(prompt.shape[1]):
            state, last = self._step(state, prompt[:, t])
        out = []
        for _ in range(n_new):
            if temperature > 0.0:
                probs = torch.softmax(last / float(temperature), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            out.append(nxt)
            state, last = self._step(state, nxt)
        return torch.stack(out, dim=1).to(torch.int32)
