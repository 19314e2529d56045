"""KV-cache serving for flash_transformer models on the port.

Counterpart of ``exprgrad_tpu/models/serve.py``: :class:`FlashLMServer`
pulls the parameters out of a compiled port model (tensors already on
the model's device) and drives the static-capacity KV cache
(``ops/decode.py``) with a torch forward that reproduces the DSL
program's math — prefill appends the whole prompt once, then each new
token costs one thin step.  The JAX package's ``lax.scan`` generation
loop is a Python loop here.

Ported: parameter matching, prefill, decode and ``generate`` with greedy,
temperature, top-k, top-p and ``stop_token``.  Not yet ported: ragged
``lengths``, ``stop_seq``, weight quantization, meshes, speculative,
lookup and beam decoding, and ``score``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..errors import ModelRuntimeError

from ..ops.decode import append, decode_attention, init_cache
from ._sample import check_top_p, make_picker


class _Block(NamedTuple):
    attn_g: torch.Tensor  # rms gamma before attention
    wq: torch.Tensor      # [h, dim, hd]
    wk: torch.Tensor      # [hkv, dim, hd]
    wv: torch.Tensor      # [hkv, dim, hd]
    wo: torch.Tensor      # [h, hd, dim]
    ffn_g: torch.Tensor   # rms gamma before the FFN
    w1: torch.Tensor      # [dim, hidden]  (swiglu: the gate matrix ffn.wg)
    b1: Optional[torch.Tensor]  # [hidden]  (swiglu: None)
    w2: torch.Tensor      # [hidden, dim]  (swiglu: the down matrix ffn.wd)
    b2: Optional[torch.Tensor]  # [dim]     (swiglu: None)
    w3: Optional[torch.Tensor] = None  # [dim, hidden] swiglu up matrix


class FlashLMServer:
    """Incremental decoder over a flash_transformer port model's weights.

    ``model`` is an ``exprgrad_torch.Model``; parameters are matched by
    their name sequence — embed, pos, then per block
    [rms.g, wq, wk, wv, wo, rms.g, weights, bias, weights, bias], then the
    head [rms.g, weights, bias] — and a mismatch raises instead of
    serving garbage.  ``cache_dtype`` defaults to bfloat16, as in the JAX
    package.
    """

    def __init__(self, model, cache_dtype=None, eps: float = 1e-5):
        self.eps = eps
        self.cache_dtype = cache_dtype or torch.bfloat16
        self.device = model.device
        seq = [
            (model.program.tensors[tid].name, model.params[tid])
            for tid in model.program.params
        ]

        def take(expected: str):
            if not seq or seq[0][0] != expected:
                got = seq[0][0] if seq else "<end>"
                raise ModelRuntimeError(
                    f"unexpected parameter {got!r} (wanted {expected!r}); "
                    "FlashLMServer serves models built by flash_transformer"
                )
            return seq.pop(0)[1]

        self.embed = take("embed")      # [vocab, dim]
        self.pos = take("pos") if seq and seq[0][0] == "pos" else None
        self.vocab, self.dim = self.embed.shape

        self.blocks: list[_Block] = []
        while len(seq) > 3:
            head = dict(
                attn_g=take("rms.g"),
                wq=take("wq"), wk=take("wk"), wv=take("wv"), wo=take("wo"),
                ffn_g=take("rms.g"),
            )
            if seq and seq[0][0] == "ffn.wg":  # gated SwiGLU block
                head.update(w1=take("ffn.wg"), b1=None, w3=take("ffn.wu"),
                            w2=take("ffn.wd"), b2=None)
            else:
                head.update(w1=take("weights"), b1=take("bias"),
                            w2=take("weights"), b2=take("bias"))
            self.blocks.append(_Block(**head))
        self.final_g = take("rms.g")
        if seq and seq[0][0] == "weights":
            self.w_head = take("weights")
        else:
            # tie_embeddings=True: the LM head is the embedding table
            self.w_head = self.embed.t()
        self.b_head = take("bias")
        if seq:
            raise ModelRuntimeError(
                f"{len(seq)} unconsumed parameters; not a flash_transformer"
            )
        if not self.blocks:
            raise ModelRuntimeError(
                "model has no transformer blocks (flash_transformer with "
                "blocks >= 1 is required for KV-cache serving)"
            )
        attrs = [
            kern.extern.attrs
            for target in model.program.targets.values()
            for kern in target.kernels
            if kern.extern is not None and kern.extern.name == "attention"
        ]
        # one decode mask and one rotation must serve every block
        windows = {int(a.get("window", 0)) for a in attrs}
        if len(windows) > 1:
            raise ModelRuntimeError(
                "blocks disagree on attention window "
                f"({sorted(windows)}, 0 = full causal); KV-cache serving "
                "needs one uniform window"
            )
        w = windows.pop() if windows else 0
        self.window = w if w > 0 else None
        ropes = {(float(a.get("rope", 0.0)), int(a.get("rope_max_seq", 0)))
                 for a in attrs}
        if len(ropes) > 1:
            raise ModelRuntimeError(
                f"blocks disagree on rope config ({sorted(ropes)}); "
                "KV-cache serving needs one uniform rotation"
            )
        rb, rope_max_seq = ropes.pop() if ropes else (0.0, 0)
        self.rope_base = rb if rb > 0 else None
        if self.pos is not None:
            self.max_seq = self.pos.shape[0]
        elif self.rope_base is not None:
            self.max_seq = rope_max_seq
        else:
            raise ModelRuntimeError(
                "model has neither a position table nor rope metadata; "
                "cannot bound the serving context"
            )
        blk = self.blocks[0]
        self.heads, _, self.head_dim = blk.wq.shape
        self.kv_heads = blk.wk.shape[0]
        self.scale = 1.0 / math.sqrt(self.head_dim)

    # -- forward pieces (must mirror models/transformer.py exactly) -----
    def _rms(self, x, gamma):
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x / torch.sqrt(ms + self.eps) * gamma

    def _step(self, x, caches, pos_offset: int):
        """One forward pass of ``t`` fresh (embedded) tokens with their K/V
        appended to the caches.  Returns (logits, caches)."""
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            rn = self._rms(x, blk.attn_g)
            q = torch.einsum("ntc,hcd->nhtd", rn, blk.wq)
            k = torch.einsum("ntc,hcd->nhtd", rn, blk.wk)
            v = torch.einsum("ntc,hcd->nhtd", rn, blk.wv)
            if self.rope_base is not None:
                rot_pos = pos_offset + torch.arange(x.shape[1],
                                                    device=x.device)
                q = self._rope_rotate(q, rot_pos)
                k = self._rope_rotate(k, rot_pos)
            cache = append(cache, k, v)
            att = decode_attention(q, cache, sm_scale=self.scale,
                                   window=self.window)
            x = x + torch.einsum("nhtd,hde->nte", att, blk.wo)
            rn2 = self._rms(x, blk.ffn_g)
            if blk.w3 is not None:  # swiglu: silu(gate) * up, no biases
                g = rn2 @ blk.w1
                h = g / (1.0 + torch.exp(-g)) * (rn2 @ blk.w3)
                x = x + h @ blk.w2
            else:
                h = torch.relu(rn2 @ blk.w1 + blk.b1)
                x = x + h @ blk.w2 + blk.b2
            new_caches.append(cache)
        logits = self._rms(x, self.final_g) @ self.w_head + self.b_head
        return logits, new_caches

    def _embed_tokens(self, tokens, pos_offset: int):
        ids = tokens.long()
        if self.pos is None:  # rotary: positions live in the attention
            return self.embed[ids]
        pos_ids = pos_offset + torch.arange(ids.shape[1], device=ids.device)
        return self.embed[ids] + self.pos[pos_ids][None, :, :]

    def _rope_rotate(self, x, positions):
        """Rotate ``x`` [b, h, t, hd] by absolute ``positions`` [t] —
        mirrors layers.attention.rope (rotate-half)."""
        hd = x.shape[-1]
        half = hd // 2
        inv = torch.exp(
            torch.arange(half, dtype=torch.float32, device=x.device)
            * (-2.0 * math.log(self.rope_base) / hd)
        )
        ang = positions.float()[:, None] * inv            # [t, half]
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=self.embed.dtype,
                               device=self.device)

    # -- public API ------------------------------------------------------
    def init_caches(self, batch: int, capacity: Optional[int] = None):
        capacity = capacity or self.max_seq
        return [
            init_cache(batch, self.kv_heads, capacity, self.head_dim,
                       dtype=self.cache_dtype, device=self.device)
            for _ in self.blocks
        ]

    def prefill(self, tokens, caches):
        """Run the whole prompt ([batch, t] float ids) through the model,
        filling the caches; returns (logits [batch, t, vocab], caches).

        The caches are consumed: their K/V tensors are written in place
        and the returned caches share them, unlike the JAX package's
        functional caches.  To decode two continuations from one state,
        clone the tensors first (``c._replace(k=c.k.clone(),
        v=c.v.clone())`` for each cache)."""
        tokens = self._tokens(tokens)
        start = caches[0].length
        x = self._embed_tokens(tokens, start)
        return self._step(x, caches, start)

    def decode(self, token, caches):
        """One token per sequence ([batch, 1]); O(cache) per step.  Consumes
        ``caches`` as :meth:`prefill` does."""
        return self.prefill(token, caches)

    def generate(
        self,
        prompt,
        n_new: int,
        capacity: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        stop_token: Optional[int] = None,
    ) -> torch.Tensor:
        """Continue ``prompt`` ([batch, t] float ids) by ``n_new`` tokens;
        returns [batch, n_new] ids in the prompt's float dtype, on the
        model's device.

        ``temperature <= 0`` decodes greedily; otherwise tokens sample from
        ``softmax(logits / temperature)`` restricted to the ``top_k`` most
        likely tokens and/or the nucleus reaching ``top_p`` mass, drawing
        from a ``torch.Generator`` seeded with ``seed``.  ``stop_token``
        freezes a sequence once it emits that token: its later outputs are
        the stop token itself."""
        prompt = self._tokens(prompt)
        batch, t = prompt.shape
        capacity = capacity or self.max_seq
        if n_new < 1:
            raise ModelRuntimeError(f"n_new must be >= 1 (got {n_new})")
        # the last decode feeds token index t+n_new-2: positions
        # 0..t+n_new-2 are embedded and t+n_new-1 K/V rows are cached
        need = t + n_new - 1
        if need > self.max_seq:
            raise ModelRuntimeError(
                f"prompt_len + n_new - 1 = {need} exceeds the model's "
                f"max_seq {self.max_seq} position embeddings"
            )
        if need > capacity:
            raise ModelRuntimeError(
                f"prompt_width + n_new - 1 = {need} exceeds KV-cache "
                f"capacity {capacity}; pass capacity>={need}"
            )
        check_top_p(top_p)
        pick = make_picker(self.vocab, temperature, top_k, top_p)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))

        caches = self.init_caches(batch, capacity)
        logits, caches = self.prefill(prompt, caches)
        done = torch.zeros(batch, dtype=torch.bool, device=self.device)
        tok = None
        out = []
        for i in range(n_new):
            if i:
                logits, caches = self.decode(tok[:, None], caches)
            tok = pick(logits[:, -1], gen).to(prompt.dtype)
            if stop_token is not None:
                tok = torch.where(done, float(stop_token), tok)
                done = done | (tok == stop_token)
            out.append(tok)
        return torch.stack(out, dim=1)
