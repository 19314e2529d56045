"""KV-cache serving for flash_transformer models on the port.

Counterpart of ``exprgrad_tpu/models/serve.py``: :class:`FlashLMServer`
pulls the parameters out of a compiled port model (tensors already on
the model's device) and drives the static-capacity KV cache
(``ops/decode.py``) with a torch forward that reproduces the DSL
program's math — prefill appends the whole prompt once, then each new
token costs one thin step.  The JAX package's ``lax.scan`` and
``lax.while_loop`` generation loops are Python loops here.

Ported: parameter matching, prefill, decode and ``generate`` with greedy,
temperature, top-k, top-p, ``stop_token`` and ``stop_seq``, ragged
``lengths`` and prompt buckets; float32, bfloat16 and int8 caches;
int8 weights (``weight_dtype``, dequantized where each matrix is used);
``score``, ``generate_beam`` (``models/_beam.py``),
``generate_speculative`` and ``generate_lookup`` (``models/_spec.py``);
and the pieces the continuous batcher (``models/batcher.py``) drives:
``_step`` with per-row positions, cursors and a cache-IO hook,
``_embed_at`` and ``_ragged_positions``.  Not yet ported: ``mesh``
(ROADMAP A14), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..errors import ModelRuntimeError
from ..ops.decode import append, append_at, decode_attention, init_cache
from ..quant import check_weight_dtype
from ..utils.buckets import bucket_for, normalize_buckets
from ._beam import beam_search_loop, replicate_caches
from ._quant import QuantW, dequantize, quantize_weight
from ._sample import check_top_p, make_picker
from ._spec import check_spec_args, lookup_propose, speculative_loop


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
    serving garbage.  ``cache_dtype`` (float32, bfloat16 or int8)
    defaults to bfloat16, as in the JAX package.

    ``weight_dtype=torch.int8`` serves int8 weights (W8A16): every
    attention, FFN and head matrix is kept as int8 codes and float32
    per-output-channel scales on the server's device and dequantized
    where it is used, so the server holds no full-precision copy of them
    (embeddings, positions, biases and norm gains stay full precision).
    A model already quantized by ``Model.quantize_weights`` is refused:
    serve the full-precision model with ``weight_dtype`` instead.
    """

    def __init__(self, model, cache_dtype=None, eps: float = 1e-5,
                 weight_dtype=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "FlashLMServer(mesh=) is not ported to exprgrad_torch yet "
                "(ROADMAP A14); the JAX package's server has it")
        self.eps = eps
        self.cache_dtype = cache_dtype or torch.bfloat16
        self.weight_dtype = weight_dtype
        self.device = model.device
        if any(isinstance(v, QuantW) for v in model.params.values()):
            raise ModelRuntimeError(
                "model weights were already quantized by "
                "Model.quantize_weights (executor-level serving); build "
                "the server from the full-precision model and pass "
                "weight_dtype=torch.int8 instead"
            )
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
        self.prompt_buckets = None  # see set_prompt_buckets
        blk = self.blocks[0]
        self.heads, _, self.head_dim = blk.wq.shape
        self.kv_heads = blk.wk.shape[0]
        self.scale = 1.0 / math.sqrt(self.head_dim)

        if weight_dtype is not None:
            check_weight_dtype(weight_dtype)
            q = quantize_weight
            # contraction axes per matrix (the einsums of _step)
            self.blocks = [
                blk._replace(
                    wq=q(blk.wq, 1), wk=q(blk.wk, 1), wv=q(blk.wv, 1),
                    wo=q(blk.wo, (0, 1)),
                    w1=q(blk.w1, 0), w2=q(blk.w2, 0),
                    w3=None if blk.w3 is None else q(blk.w3, 0),
                )
                for blk in self.blocks
            ]
            self.w_head = q(self.w_head, 0)

    def weight_bytes(self) -> int:
        """Bytes of the weights the server holds itself: the attention,
        FFN and head matrices (int8 codes and scales under
        ``weight_dtype``), the gains and the biases; the embedding and
        position tables are the model's."""
        def size(w):
            if w is None:
                return 0
            if isinstance(w, QuantW):
                return size(w.codes) + size(w.scale)
            return w.numel() * w.element_size()

        tied = (isinstance(self.w_head, torch.Tensor)
                and self.w_head.data_ptr() == self.embed.data_ptr())
        held = [self.final_g, self.b_head] + ([] if tied else [self.w_head])
        return sum(size(w) for w in held) + sum(
            size(w) for blk in self.blocks for w in blk)

    def _dq(self, w):
        """A weight as the forward uses it: int8 codes dequantized to the
        model's dtype, full-precision weights as they are."""
        if isinstance(w, QuantW):
            return dequantize(w, self.embed.dtype)
        return w

    # -- forward pieces (must mirror models/transformer.py exactly) -----
    def _rms(self, x, gamma):
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x / torch.sqrt(ms + self.eps) * gamma

    def _step(self, x, caches, pos_offset: int, key_pos=None, q_pos=None,
              row_starts=None, cache_io=None):
        """One forward pass of ``t`` fresh (embedded) tokens with their K/V
        appended to the caches.  Returns (logits, caches).

        ``key_pos``/``q_pos`` turn on position masking (see
        ``ops.decode.decode_attention``); ``q_pos`` [b, t] then also
        gives the rotary positions.  ``row_starts`` [b] writes the fresh
        K/V at per-row slot offsets instead of the batch-wide cursor
        (continuous batching).  ``cache_io`` takes over cache storage: an
        object with ``append(cache, k, v) -> cache`` and either
        ``view(cache) -> KVCache`` (a dense view to attend) or
        ``attend(q, cache, sm_scale, window, key_pos, q_pos)`` (attention
        over the cache in place: the paged kernel)."""
        dq = self._dq
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            rn = self._rms(x, blk.attn_g)
            q = torch.einsum("ntc,hcd->nhtd", rn, dq(blk.wq))
            k = torch.einsum("ntc,hcd->nhtd", rn, dq(blk.wk))
            v = torch.einsum("ntc,hcd->nhtd", rn, dq(blk.wv))
            if self.rope_base is not None:
                if q_pos is not None:   # true per-sequence positions
                    rot_pos = q_pos
                else:
                    rot_pos = pos_offset + torch.arange(x.shape[1],
                                                        device=x.device)
                q = self._rope_rotate(q, rot_pos)
                k = self._rope_rotate(k, rot_pos)
            att = None
            if cache_io is not None:
                cache = cache_io.append(cache, k, v)
                if hasattr(cache_io, "attend"):
                    att = cache_io.attend(q, cache, self.scale, self.window,
                                          key_pos, q_pos)
                else:
                    view = cache_io.view(cache)
            elif row_starts is None:
                cache = view = append(cache, k, v)
            else:
                cache = view = append_at(cache, k, v, row_starts)
            if att is None:
                att = decode_attention(q, view, sm_scale=self.scale,
                                       window=self.window, key_pos=key_pos,
                                       q_pos=q_pos)
            x = x + torch.einsum("nhtd,hde->nte", att, dq(blk.wo))
            rn2 = self._rms(x, blk.ffn_g)
            if blk.w3 is not None:  # swiglu: silu(gate) * up, no biases
                g = rn2 @ dq(blk.w1)
                h = g / (1.0 + torch.exp(-g)) * (rn2 @ dq(blk.w3))
                x = x + h @ dq(blk.w2)
            else:
                h = torch.relu(rn2 @ dq(blk.w1) + blk.b1)
                x = x + h @ dq(blk.w2) + blk.b2
            new_caches.append(cache)
        logits = self._rms(x, self.final_g) @ dq(self.w_head) + self.b_head
        return logits, new_caches

    def _embed_tokens(self, tokens, pos_offset: int):
        ids = tokens.long()
        if self.pos is None:  # rotary: positions live in the attention
            return self.embed[ids]
        pos_ids = pos_offset + torch.arange(ids.shape[1], device=ids.device)
        return self.embed[ids] + self.pos[pos_ids][None, :, :]

    def _embed_at(self, tokens, pos_ids):
        """Embed ``tokens`` [b, t] at explicit per-sequence positions
        ``pos_ids`` [b, t].  Positions past the table are clamped to its
        last row, as JAX's gather clamps: a parked batcher slot may sit
        there, and its row is never read."""
        ids = tokens.long()
        if self.pos is None:
            return self.embed[ids]
        at = pos_ids.long().clamp(0, self.pos.shape[0] - 1)
        return self.embed[ids] + self.pos[at]

    def _rope_rotate(self, x, positions):
        """Rotate ``x`` [b, h, t, hd] by absolute ``positions`` ([t] or
        [b, t]) — mirrors layers.attention.rope (rotate-half)."""
        hd = x.shape[-1]
        half = hd // 2
        inv = torch.exp(
            torch.arange(half, dtype=torch.float32, device=x.device)
            * (-2.0 * math.log(self.rope_base) / hd)
        )
        ang = positions.float()[..., None] * inv       # [b?, t, half]
        if ang.dim() == 2:
            ang = ang[None]
        ang = ang[:, None]                              # [b?, 1, t, half]
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _ragged_positions(self, lens, width: int, capacity: int):
        """(pos_ids [b, width], key_pos [b, capacity]) for a right-padded
        batch of lengths ``lens`` [b]: true positions with pad queries
        clamped, pad and unwritten cache slots marked -1."""
        dev = lens.device
        slot = torch.arange(capacity, device=dev)
        pos_ids = torch.minimum(torch.arange(width, device=dev)[None, :],
                                lens[:, None] - 1)
        key_pos = torch.where(
            (slot[None, :] < lens[:, None]) & (slot[None, :] < width),
            slot[None, :], -1)
        return pos_ids, key_pos

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

    def set_prompt_buckets(self, buckets) -> None:
        """Pad prompt widths up to ``buckets`` (sorted widths, or
        ``"pow2"``) in ``generate``: prompts are right-padded to the
        bucket and decode through the ragged path with their true
        lengths, so greedy results equal the unbucketed call (pad K/V
        slots are masked by position).  The JAX package buckets to bound
        its compiles; here it fixes the shapes a caller sees."""
        self.prompt_buckets = normalize_buckets(buckets, "prompt bucket")

    def _prompt_bucket(self, width: int) -> int:
        return bucket_for(self.prompt_buckets, width)

    def generate(
        self,
        prompt,
        n_new: int,
        capacity: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        lengths=None,
        stop_token: Optional[int] = None,
        stop_seq=None,
    ) -> torch.Tensor:
        """Continue ``prompt`` ([batch, t] float ids) by ``n_new`` tokens;
        returns [batch, n_new] ids in the prompt's float dtype, on the
        model's device.

        ``temperature <= 0`` decodes greedily; otherwise tokens sample from
        ``softmax(logits / temperature)`` restricted to the ``top_k`` most
        likely tokens and/or the nucleus reaching ``top_p`` mass, drawing
        from a ``torch.Generator`` seeded with ``seed``.

        ``lengths`` ([batch] ints) serves a ragged batch: prompts are
        right-padded to a common width and each row decodes from its own
        length, pad K/V masked by position, true positions throughout.
        Greedy rows equal serving each prompt alone.

        ``stop_token`` freezes a row once it emits that token: its later
        outputs are the stop token itself.  ``stop_seq`` (token ids) does
        the same for a multi-token sequence: a row freezes the step its
        last ``len(stop_seq)`` generated tokens equal the sequence, and
        carries the sequence's last token on.  Only generated tokens
        count.  The two are mutually exclusive."""
        prompt = self._tokens(prompt)
        batch = prompt.shape[0]
        capacity = capacity or self.max_seq
        if n_new < 1:
            raise ModelRuntimeError(f"n_new must be >= 1 (got {n_new})")
        if self.prompt_buckets is not None:
            width = prompt.shape[1]
            target = min(self._prompt_bucket(width),
                         max(capacity - n_new + 1, width))
            if target > width:
                if lengths is None:
                    lengths = np.full((batch,), width, np.int64)
                prompt = torch.nn.functional.pad(prompt, (0, target - width))
        # the last decode feeds token index t+n_new-2: positions
        # 0..t+n_new-2 are embedded and t+n_new-1 K/V rows are cached
        t_max = prompt.shape[1]
        if lengths is not None:
            lengths = np.asarray(lengths, np.int64)
            if lengths.shape != (batch,):
                raise ModelRuntimeError(
                    f"lengths must have shape ({batch},), got "
                    f"{lengths.shape}"
                )
            if lengths.min() < 1 or lengths.max() > t_max:
                raise ModelRuntimeError(
                    f"lengths must lie in [1, prompt width {t_max}]"
                )
            need = int(lengths.max()) + n_new - 1
            cache_need = t_max + n_new - 1
        else:
            need = cache_need = t_max + n_new - 1
        if need > self.max_seq:
            raise ModelRuntimeError(
                f"prompt_len + n_new - 1 = {need} exceeds the model's "
                f"max_seq {self.max_seq} position embeddings"
            )
        if cache_need > capacity:
            raise ModelRuntimeError(
                f"prompt_width + n_new - 1 = {cache_need} exceeds KV-cache "
                f"capacity {capacity}; pass capacity>={cache_need}"
            )
        check_top_p(top_p)
        pick = make_picker(self.vocab, temperature, top_k, top_p)
        freeze = self._stop_rule(batch, stop_token, stop_seq, prompt.dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))

        caches = self.init_caches(batch, capacity)
        if lengths is None:
            logits, caches = self.prefill(prompt, caches)
            last = logits[:, -1]
        else:
            # prefill at true positions (pad queries clamp; their outputs
            # and K/V are masked by position)
            cur = torch.as_tensor(lengths, device=self.device)
            pos_ids, key_pos = self._ragged_positions(cur, t_max, capacity)
            x = self._embed_at(prompt, pos_ids)
            logits, caches = self._step(x, caches, 0, key_pos=key_pos,
                                        q_pos=pos_ids)
            last = logits[torch.arange(batch, device=self.device), cur - 1]
        tok = None
        out = []
        for i in range(n_new):
            if i and lengths is None:
                logits, caches = self.decode(tok[:, None], caches)
                last = logits[:, -1]
            elif i:
                # the fresh K/V land at slot cache.length: mark it with
                # the token's true position before attending
                key_pos[:, caches[0].length] = cur
                x = self._embed_at(tok[:, None], cur[:, None])
                logits, caches = self._step(x, caches, 0, key_pos=key_pos,
                                            q_pos=cur[:, None])
                last = logits[:, 0]
                cur = cur + 1
            tok = freeze(pick(last, gen).to(prompt.dtype))
            out.append(tok)
        return torch.stack(out, dim=1)

    def _stop_rule(self, batch: int, stop_token, stop_seq, dtype):
        """``freeze(tok [batch]) -> tok``: carries the stop token (or the
        stop sequence's last token) forward on finished rows, keeping the
        done flags (and the rolling window of emitted tokens) itself."""
        if stop_seq is not None:
            if stop_token is not None:
                raise ModelRuntimeError(
                    "stop_token and stop_seq are mutually exclusive")
            stop_seq = [int(s) for s in stop_seq]
            if not stop_seq or any(s < 0 or s >= self.vocab
                                   for s in stop_seq):
                raise ModelRuntimeError(
                    f"stop_seq must be non-empty token ids in [0, "
                    f"{self.vocab}); got {stop_seq}"
                )
        dev = self.device
        state = {"done": torch.zeros(batch, dtype=torch.bool, device=dev)}
        if stop_seq is not None:
            want = torch.tensor(stop_seq, dtype=dtype, device=dev)
            # -1 never matches a token id
            state["recent"] = torch.full((batch, len(stop_seq)), -1.0,
                                         dtype=dtype, device=dev)

        def freeze(tok):
            done = state["done"]
            if stop_seq is not None:
                tok = torch.where(done, want[-1], tok)
                recent = torch.cat([state["recent"][:, 1:], tok[:, None]], 1)
                state["recent"] = recent
                state["done"] = done | (recent == want).all(dim=-1)
            elif stop_token is not None:
                tok = torch.where(done, float(stop_token), tok)
                state["done"] = done | (tok == stop_token)
            return tok

        return freeze

    def score(self, tokens, lengths=None) -> torch.Tensor:
        """Per-sequence mean negative log-likelihood of ``tokens``
        ([batch, t] float ids; optional per-sequence ``lengths`` for
        right-padded ragged batches): the teacher-forced NLL of tokens[1:]
        given tokens[:-1], [batch] float32 on the device; ``exp`` of it is
        the perplexity.  One prefill pass, no generation loop."""
        tokens = self._tokens(tokens)
        batch, t = tokens.shape
        if t < 2:
            raise ModelRuntimeError("score needs sequences of >= 2 tokens")
        if t > self.max_seq:
            raise ModelRuntimeError(
                f"sequence length {t} exceeds max_seq {self.max_seq}")
        if lengths is None:
            lengths = np.full((batch,), t, np.int64)
        lengths = np.asarray(lengths, np.int64)
        if lengths.shape != (batch,) or lengths.min() < 2 \
                or lengths.max() > t:
            raise ModelRuntimeError(f"lengths must be [batch] ints in [2, {t}]")
        lens = torch.as_tensor(lengths, device=self.device)
        pos_ids, key_pos = self._ragged_positions(lens, t, t)
        x = self._embed_at(tokens, pos_ids)
        logits, _ = self._step(x, self.init_caches(batch, t), 0,
                               key_pos=key_pos, q_pos=pos_ids)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = tokens.long()[:, 1:]                          # targets
        tok_lp = torch.gather(logp[:, :-1], 2, nxt[:, :, None])[..., 0]
        valid = (torch.arange(1, t, device=self.device)[None, :]
                 < lens[:, None])
        n = valid.sum(dim=1).clamp(min=1)
        return -torch.where(valid, tok_lp, 0.0).sum(dim=1) / n

    def generate_beam(
        self,
        prompt,
        n_new: int,
        beams: int = 4,
        capacity: Optional[int] = None,
        stop_token: Optional[int] = None,
    ):
        """Beam-search continuation of ``prompt`` ([batch, t] float ids).

        Returns ``(tokens [batch, beams, n_new] int32, scores [batch,
        beams])`` with beams best first; ``scores`` are cumulative token
        log-probabilities.  Each step expands every live beam over the
        vocabulary, keeps the top ``beams`` of ``beams * vocab``
        candidates (the lowest index first among ties, as the JAX
        package) and gathers the caches' parent rows (batch-major
        ``[batch*beams, ...]``).  ``stop_token`` finishes a beam: it stops
        accumulating score and pads with the stop token.  Uniform prompts
        only (``generate(lengths=...)`` serves ragged ones)."""
        prompt = self._tokens(prompt)
        batch, t = prompt.shape
        capacity = capacity or self.max_seq
        if not 1 <= beams <= self.vocab:
            raise ModelRuntimeError(
                f"beams must be in [1, vocab={self.vocab}] (got {beams})")
        if n_new < 1:
            raise ModelRuntimeError(f"n_new must be >= 1 (got {n_new})")
        need = t + n_new - 1
        if need > self.max_seq:
            raise ModelRuntimeError(
                f"prompt_len + n_new - 1 = {need} exceeds max_seq "
                f"{self.max_seq}")
        if need > capacity:
            raise ModelRuntimeError(
                f"prompt_len + n_new - 1 = {need} exceeds capacity "
                f"{capacity}")
        # prefill once at batch, then replicate rows per beam
        logits, caches = self.prefill(prompt, self.init_caches(batch,
                                                               capacity))
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)

        def step(tokens, caches):
            return self.decode(tokens.to(prompt.dtype), caches)

        return beam_search_loop(step, replicate_caches(caches, beams), logp0,
                                n_new, beams, self.vocab, stop_token)

    def _spec_caches(self, t: int, n_new: int, k: int, capacity, what: str,
                     draft_max_seq: Optional[int] = None) -> int:
        """The cache capacity of a speculative call: rows of rejected
        proposals are appended before the rewind, so the high-water mark
        overshoots by up to ``k``."""
        need = t + n_new - 1 + k
        if need > self.max_seq or need > (draft_max_seq or need):
            raise ModelRuntimeError(
                f"prompt_len + n_new - 1 + k = {need} exceeds max_seq "
                f"({what})")
        capacity = capacity or need
        if need > capacity:
            raise ModelRuntimeError(
                f"{need} cache rows needed, capacity {capacity}")
        return capacity

    def _rewind(self, caches, length: int):
        return [c._replace(length=int(length)) for c in caches]

    def generate_speculative(
        self,
        draft: "FlashLMServer",
        prompt,
        n_new: int,
        k: int = 4,
        capacity: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        break_even: Optional[float] = None,
    ):
        """Speculative decoding: a small ``draft`` server proposes ``k``
        tokens a round, this (target) model verifies them in one
        ``k``-wide cached step.

        ``temperature <= 0`` is greedy acceptance: the output equals this
        model's greedy ``generate(prompt, n_new)`` for any draft, which
        only changes the number of target steps.  ``temperature > 0`` is
        the rejection-sampling scheme (Leviathan et al.): proposal ``d``
        is accepted with probability ``min(1, p(d) / q(d))`` and the first
        rejection resamples from ``max(p - q, 0)`` normalized, so the
        output distribution is plain temperature sampling from the target
        for any draft; every draw comes from one ``torch.Generator``
        seeded with ``seed``.

        The verify step is ``k`` wide where plain decoding is one wide, so
        sums run in another order: greedy tokens whose top two logits tie
        within float rounding may resolve differently.  Each round reads
        its tokens and acceptance count back to the host once; both caches
        rewind their ``length`` to the accepted count.  Returns ``(tokens
        [1, n_new] int32, target_steps)``.  One sequence at a time; draft
        and target share the vocabulary.

        ``break_even`` (tokens per verify round) warns when the measured
        acceptance cannot pay for the draft: speculation wins only when
        ``n_new / target_steps > 1 + k * t_draft / t_plain``."""
        prompt = self._tokens(prompt)
        batch, t = prompt.shape
        check_spec_args(batch, self.vocab, draft.vocab, k, n_new,
                        ModelRuntimeError)
        capacity = self._spec_caches(
            t, n_new, k, capacity,
            f"target {self.max_seq}, draft {draft.max_seq}", draft.max_seq)
        sampled = temperature > 0.0
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        logits, tc = self.prefill(prompt, self.init_caches(1, capacity))
        _, dc = draft.prefill(prompt, draft.init_caches(1, capacity))
        row = logits[:, -1].float()
        if sampled:
            first = torch.multinomial(torch.softmax(row / temperature, -1),
                                      1, generator=gen)[:, 0]
        else:
            first = torch.argmax(row, dim=-1)
        toks, steps = speculative_loop(
            draft_step=draft.decode, target_step=self.prefill,
            rewind=self._rewind, length_of=lambda st: st[0].length,
            dstate=dc, tstate=tc, first=first, n_new=n_new, k=k,
            temperature=temperature, generator=gen)
        if break_even is not None:
            rate = float(n_new) / max(1, steps)
            if rate < float(break_even):
                warnings.warn(
                    f"speculative acceptance {rate:.2f} tokens/round is "
                    f"below the break-even {float(break_even):.2f}: this "
                    f"draft costs more than it saves here (plain "
                    f"generate() would be faster)", RuntimeWarning,
                    stacklevel=2)
        return toks, steps

    def generate_lookup(
        self,
        prompt,
        n_new: int,
        k: int = 8,
        ngram: int = 2,
        capacity: Optional[int] = None,
    ):
        """Prompt-lookup speculative decoding (no draft): each round
        proposes the ``k`` tokens that followed the most recent earlier
        occurrence of the last ``ngram`` tokens of prompt + generation
        (``models._spec.lookup_propose``, on the host, which holds the
        history), and this model verifies them in one ``k``-wide cached
        step — ``generate_speculative``'s round with the draft replaced
        by a history match.  The output is always this model's greedy
        sequence; the lookup changes only the number of target steps.
        Returns ``(tokens [1, n_new] int32, target_steps)``."""
        prompt = self._tokens(prompt)
        batch, t = prompt.shape
        check_spec_args(batch, self.vocab, self.vocab, k, n_new,
                        ModelRuntimeError)
        if ngram < 1:
            raise ModelRuntimeError(f"ngram must be >= 1 (got {ngram})")
        if t + 1 < ngram:
            raise ModelRuntimeError(
                f"ngram {ngram} exceeds prompt_len + 1 = {t + 1}")
        capacity = self._spec_caches(t, n_new, k, capacity,
                                     f"{self.max_seq}")
        logits, tc = self.prefill(prompt, self.init_caches(1, capacity))
        first = torch.argmax(logits[:, -1], dim=-1)
        known = prompt[0].long().cpu().numpy()

        def propose(out, count):
            return lookup_propose(np.concatenate([known, out[:count]]), k,
                                  ngram)

        return speculative_loop(
            draft_step=None, target_step=self.prefill, rewind=self._rewind,
            length_of=lambda st: st[0].length, dstate=None, tstate=tc,
            first=first, n_new=n_new, k=k, temperature=0.0, generator=None,
            propose_fn=propose)
