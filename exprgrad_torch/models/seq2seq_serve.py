"""KV-cache serving for trained encoder-decoder (seq2seq) models on the
port.

Counterpart of ``exprgrad_tpu/models/seq2seq_serve.py``.
``greedy_decode`` (models/seq2seq.py) re-runs the whole teacher-forced
forward for every generated token; :class:`Seq2SeqServer` is the
encoder-decoder analog of :class:`~exprgrad_torch.models.FlashLMServer`,
whose cost per token does not grow with the generated length:

* **encode once**: the bidirectional encoder runs once per request, and
  the cross-attention K/V of its output are computed once per decoder
  block (every decode step reuses them);
* **decoder self-attention** streams through a static-capacity KV cache
  (``ops/decode.py``), as decoder-only serving does.

Parameters are taken from the compiled port model BY NAME: every
parameter of :func:`tiny_seq2seq` has a unique per-block prefixed name
("enc0.att.wq", "dec1.cross.wk", ...), because the DSL graph registers
encoder and decoder parameters interleaved.  Any encoder and decoder
depth is served.  The tensors are the model's, on its device.

The JAX package jits each generation loop as one ``lax.scan`` program;
here the loops run eagerly in Python, and every sampled draw comes from
one ``torch.Generator`` seeded with ``seed``.  Its attention cores over
the whole source (the encoder's, and the decoder's cross-attention) are
plain softmax in the JAX package, not a Pallas kernel, and stay plain
torch here; the decoder's self-attention is ``ops.decode``'s.

Caches: functional, as the JAX package's and ``FlashLMServer``'s: K/V
are written in place while calls run on linearly, and a call on an older
cache copies the storage first (``ops.decode.append``'s copy on write).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..errors import ModelRuntimeError
from ..ops.decode import (append, append_at, decode_attention, init_cache,
                          rewind)
from ..quant import check_weight_dtype
from ._beam import beam_search_loop, replicate_caches
from ._quant import QuantW, dequantize, quantize_weight
from ._sample import check_top_p, make_picker
from ._spec import check_spec_args, speculative_loop

_NEG_INF = -1e30


class _Enc(NamedTuple):
    """Per-request encoder state: the memory, the cross K/V of every
    decoder block, and the source validity mask of a ragged batch (or
    None)."""

    memory: torch.Tensor        # [b, s, dim]
    ck: tuple                   # per decoder block: [b, h, s, hd]
    cv: tuple                   # per decoder block: [b, h, s, hd]
    kv_mask: Optional[torch.Tensor] = None  # [b, s] bool, True = real


class Seq2SeqServer:
    """Incremental decoder over a trained :func:`tiny_seq2seq` port
    model's weights (any encoder/decoder depth, blocks found by name
    prefix).  ``cache_dtype`` (float32, bfloat16 or int8) defaults to
    float32, as in the JAX package.

    ``weight_dtype=torch.int8`` keeps every attention, FFN and head
    matrix as int8 codes with per-output-channel float32 scales and
    dequantizes each where it is used (embeddings, positions, biases and
    norm gains stay full precision).  A model already quantized by
    ``Model.quantize_weights`` is refused.

    ``mesh`` serves tensor-parallel over ``"model"`` and splits
    ``generate``/``generate_beam``/``score`` batches over ``"data"``, by
    ``FlashLMServer``'s rules (see ``_shard_weights``)."""

    _TOP = ["src.embed", "src.pos", "tgt.embed", "tgt.pos",
            "head.rms.g", "head.weights", "head.bias"]
    _ENC_KEYS = ["att.rms.g", "att.wq", "att.wk", "att.wv", "att.wo",
                 "ffn.rms.g", "ffn1.weights", "ffn1.bias",
                 "ffn2.weights", "ffn2.bias"]
    _DEC_KEYS = ["self.rms.g", "self.wq", "self.wk", "self.wv", "self.wo",
                 "cross.rms.g", "cross.wq", "cross.wk", "cross.wv",
                 "cross.wo",
                 "ffn.rms.g", "ffn1.weights", "ffn1.bias",
                 "ffn2.weights", "ffn2.bias"]

    def __init__(self, model, cache_dtype=None, eps: float = 1e-5,
                 weight_dtype=None, mesh=None):
        self.mesh = mesh
        self._tp = None
        self._split = {}
        self.eps = eps
        self.cache_dtype = cache_dtype or torch.float32
        self.weight_dtype = weight_dtype
        self.device = model.device
        if any(isinstance(v, QuantW) for v in model.params.values()):
            raise ModelRuntimeError(
                "model weights were already quantized by "
                "Model.quantize_weights (executor-level serving); build "
                "the server from the full-precision model and pass "
                "weight_dtype=torch.int8 instead"
            )
        by_name: dict = {}
        for tid in model.program.params:
            name = model.program.tensors[tid].name
            if name in by_name:
                raise ModelRuntimeError(
                    f"duplicate parameter name {name!r}; Seq2SeqServer "
                    "serves tiny_seq2seq models (unique prefixed names)"
                )
            by_name[name] = model.params[tid]

        def block_list(prefix_fmt: str, keys) -> list:
            blocks = []
            b = 0
            while f"{prefix_fmt.format(b)}{keys[0]}" in by_name:
                pre = prefix_fmt.format(b)
                missing = [k for k in keys if pre + k not in by_name]
                if missing:
                    raise ModelRuntimeError(
                        f"block {pre!r} is missing {missing[:3]}; "
                        "Seq2SeqServer serves models built by tiny_seq2seq"
                    )
                blocks.append({k: by_name.pop(pre + k) for k in keys})
                b += 1
            return blocks

        missing_top = [n for n in self._TOP if n not in by_name]
        if missing_top:
            raise ModelRuntimeError(
                f"missing parameters {missing_top[:4]}...; Seq2SeqServer "
                "serves models built by tiny_seq2seq (name-prefixed "
                "parameters)"
            )
        self.enc = block_list("enc{}.", self._ENC_KEYS)
        self.dec = block_list("dec{}.", self._DEC_KEYS)
        self.p = {n: by_name.pop(n) for n in self._TOP}
        if not self.enc or not self.dec:
            raise ModelRuntimeError(
                "Seq2SeqServer needs at least one encoder and one "
                "decoder block (enc0./dec0. prefixed parameters)"
            )
        if by_name:
            raise ModelRuntimeError(
                f"{len(by_name)} unconsumed parameters "
                f"({sorted(by_name)[:3]}...); not a tiny_seq2seq"
            )

        self.vocab, self.dim = self.p["src.embed"].shape
        self.max_src = self.p["src.pos"].shape[0]
        self.max_tgt = self.p["tgt.pos"].shape[0]
        self.heads, _, self.head_dim = self.dec[0]["self.wq"].shape
        for blk in self.dec:
            if blk["cross.wk"].shape[0] != self.heads:
                raise ModelRuntimeError(
                    "grouped-query cross-attention is not supported by "
                    "this server (kv_heads must equal heads)"
                )
        self.scale = 1.0 / math.sqrt(self.head_dim)

        if weight_dtype is not None:
            check_weight_dtype(weight_dtype)
            q = quantize_weight
            # contraction axes of the einsums below
            axes = {"wq": 1, "wk": 1, "wv": 1, "wo": (0, 1)}
            for blk in self.enc + self.dec:
                for key in list(blk):
                    tail = key.rsplit(".", 1)[-1]
                    if tail in axes:
                        blk[key] = q(blk[key], axes[tail])
                    elif key in ("ffn1.weights", "ffn2.weights"):
                        blk[key] = q(blk[key], 0)
            self.p["head.weights"] = q(self.p["head.weights"], 0)
        if mesh is not None:
            self._shard_weights()

    # -- multi-device serving (tensor-parallel weights, dp batches) ------
    def _shard_weights(self) -> None:
        """Megatron-style tensor parallelism over ``"model"``, as
        ``FlashLMServer``'s: every attention (encoder, decoder self and
        cross) splits by head, the FFN by hidden column then row, the
        head by vocab column; embeddings, positions, norms and the
        second FFN bias stay whole.  ``placed_enc``/``placed_dec``/
        ``placed_p`` hold the DTensors; the forward runs on this rank's
        chunks."""
        from ._mesh import TensorParallel, is_split, local

        tp = self._tp = TensorParallel(self.mesh)
        spec = {"wq": ("model", None, None), "wk": ("model", None, None),
                "wv": ("model", None, None), "wo": ("model", None, None),
                "ffn1.weights": (None, "model"), "ffn1.bias": ("model",),
                "ffn2.weights": ("model", None)}

        spec.update({"head.weights": (None, "model"),
                     "head.bias": ("model",)})

        def put(key, w):
            tail = key.split(".", 1)[1] if key.startswith(
                ("att.", "self.", "cross.")) else key
            ndim = (w.codes if isinstance(w, QuantW) else w).dim()
            return tp.place(w, *spec.get(tail, (None,) * ndim))

        self.placed_enc = [{k: put(k, w) for k, w in b.items()}
                           for b in self.enc]
        self.placed_dec = [{k: put(k, w) for k, w in b.items()}
                           for b in self.dec]
        self.placed_p = {k: put(k, w) for k, w in self.p.items()}
        blk = self.placed_dec[0]
        self._split = {
            "att": is_split(blk["self.wq"]) and is_split(blk["self.wo"]),
            "ffn": is_split(blk["ffn1.weights"])
            and is_split(blk["ffn2.weights"]),
            "head": is_split(self.placed_p["head.weights"])}
        if not self._split["att"] or not self._split["ffn"]:
            raise ModelRuntimeError(
                "Seq2SeqServer(mesh=) needs heads and the FFN width to "
                f"divide the model axis ({tp.mp})")
        self.enc = [{k: local(w) for k, w in b.items()}
                    for b in self.placed_enc]
        self.dec = [{k: local(w) for k, w in b.items()}
                    for b in self.placed_dec]
        self.p = {k: local(w) for k, w in self.placed_p.items()}
        wq = self.dec[0]["self.wq"]
        self.heads = (wq.codes if isinstance(wq, QuantW) else wq).shape[0]

    def _reduce(self, x, part: str):
        return self._tp.reduce(x, True) if self._split.get(part) else x

    def _dq(self, w):
        """A weight as the forward uses it: int8 codes dequantized to the
        model's dtype, full-precision weights as they are."""
        if isinstance(w, QuantW):
            return dequantize(w, self.p["src.embed"].dtype)
        return w

    def _tokens(self, x) -> torch.Tensor:
        """Token ids on the server's device, as int64."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device).long()
        return torch.as_tensor(np.asarray(x), device=self.device).long()

    # -- forward pieces (must mirror models/seq2seq.py exactly) ----------
    def _rms(self, x, gamma):
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x / torch.sqrt(ms + self.eps) * gamma

    def _full_attention(self, q, k, v, causal: bool, kv_mask=None):
        """Plain softmax attention [b,h,t,d] x [b,h,s,d]: the encoder's
        bidirectional core and the decoder's cross core (float32, or
        float64 for a float64 model; max-subtracted softmax).
        ``kv_mask`` [b, s] masks padded key positions (ragged
        sources)."""
        ct = torch.float64 if q.dtype == torch.float64 else torch.float32
        s = torch.einsum("nhtd,nhsd->nhts", q.to(ct), k.to(ct)) * self.scale
        if causal:
            t_, s_ = s.shape[-2], s.shape[-1]
            keep = (torch.arange(t_, device=s.device)[:, None]
                    >= torch.arange(s_, device=s.device)[None, :])
            s = s.masked_fill(~keep, _NEG_INF)
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask[:, None, None, :], _NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("nhts,nhsd->nhtd", p, v.to(ct)).to(q.dtype)

    def _ffn(self, x, blk):
        rn = self._rms(x, blk["ffn.rms.g"])
        h = torch.relu(rn @ self._dq(blk["ffn1.weights"]) + blk["ffn1.bias"])
        return x + self._reduce(h @ self._dq(blk["ffn2.weights"]), "ffn") \
            + blk["ffn2.bias"]

    def _proj(self, x, w):
        return torch.einsum("ntc,hcd->nhtd", x, self._dq(w))

    def _out(self, att, w):
        return self._reduce(torch.einsum("nhtd,hde->nte", att, self._dq(w)),
                            "att")

    def encode(self, src, lengths=None) -> _Enc:
        """Run the encoder once and compute the cross-attention K/V.
        Returns an ``_Enc`` usable for any number of decode steps.

        ``lengths`` ([batch] ints) serves a RAGGED batch of sources
        right-padded to a common width: padded key positions are masked
        out of the encoder's attention and of every later
        cross-attention read, so results match encoding each source
        alone at its true length."""
        p = self.p
        ids = self._tokens(src)
        s_len = ids.shape[1]
        kv_mask = None
        if lengths is not None:
            lens = torch.as_tensor(np.asarray(lengths), device=self.device)
            kv_mask = (torch.arange(s_len, device=self.device)[None, :]
                       < lens[:, None])
        e = p["src.embed"][ids] + p["src.pos"][:s_len][None]
        for blk in self.enc:
            rn = self._rms(e, blk["att.rms.g"])
            att = self._full_attention(
                self._proj(rn, blk["att.wq"]), self._proj(rn, blk["att.wk"]),
                self._proj(rn, blk["att.wv"]), causal=False, kv_mask=kv_mask)
            e = e + self._out(att, blk["att.wo"])
            e = self._ffn(e, blk)
        # cross K/V once per request per decoder block (the context is the
        # raw encoder output, as multi_head_cross_attention(x_norm, enc))
        ck = tuple(self._proj(e, blk["cross.wk"]) for blk in self.dec)
        cv = tuple(self._proj(e, blk["cross.wv"]) for blk in self.dec)
        return _Enc(e, ck, cv, kv_mask)

    def init_caches(self, batch: int, capacity: Optional[int] = None):
        """One self-attention KV cache per decoder block, on the server's
        device."""
        capacity = capacity or self.max_tgt
        return [init_cache(batch, self.heads, capacity, self.head_dim,
                           dtype=self.cache_dtype, device=self.device)
                for _ in self.dec]

    def _step(self, tokens, enc: _Enc, caches, q_pos=None, key_pos=None,
              row_starts=None):
        """Forward ``t`` fresh target tokens ([b, t] ids); returns
        (logits [b, t, V], caches).  ``q_pos``/``key_pos``/``row_starts``
        turn on per-row cursors (positions, validity masking, per-row
        K/V writes) for the continuous batcher, as on
        ``FlashLMServer._step``.  Positions past the table are clamped
        to its last row, as JAX's gather clamps (a parked batcher slot
        may sit there; its row is never read)."""
        p = self.p
        ids = self._tokens(tokens)
        t = ids.shape[1]
        if q_pos is None:
            pos = caches[0].length + torch.arange(t, device=self.device)
            x = p["tgt.embed"][ids] + p["tgt.pos"][pos][None]
        else:
            at = q_pos.long().clamp(0, self.max_tgt - 1)
            x = p["tgt.embed"][ids] + p["tgt.pos"][at]

        new_caches = []
        for blk, cache, ck, cv in zip(self.dec, caches, enc.ck, enc.cv):
            # causal self-attention through the KV cache
            rn = self._rms(x, blk["self.rms.g"])
            q = self._proj(rn, blk["self.wq"])
            k = self._proj(rn, blk["self.wk"])
            v = self._proj(rn, blk["self.wv"])
            if row_starts is None:
                cache = append(cache, k, v)
            else:
                cache = append_at(cache, k, v, row_starts)
            att = decode_attention(q, cache, sm_scale=self.scale,
                                   key_pos=key_pos, q_pos=q_pos)
            x = x + self._out(att, blk["self.wo"])

            # cross-attention against the precomputed encoder K/V
            rn = self._rms(x, blk["cross.rms.g"])
            ca = self._full_attention(self._proj(rn, blk["cross.wq"]), ck,
                                      cv, causal=False, kv_mask=enc.kv_mask)
            x = x + self._out(ca, blk["cross.wo"])
            x = self._ffn(x, blk)
            new_caches.append(cache)
        logits = (self._rms(x, p["head.rms.g"]) @ self._dq(p["head.weights"])
                  + p["head.bias"])
        if self._split.get("head"):
            logits = self._tp.gather_last(logits, True)
        return logits, new_caches

    def prefill(self, tokens, enc: _Enc, caches):
        """Run a whole target prefix, filling the self-attention caches;
        returns (logits, caches).  The caches are functional, as
        ``FlashLMServer.prefill``'s: every cache given or returned earlier
        keeps its values (``ops.decode.append``'s copy on write)."""
        return self._step(tokens, enc, caches)

    def _check_src(self, s_len: int, n_pos: int, what: str) -> None:
        if n_pos > self.max_tgt:
            raise ModelRuntimeError(
                f"{what} = {n_pos} exceeds max_tgt {self.max_tgt} "
                "positional embeddings"
            )
        if s_len > self.max_src:
            raise ModelRuntimeError(
                f"source length {s_len} exceeds max_src {self.max_src}"
            )

    def _check_lengths(self, lengths, batch: int, s_len: int) -> None:
        if lengths is None:
            return
        lens_np = np.asarray(lengths, np.int64)
        if lens_np.shape != (batch,):
            raise ModelRuntimeError(
                f"lengths must have shape ({batch},), got {lens_np.shape}"
            )
        if lens_np.min() < 1 or lens_np.max() > s_len:
            raise ModelRuntimeError(
                f"lengths must lie in [1, source width {s_len}]"
            )

    def _bos(self, batch: int, bos: int) -> torch.Tensor:
        return torch.full((batch, 1), int(bos), dtype=torch.long,
                          device=self.device)

    def generate(self, src, n_new: int, bos: int = 0,
                 temperature: float = 0.0, seed: int = 0,
                 stop_token: Optional[int] = None, lengths=None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
        """Encode ``src`` [batch, s] once, then generate ``n_new`` target
        tokens with O(1)-per-token decoding.  ``temperature > 0`` samples,
        restricted to the ``top_k`` most likely tokens and/or the
        smallest ``top_p`` nucleus when given (``FlashLMServer``'s
        filters); 0 is greedy.  ``stop_token`` freezes a sequence once it
        emits that token (the loop still runs ``n_new`` steps; finished
        rows carry the stop token forward).  ``lengths`` ([batch] ints)
        serves a ragged batch of right-padded sources: padded positions
        are masked out of encoder and cross attention, so greedy output
        matches serving each source alone.  Returns [batch, n_new] int32
        ids on the model's device."""
        src = self._tokens(src)
        batch, s_len = src.shape
        rows = self._tp and self._tp.rows(batch)
        if rows is not None:
            return self._tp.on_rows(lambda: self.generate(
                src[rows], n_new, bos, temperature, seed, stop_token,
                None if lengths is None else np.asarray(lengths)[rows],
                top_k, top_p))
        self._check_src(s_len, n_new + 1, "n_new + 1")
        self._check_lengths(lengths, batch, s_len)
        check_top_p(top_p)
        pick = make_picker(self.vocab, temperature, top_k, top_p)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))

        enc = self.encode(src, lengths=lengths)
        caches = self.init_caches(batch, capacity=n_new + 1)
        tok = self._bos(batch, bos)
        done = torch.zeros(batch, dtype=torch.bool, device=self.device)
        out = []
        for _ in range(n_new):
            logits, caches = self._step(tok, enc, caches)
            nxt = pick(logits[:, -1], gen)
            if temperature > 0.0 and self._tp is not None:
                nxt = self._tp.agree(nxt)
            if stop_token is not None:
                nxt = torch.where(done, int(stop_token), nxt)
                done = done | (nxt == stop_token)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out, dim=1).to(torch.int32)

    def generate_beam(self, src, n_new: int, beams: int = 4, bos: int = 0,
                      stop_token: Optional[int] = None, lengths=None):
        """Beam-search decoding from an encoded source.

        Returns ``(tokens [batch, beams, n_new] int32, scores [batch,
        beams])`` best first; scores are cumulative token
        log-probabilities.  ``FlashLMServer.generate_beam``'s machinery
        (``models/_beam.py``): each step expands every live beam over the
        vocabulary, keeps the top ``beams`` of ``beams * vocab``
        candidates and gathers the decoder caches' parent rows; the
        encoder memory and cross K/V are replicated per beam once and
        never change.  ``lengths`` masks ragged right-padded sources."""
        src = self._tokens(src)
        batch, s_len = src.shape
        rows = self._tp and self._tp.rows(batch)
        if rows is not None:
            return self._tp.on_rows(lambda: self.generate_beam(
                src[rows], n_new, beams, bos, stop_token,
                None if lengths is None else np.asarray(lengths)[rows]))
        V = self.vocab
        if not 1 <= beams <= V:
            raise ModelRuntimeError(
                f"beams must be in [1, vocab={V}] (got {beams})"
            )
        if n_new < 1:
            raise ModelRuntimeError(f"n_new must be >= 1 (got {n_new})")
        self._check_lengths(lengths, batch, s_len)
        self._check_src(s_len, n_new + 1, "n_new + 1")
        enc = self.encode(src, lengths=lengths)
        caches = self.init_caches(batch, capacity=n_new + 1)
        logits, caches = self._step(self._bos(batch, bos), enc, caches)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        def rep(x):
            return None if x is None else x.repeat_interleave(beams, dim=0)

        enc_rep = _Enc(rep(enc.memory), tuple(map(rep, enc.ck)),
                       tuple(map(rep, enc.cv)), rep(enc.kv_mask))
        caches = replicate_caches(caches, beams)

        def step(tokens, caches):
            return self._step(tokens, enc_rep, caches)

        return beam_search_loop(step, caches, logp0, n_new, beams, V,
                                stop_token)

    def generate_speculative(self, draft: "Seq2SeqServer", src,
                             n_new: int, k: int = 4, bos: int = 0,
                             temperature: float = 0.0, seed: int = 0,
                             lengths=None):
        """Speculative decoding for encoder-decoder models: both servers
        encode the source once (each with its own encoder), then the
        draft proposes ``k`` target tokens a round and this model
        verifies them in one ``k``-wide cached step
        (``models/_spec.py``: greedy = this model's greedy output for any
        draft; temperature sampling = the exact rejection scheme, every
        draw from one ``torch.Generator`` seeded with ``seed``).  Returns
        ``(tokens [1, n_new] int32, target_steps)``."""
        src = self._tokens(src)
        batch, s_len = src.shape
        check_spec_args(batch, self.vocab, draft.vocab, k, n_new,
                        ModelRuntimeError)
        self._check_lengths(lengths, batch, s_len)
        need = n_new + k
        if need + 1 > self.max_tgt or need + 1 > draft.max_tgt:
            raise ModelRuntimeError(
                f"n_new + k + 1 = {need + 1} exceeds max_tgt "
                f"(target {self.max_tgt}, draft {draft.max_tgt})"
            )
        if s_len > self.max_src or s_len > draft.max_src:
            raise ModelRuntimeError(
                f"source length {s_len} exceeds max_src "
                f"(target {self.max_src}, draft {draft.max_src})"
            )
        sampled = temperature > 0.0
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        enc_t = self.encode(src, lengths=lengths)
        enc_d = draft.encode(src, lengths=lengths)
        tc = self.init_caches(1, capacity=need + 1)
        dc = draft.init_caches(1, capacity=need + 1)
        tok = self._bos(1, bos)
        logits_t, tc = self._step(tok, enc_t, tc)
        _, dc = draft._step(tok, enc_d, dc)
        row = logits_t[:, -1].float()
        if sampled:
            first = torch.multinomial(
                torch.softmax(row / float(temperature), dim=-1), 1,
                generator=gen)[:, 0]
        else:
            first = torch.argmax(row, dim=-1)
        return speculative_loop(
            draft_step=lambda toks, st: draft._step(toks, enc_d, st),
            target_step=lambda toks, st: self._step(toks, enc_t, st),
            rewind=lambda st, ln: [rewind(c, ln) for c in st],
            length_of=lambda st: st[0].length,
            dstate=dc, tstate=tc, first=first, n_new=n_new, k=k,
            temperature=temperature, generator=gen)

    def score(self, src, tgt):
        """Teacher-forced negative log-likelihood per sequence.

        ``tgt`` [batch, t] are the reference target tokens; the model
        scores token ``tgt[:, i]`` given BOS + ``tgt[:, :i]`` (BOS = 0, as
        :meth:`generate`).  Returns ([batch] total NLL, [batch] mean NLL
        per token) from one prefill pass; perplexity =
        ``exp(mean_nll)``."""
        src = self._tokens(src)
        ids = self._tokens(tgt)
        batch, t = ids.shape
        rows = self._tp and self._tp.rows(batch)
        if rows is not None:
            return self._tp.on_rows(lambda: self.score(src[rows], ids[rows]))
        self._check_src(src.shape[1], t + 1, "t + 1")
        enc = self.encode(src)
        caches = self.init_caches(batch, capacity=t + 1)
        prefix = torch.cat([self._bos(batch, 0), ids[:, :-1]], dim=1)
        logits, _ = self._step(prefix, enc, caches)
        logp = torch.log_softmax(logits, dim=-1)
        tok_lp = torch.gather(logp, 2, ids[:, :, None])[..., 0]
        nll = -tok_lp.sum(dim=-1)
        return nll, nll / t
