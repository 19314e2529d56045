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
``_embed_at`` and ``_ragged_positions``; and ``mesh=`` serving
(Megatron-style tensor parallelism over ``"model"``, batches over
``"data"``; see ``FlashLMServer``).

Hybrid models (``models.jamba.jamba_lm``: Mamba-1 and attention mixers,
dense and routed-expert FFNs) are read layer by layer from their
parameters' names and served by ``_step_hybrid``, chosen once at
construction; see ``FlashLMServer``.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..errors import ModelRuntimeError
from ..ops import mamba as mamba_ops
from ..ops.attention import flash_attention_forward
from ..ops.decode import (append, append_at, decode_attention, init_cache,
                          rewind)
from ..ops.matmul import HEADS_IN, HEADS_OUT, weight_product
from ..ops.moe import swiglu, swiglu_dense_masked, swiglu_routed
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


class _Attn(NamedTuple):
    wq: torch.Tensor      # [h, dim, hd]
    wk: torch.Tensor      # [hkv, dim, hd]
    wv: torch.Tensor      # [hkv, dim, hd]
    wo: torch.Tensor      # [h, hd, dim]


class _Dense(NamedTuple):
    wg: torch.Tensor      # [dim, hidden]
    wu: torch.Tensor      # [dim, hidden]
    wd: torch.Tensor      # [hidden, dim]


class _Experts(NamedTuple):
    router: torch.Tensor  # [dim, E]
    wg: torch.Tensor      # [E, dim, hidden]
    wu: torch.Tensor      # [E, dim, hidden]
    wd: torch.Tensor      # [E, hidden, dim]


class _Layer(NamedTuple):
    """One layer of a hybrid model: its mixer (``_Attn`` or
    ``ops.mamba.Mixer``) and its FFN (``_Dense`` or ``_Experts``), each
    after its RMSNorm gain."""

    mixer_g: torch.Tensor
    mixer: tuple
    ffn_g: torch.Tensor
    ffn: tuple


# what a hybrid model's steps ran (FlashLMServer.counts)
HYBRID_COUNTS = ("scan_tokens", "scan_padded_tokens", "moe_routed_rows",
                 "moe_computed_rows")


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

    ``mesh`` (``parallel.make_mesh``; every rank of it builds the server
    and makes the same calls) serves tensor-parallel over ``"model"``:
    ``wq``/``wk``/``wv``/``wo`` split by head, ``w1``/``w3`` by column and
    ``w2`` by row (an all_reduce after it and after ``wo``), the LM head
    by vocab column (an all_gather of the logits before sampling); each
    name is dropped where its dim does not divide the axis (models/
    _mesh.py).  The placed weights are DTensors (``placed_blocks``,
    ``placed_head``); ``heads``/``kv_heads`` and the caches are this
    rank's.  Prefill from an empty cache runs the flash kernel on the
    local heads.  ``generate``, ``score`` and ``generate_beam`` split
    their batch over ``"data"`` and return it whole; ``prefill``/``decode``
    take this rank's rows.  A sampled token is model-rank 0's on every
    rank.

    A hybrid model (``models.jamba.jamba_lm``: after each gain a mixer,
    wq .. wo or mamba.in_proj .. mamba.out_proj, and an FFN, ffn.wg ..
    ffn.wd or moe.router .. moe.wd) is read layer by layer (``blocks``
    holds ``_Layer`` tuples, ``mixers`` each layer's kind) and served by
    ``_step_hybrid``, bound at construction.  Its caches hold a K/V
    cache for each attention layer and an ``ops.mamba.MambaState`` for
    each Mamba layer, which prefill and decode advance in place (so they
    are not functional: a call on an older cache continues from the
    newer state).  Its context is ``jamba_lm``'s ``max_seq`` and its
    norms' eps ``jamba_lm``'s (``eps`` is not read).  Beam search,
    speculative and lookup decoding, int8 weights and ``mesh=`` are
    refused for it.
    """

    def __init__(self, model, cache_dtype=None, eps: float = 1e-5,
                 weight_dtype=None, mesh=None):
        self.mesh = mesh
        self._tp = None
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
        self.prompt_buckets = None  # see set_prompt_buckets
        # the first attention layer's cache carries the K/V length
        self._kv0 = 0
        self.recurrent = any(name.startswith("mamba.") for name, _ in seq)
        if self.recurrent:
            self._init_hybrid(model, seq, take)
            return

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
        self.mixers = ("attention",) * len(self.blocks)
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
        self._attn_split = self._ffn_split = self._head_split = False
        if mesh is not None:
            self._shard_weights()

    # -- hybrid models (models/jamba.py) ---------------------------------
    def _init_hybrid(self, model, seq, take) -> None:
        """Read a hybrid model's layers: after each gain, a mixer (wq ..
        wo, or mamba.in_proj .. mamba.out_proj) and an FFN (ffn.wg ..
        ffn.wd, or moe.router .. moe.wd).  Its attention takes no
        positions, and the context it serves is ``jamba_lm``'s
        ``max_seq``; its norms take ``jamba_lm``'s eps.  Refused: int8
        weights and a mesh."""
        if self.weight_dtype is not None or self.mesh is not None:
            raise ModelRuntimeError(
                "a model with Mamba layers is served with full-precision "
                "weights on one device (weight_dtype= and mesh= are not "
                "supported for recurrent state)")
        if self.pos is not None:
            raise ModelRuntimeError(
                "a hybrid model attends without positions; this one has "
                "a position table")

        def group(prefix: str, names) -> list:
            return [take(prefix + n) for n in names]

        layers = []
        while len(seq) > 3:
            mixer_g = take("rms.g")
            if seq[0][0] == "wq":
                mixer = _Attn(*group("", _Attn._fields))
            else:
                mixer = mamba_ops.Mixer(*group("mamba.",
                                               mamba_ops.Mixer._fields))
            ffn_g = take("rms.g")
            if seq and seq[0][0] == "moe.router":
                ffn = _Experts(*group("moe.", _Experts._fields))
            else:
                ffn = _Dense(*group("ffn.", _Dense._fields))
            layers.append(_Layer(mixer_g, mixer, ffn_g, ffn))
        self.final_g = take("rms.g")
        self.w_head = take("weights")
        self.b_head = take("bias")
        if seq:
            raise ModelRuntimeError(
                f"{len(seq)} unconsumed parameters; not a jamba_lm model")
        self.blocks = layers
        self.mixers = tuple("attention" if isinstance(lay.mixer, _Attn)
                            else "mamba" for lay in layers)
        if "attention" not in self.mixers:
            raise ModelRuntimeError("a hybrid model needs an attention layer")
        self._kv0 = self.mixers.index("attention")
        attn = self.blocks[self._kv0].mixer
        self.heads, _, self.head_dim = attn.wq.shape
        self.kv_heads = attn.wk.shape[0]
        self.scale = 1.0 / math.sqrt(self.head_dim)
        externs = [kern.extern for target in model.program.targets.values()
                   for kern in target.kernels if kern.extern is not None]
        seqs = {int(e.attrs.get("max_seq", 0)) for e in externs
                if e.name == "attention"}
        epss = {float(e.attrs["eps"]) for e in externs if e.name == "mamba"}
        if len(seqs) != 1 or 0 in seqs or len(epss) != 1:
            raise ModelRuntimeError(
                "a hybrid model's attention must declare one max_seq and "
                "its Mamba layers one eps (models.jamba.jamba_lm does)")
        self.max_seq = seqs.pop()
        self.eps = epss.pop()
        self.window = None  # read by the batcher's page eviction
        self.experts_k = next((int(e.attrs["k"]) for e in externs
                               if e.name == "moe_swiglu"), 0)
        self.experts = next((lay.ffn.router.shape[1] for lay in layers
                             if isinstance(lay.ffn, _Experts)), 0)
        # HYBRID_COUNTS, added on the device where the work is launched,
        # so a CUDA graph's replays count; see counts()
        self._tally = torch.zeros(len(HYBRID_COUNTS), dtype=torch.int64,
                                  device=self.device)
        self._counted = [0] * len(HYBRID_COUNTS)
        self._step = self._step_hybrid

    def counts(self, wait: bool = False) -> dict:
        """What a hybrid model's steps ran since it was built, summed over
        its layers: ``scan_tokens`` (row positions the Mamba layers' scans
        advanced a state by), ``scan_padded_tokens`` (positions given to
        a scan at or past a row's length: bucket padding and parked
        decode rows, which no state sees), ``moe_routed_rows``
        (token-expert pairs the routers chose for live tokens) and
        ``moe_computed_rows`` (expert rows computed: the routed pairs in
        prefill, every expert on every row in the in-place decode step).
        Read without waiting for the card: while its stream is busy, the
        values of the last read when it was idle (``wait`` waits)."""
        dev = self._tally.device
        if wait and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        if dev.type != "cuda" or torch.cuda.current_stream(dev).query():
            self._counted = self._tally.tolist()
        return dict(zip(HYBRID_COUNTS, self._counted))

    def init_state(self, batch: int) -> mamba_ops.MambaState:
        """A zero Mamba state of ``batch`` rows (every Mamba layer's has
        these sizes)."""
        m = self.blocks[self.mixers.index("mamba")].mixer
        d_inner, d_state = m.a_log.shape
        return mamba_ops.init_state(batch, d_inner, m.conv_w.shape[1],
                                    d_state, self.device)

    def _refuse_recurrent(self, what: str) -> None:
        if self.recurrent:
            raise ModelRuntimeError(
                f"{what} is not available for a model with Mamba layers: "
                "their state advances in place and cannot be branched or "
                "rewound")

    def _step_hybrid(self, x, caches, pos_offset: int, key_pos=None,
                     q_pos=None, row_starts=None, cache_io=None):
        """``_step`` of a hybrid model: ``caches`` holds a KV cache (or
        pool) for each attention layer and a ``MambaState`` for each
        Mamba layer, which moves in place.  Each row's true length is
        read from ``q_pos`` (a right-padded row's pad queries repeat its
        last position) or, in the batcher's in-place decode step (a
        ``cache_io`` or ``row_starts``), is 1 for every row the step
        writes (the paged IO's write page is not the trash page 0).
        Experts run on the tokens routed to them, pad tokens left out;
        the in-place decode step runs them dense and masked, whose shapes
        a CUDA graph can capture."""
        b, t, _ = x.shape
        in_place = cache_io is not None or row_starts is not None
        if in_place:
            wpid = getattr(cache_io, "wpid", None)
            lens = (torch.ones(b, dtype=torch.int32, device=x.device)
                    if wpid is None else (wpid != 0).to(torch.int32))
        elif q_pos is not None:
            lens = (q_pos[:, -1] - q_pos[:, 0] + 1).to(torch.int32)
        else:
            lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
        phase = "prefill" if t > 1 else "decode"
        # each Mamba layer's and each MoE layer's share of counts()
        live = lens.sum()
        scan_rows = torch.stack((live, b * t - live))
        routed = live * self.experts_k
        moe_rows = torch.stack((routed, torch.full_like(
            live, b * t * self.experts) if in_place else routed))
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.blocks, caches)):
            rn = self._rms(x, layer.mixer_g)
            if isinstance(layer.mixer, _Attn):
                att, cache = self._attention(
                    layer.mixer, rn, cache, key_pos, q_pos, row_starts,
                    cache_io)
                x = x + att
            else:
                with tracing.span("egt.server.mamba", layer=i, phase=phase,
                                  rows=b, tokens=t):
                    x = x + mamba_ops.mixer(rn, layer.mixer, cache, lens,
                                            self.eps)
                self._tally[:2].add_(scan_rows)
            rn = self._rms(x, layer.ffn_g)
            f = layer.ffn
            if isinstance(f, _Dense):
                x = x + swiglu(rn, *f)
            elif in_place:
                with tracing.span("egt.server.moe", layer=i, phase=phase,
                                  rows=b, path="dense-masked"):
                    x = x + swiglu_dense_masked(
                        rn.reshape(b * t, -1), *f, self.experts_k
                    ).reshape(x.shape)
                self._tally[2:].add_(moe_rows)
            else:
                with tracing.span("egt.server.moe", layer=i, phase=phase,
                                  rows=b, path="routed"):
                    x = x + self._routed(rn, f, lens)
                self._tally[2:].add_(moe_rows)
            new_caches.append(cache)
        return weight_product(self._rms(x, self.final_g), self.w_head) \
            + self.b_head, new_caches

    def _routed(self, rn, f: _Experts, lens):
        """The experts on each row's tokens before its length (pad tokens
        are routed nowhere and give 0)."""
        b, t, dim = rn.shape
        keep = (torch.arange(t, device=rn.device)[None, :]
                < lens.long()[:, None]).reshape(-1)
        flat = rn.reshape(b * t, dim)
        out = torch.zeros_like(flat)
        out[keep] = swiglu_routed(flat[keep], *f, self.experts_k)
        return out.reshape(rn.shape)

    def _attention(self, a: _Attn, rn, cache, key_pos, q_pos, row_starts,
                   cache_io):
        """A hybrid model's attention layer (no positions, no window)
        over its cache: (output [b, t, dim], cache)."""
        q = weight_product(rn, a.wq, HEADS_IN)
        k = weight_product(rn, a.wk, HEADS_IN)
        v = weight_product(rn, a.wv, HEADS_IN)
        att, cache = self._attend(q, k, v, cache, None, key_pos, q_pos,
                                  row_starts, cache_io)
        return weight_product(att, a.wo, HEADS_OUT), cache

    def _attend(self, q, k, v, cache, window, key_pos, q_pos, row_starts,
                cache_io, flash: bool = False):
        """Append the fresh K/V ``k``, ``v`` [b, hkv, t, hd] to ``cache``
        and attend ``q`` [b, h, t, hd] (rotated, where the model rotates)
        over it: (att [b, h, t, hd], cache).  The storage and the masking
        are ``_step``'s (``cache_io``, ``row_starts``, ``key_pos``,
        ``q_pos``).  ``flash`` (a prefill from an empty cache on a mesh)
        runs the flash kernel over the K/V as the cache holds them."""
        att = None
        if cache_io is not None:
            cache = cache_io.append(cache, k, v)
            if hasattr(cache_io, "attend"):
                att = cache_io.attend(q, cache, self.scale, window, key_pos,
                                      q_pos)
            else:
                view = cache_io.view(cache)
        elif row_starts is None:
            cache = view = append(cache, k, v)
        else:
            cache = view = append_at(cache, k, v, row_starts)
        if att is None and flash and key_pos is None \
                and row_starts is None and view.k_scale is None:
            # prefill from an empty cache: the flash kernel on this
            # rank's heads, over the K/V as the cache holds them
            t = q.shape[2]
            att = flash_attention_forward(
                q.contiguous(), view.k[:, :, :t].to(q.dtype).contiguous(),
                view.v[:, :, :t].to(q.dtype).contiguous(), self.scale,
                True, window=window)[0]
        if att is None:
            att = decode_attention(q, view, sm_scale=self.scale,
                                   window=window, key_pos=key_pos,
                                   q_pos=q_pos)
        return att, cache

    # -- multi-device serving (tensor-parallel weights, dp batches) ------
    def _shard_weights(self) -> None:
        """Place the weights over the mesh (``placed_blocks``,
        ``placed_head``) and keep this rank's chunks for the forward."""
        from ._mesh import TensorParallel, is_split, kv_block, local

        tp = self._tp = TensorParallel(self.mesh)
        p = tp.place
        self.placed_blocks = [
            blk._replace(
                attn_g=p(blk.attn_g, None),
                wq=p(blk.wq, "model", None, None),
                wk=p(blk.wk, "model", None, None),
                wv=p(blk.wv, "model", None, None),
                wo=p(blk.wo, "model", None, None),
                ffn_g=p(blk.ffn_g, None),
                w1=p(blk.w1, None, "model"),
                b1=p(blk.b1, "model"),
                w2=p(blk.w2, "model", None),
                b2=p(blk.b2, None),
                w3=p(blk.w3, None, "model"),
            )
            for blk in self.blocks
        ]
        self.placed_head = (p(self.w_head, None, "model"),
                            p(self.b_head, "model"))
        first = self.placed_blocks[0]
        self._attn_split = is_split(first.wq) and is_split(first.wo)
        self._ffn_split = is_split(first.w1) and is_split(first.w2)
        self._head_split = is_split(self.placed_head[0])
        kv = kv_block(tp.mp, tp.mr, self.heads, self.kv_heads) \
            if self._attn_split else None

        def kv_local(w):
            # kv heads that do not divide the axis stay whole in storage;
            # each rank computes the ones its query heads attend
            if kv is None or is_split(w):
                return local(w)
            return _slice_heads(local(w), *kv)

        blocks = []
        for pb in self.placed_blocks:
            blk = pb._replace(**{f: local(getattr(pb, f))
                                 for f in pb._fields})
            if self._attn_split:
                blk = blk._replace(wk=kv_local(pb.wk), wv=kv_local(pb.wv))
            else:  # heads replicated: every rank runs all of them
                blk = blk._replace(wq=_whole(pb.wq), wk=_whole(pb.wk),
                                   wv=_whole(pb.wv), wo=_whole(pb.wo))
            if not self._ffn_split:
                blk = blk._replace(w1=_whole(pb.w1), b1=_whole(pb.b1),
                                   w2=_whole(pb.w2), w3=_whole(pb.w3))
            blocks.append(blk)
        self.blocks = blocks
        self.w_head = local(self.placed_head[0])
        self.b_head = local(self.placed_head[1])
        wq = self.blocks[0].wq
        self.heads = (wq.codes if isinstance(wq, QuantW) else wq).shape[0]
        wk = self.blocks[0].wk
        self.kv_heads = (wk.codes if isinstance(wk, QuantW) else wk).shape[0]

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

        def leaves(x):
            if isinstance(x, tuple) and not isinstance(x, QuantW):
                return [w for part in x for w in leaves(part)]
            return [x]

        tied = (isinstance(self.w_head, torch.Tensor)
                and self.w_head.data_ptr() == self.embed.data_ptr())
        held = [self.final_g, self.b_head] + ([] if tied else [self.w_head])
        return sum(size(w) for w in held) + sum(
            size(w) for blk in self.blocks for w in leaves(blk))

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
            q = weight_product(rn, dq(blk.wq), HEADS_IN)
            k = weight_product(rn, dq(blk.wk), HEADS_IN)
            v = weight_product(rn, dq(blk.wv), HEADS_IN)
            if self.rope_base is not None:
                if q_pos is not None:   # true per-sequence positions
                    rot_pos = q_pos
                else:
                    rot_pos = pos_offset + torch.arange(x.shape[1],
                                                        device=x.device)
                q = self._rope_rotate(q, rot_pos)
                k = self._rope_rotate(k, rot_pos)
            att, cache = self._attend(
                q, k, v, cache, self.window, key_pos, q_pos, row_starts,
                cache_io, flash=self._attn_split and pos_offset == 0)
            x = x + self._reduce(weight_product(att, dq(blk.wo), HEADS_OUT),
                                 self._attn_split)
            rn2 = self._rms(x, blk.ffn_g)
            if blk.w3 is not None:  # swiglu: silu(gate) * up, no biases
                g = weight_product(rn2, dq(blk.w1))
                h = g / (1.0 + torch.exp(-g)) * weight_product(rn2,
                                                               dq(blk.w3))
                x = x + self._reduce(weight_product(h, dq(blk.w2)),
                                     self._ffn_split)
            else:
                h = torch.relu(weight_product(rn2, dq(blk.w1)) + blk.b1)
                x = x + self._reduce(weight_product(h, dq(blk.w2)),
                                     self._ffn_split) + blk.b2
            new_caches.append(cache)
        logits = weight_product(self._rms(x, self.final_g),
                                dq(self.w_head)) + self.b_head
        if self._head_split:
            logits = self._tp.gather_last(logits, True)
        return logits, new_caches

    def _reduce(self, x, split: bool):
        return self._tp.reduce(x, split) if split else x

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
        """A cache a layer: K/V of ``capacity`` rows for an attention
        layer, a zero ``MambaState`` for a Mamba layer."""
        capacity = capacity or self.max_seq
        return [
            init_cache(batch, self.kv_heads, capacity, self.head_dim,
                       dtype=self.cache_dtype, device=self.device)
            if kind == "attention" else self.init_state(batch)
            for kind in self.mixers
        ]

    def prefill(self, tokens, caches):
        """Run the whole prompt ([batch, t] float ids) through the model,
        filling the caches; returns (logits [batch, t, vocab], caches).

        The caches are functional, as the JAX package's: the returned
        caches hold the new rows and every cache given or returned earlier
        keeps its values, so two continuations may be decoded from one
        state.  The rows are written in place while the calls run on
        linearly; a call on an older cache copies the storage first
        (``ops.decode.append``'s copy on write)."""
        tokens = self._tokens(tokens)
        start = caches[self._kv0].length
        x = self._embed_tokens(tokens, start)
        return self._step(x, caches, start)

    def decode(self, token, caches):
        """One token per sequence ([batch, 1]); O(cache) per step.  The
        caches are functional, as :meth:`prefill`'s."""
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
        rows = self._tp and self._tp.rows(batch)
        if rows is not None:
            return self._tp.on_rows(lambda: self.generate(
                prompt[rows], n_new, capacity, temperature, top_k, top_p,
                seed, None if lengths is None else np.asarray(lengths)[rows],
                stop_token, stop_seq))
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
                key_pos[:, caches[self._kv0].length] = cur
                x = self._embed_at(tok[:, None], cur[:, None])
                logits, caches = self._step(x, caches, 0, key_pos=key_pos,
                                            q_pos=cur[:, None])
                last = logits[:, 0]
                cur = cur + 1
            tok = pick(last, gen).to(prompt.dtype)
            if temperature > 0.0 and self._tp is not None:
                tok = self._tp.agree(tok)
            tok = freeze(tok)
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
        rows = self._tp and self._tp.rows(batch)
        if rows is not None:
            return self._tp.on_rows(lambda: self.score(
                tokens[rows],
                None if lengths is None else np.asarray(lengths)[rows]))
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
        self._refuse_recurrent("beam search")
        prompt = self._tokens(prompt)
        batch, t = prompt.shape
        rows = self._tp and self._tp.rows(batch)
        if rows is not None:
            return self._tp.on_rows(lambda: self.generate_beam(
                prompt[rows], n_new, beams, capacity, stop_token))
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
        return [rewind(c, length) for c in caches]

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
        self._refuse_recurrent("speculative decoding")
        draft._refuse_recurrent("a speculative draft")
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
        self._refuse_recurrent("lookup decoding")
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


def _slice_heads(w, lo: int, hi: int):
    """Heads ``[lo, hi)`` (dim 0) of a weight or of its QuantW parts."""
    if isinstance(w, QuantW):
        return QuantW(_slice_heads(w.codes, lo, hi),
                      w.scale if w.scale.shape[0] == 1
                      else _slice_heads(w.scale, lo, hi))
    return w[lo:hi].contiguous()


def _whole(w):
    """A placed weight whole on every rank (a collective when it is
    sharded)."""
    from ..parallel.mesh import global_value

    if w is None:
        return None
    if isinstance(w, QuantW):
        return QuantW(_whole(w.codes), _whole(w.scale))
    return global_value(w)
