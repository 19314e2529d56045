"""Continuous batching for FlashLMServer: slot-based request scheduling.

Counterpart of ``exprgrad_tpu/models/batcher.py``'s
:class:`ContinuousBatcher` (Yu et al., "Orca: A Distributed Serving
System for Transformer-Based Generative Models", OSDI 2022 — the
iteration-level scheduling idea).  Requests arrive at any time with
their own prompt lengths and budgets; a new request takes a slot the
moment one frees up, so the card decodes a full batch every step:

* one decode step for the whole slot batch per ``step()``; per-row cache
  cursors (``ops.decode.append_at``) let each slot sit at its own depth,
  and validity is masked per row by position (``key_pos``/``q_pos``);
* admission prefills the prompt, padded to a width bucket, on a batch-1
  scratch cache and copies its rows into the slot's region (the same
  bfloat16/int8 rounding as serving alone);
* ``paged=True`` keeps K/V in a shared page pool (``ops.paged``) with
  per-slot page tables, pages allocated on demand, recompute preemption
  when the pool runs dry, prefix sharing (``register_prefix``), chunked
  prefill and page eviction behind a sliding window.  The paged decode
  step attends either a gathered dense view (``attention="gather"``) or
  the pages in place through kernel B7 (``attention="flash"``,
  ``ops.paged_attention``);
* ``draft=`` (a small draft server) or ``lookup=True`` (prompt-lookup
  proposals matched on the host) make each dispatch a speculative round:
  ``spec_k`` proposals a slot, verified by the target in one
  ``spec_k + 1``-wide step (through kernel B7 with ``attention="flash"``),
  each slot advancing by its own accepted count.  Rejected K/V are never
  rewound: they are masked by position and overwritten by the next
  round's writes, as in the JAX package;
* all scheduling state (queues, per-slot lengths, budgets, page tables)
  is host numpy; the device only sees dense batched work;
* a hybrid model's Mamba layers (``models.jamba``) keep a fixed-size
  state a slot (``ops.mamba.MambaState``, allocated once beside the K/V
  of its attention layers): admission prefills it from zero on a scratch
  state at the prompt's true length and copies it into the slot, the
  decode steps (a chunk graph's replays too) advance it in place, and a
  preempted request is prefilled from zero again.  Prefix sharing,
  speculative rounds and chunked prefill are refused for such a model.

The JAX package compiles each piece once (``jit`` with buffer donation);
here each piece is a method that runs eagerly and writes the caches in
place.  Greedy streams equal serving each prompt alone with
``server.generate``, up to float reassociation at near-ties; sampled
rows draw from a ``torch.Generator`` seeded with ``seed``.

:class:`Seq2SeqBatcher` is the scheduler's encoder-decoder sibling over
:class:`~exprgrad_torch.models.Seq2SeqServer` (dense caches; plain and
``lookup=True`` rounds).

``decode_chunk=N`` runs N decode steps a dispatch and ``pipeline=P``
keeps P more chunk dispatches in flight, chained on the device, reading
each chunk's tokens back only when it drains (the JAX package's
multi-step scheduling; same streams as ``decode_chunk=1``).  On the card a
chunk dispatch is one CUDA graph replay (``models/_chunk.py``); on the
CPU its steps run eagerly.

While ``torch.profiler`` records, :class:`ContinuousBatcher` leaves spans
(``exprgrad_torch.tracing``): ``egt.batcher.step`` around each
``step()``, and inside it ``egt.batcher.admit`` (slot reservation and
prefix match), ``egt.batcher.prefill`` (each admission unit, ended after
its first token's read back), ``egt.batcher.dispatch``,
``egt.batcher.readback`` and ``egt.batcher.apply`` (the tokens' host
bookkeeping, finishing requests and releasing pages); and, in memory
only, ``egt.batcher.queued`` from a request's ``submit()`` to its first
prefill unit.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..errors import ModelRuntimeError
from ..ops import matmul
from ..ops.decode import KVCache
from ..ops.mamba import MambaState
from ..ops.paged import (gather_rows, gather_view, init_pool, write_prefill,
                         write_prefill_at, write_token)
from ..utils.buckets import bucket_for, normalize_buckets
from ._chunk import ChunkGraph, Pending
from ._sample import check_top_p, make_row_picker, sample_rows
from ._spec import lookup_propose


class _Request:
    __slots__ = ("rid", "tokens", "max_new", "out", "consumed", "absorbed",
                 "submitted", "first_token_at", "finished_at", "preempted",
                 "temp", "top_k", "top_p", "stop_seq", "prefill_at",
                 "prefill_s", "prefix_tokens")

    def __init__(self, rid, tokens, max_new):
        self.rid = rid
        self.tokens = tokens
        self.max_new = max_new
        self.out: list[int] = []
        self.consumed = 0   # prompt tokens already in cache (admission)
        self.absorbed = 0   # out tokens already folded into the prompt
                            # by a recompute preemption
        self.submitted = time.perf_counter()
        self.first_token_at: float | None = None
        self.finished_at: float | None = None
        self.preempted = 0
        self.temp = 0.0      # per-request sampling params (submit())
        self.top_k = 0
        self.top_p = 1.0
        self.stop_seq: tuple | None = None  # per-request stop sequence
        self.prefill_at: float | None = None  # its first prefill unit began
        self.prefill_s = 0.0    # wall seconds of its prefill units until
                                # the first token
        self.prefix_tokens = 0  # prompt tokens a registered prefix covered


class _PrefillUnit:
    """The context of one admission unit of ``req`` in the batcher ``b``:
    ``tokens`` prompt tokens prefilled at ``width``; ``first`` when it
    picks the request's first token (the body then ends after reading it
    back).  Counts the tokens into ``b.stats`` and times the request's
    wait and prefill (``request_metrics()``' ``queue_s`` and
    ``prefill_s``); while tracing, also records ``egt.batcher.queued``
    from those same times and the ``egt.batcher.prefill`` span."""

    __slots__ = ("b", "req", "tokens", "width", "first", "t0", "span")

    def __init__(self, b, req, tokens: int, width: int, first: bool):
        self.b, self.req, self.tokens = b, req, tokens
        self.width, self.first, self.span = width, first, None

    def __enter__(self) -> None:
        b, req = self.b, self.req
        self.t0 = t0 = time.perf_counter()
        b._prefill_tokens += self.tokens
        b._prefill_padded += self.width - self.tokens
        if tracing.enabled():
            if req.prefill_at is None:
                tracing.record("egt.batcher.queued", int(req.submitted * 1e9),
                               int(t0 * 1e9), rid=req.rid)
            self.span = tracing.span(
                "egt.batcher.prefill", rid=req.rid, tokens=self.tokens,
                width=self.width, prefix_tokens=req.prefix_tokens,
                first=self.first)
            self.span.__enter__()
        if req.prefill_at is None:
            req.prefill_at = t0

    def __exit__(self, *exc) -> None:
        if self.span is not None:
            self.span.__exit__(*exc)
        if self.req.first_token_at is None:
            self.req.prefill_s += time.perf_counter() - self.t0


def _check_stop_seq(stop_seq, vocab):
    """Validate a per-request stop sequence (token ids in [0, vocab))."""
    if stop_seq is None:
        return None
    seq = tuple(int(t) for t in stop_seq)
    if not seq or any(t < 0 or t >= vocab for t in seq):
        raise ModelRuntimeError(
            f"stop_seq must be non-empty token ids in [0, {vocab}); "
            f"got {list(seq)}"
        )
    return seq


def _stop_seq_hit(req) -> bool:
    """True when the request's emitted tail equals its stop sequence
    (matched on the host, so sequences of any length share the step)."""
    seq = req.stop_seq
    return (seq is not None and len(req.out) >= len(seq)
            and tuple(req.out[-len(seq):]) == seq)


def _scratch_caches(pools, page_table_row, pre_len: int, extra: int):
    """Batch-1 scratch dense caches whose front is the slot's pages
    gathered in position order, cursor at ``pre_len`` — the shared
    mechanism of prefix-cached admission and chunked prefill.  ``extra``
    spare rows follow the gathered region."""
    minis = []
    for pool in pools:
        if isinstance(pool, MambaState):  # a zero state
            minis.append(MambaState(torch.zeros_like(pool.conv[:1]),
                                    torch.zeros_like(pool.ssm[:1])))
            continue
        kp, vp, kps, vps = gather_rows(pool, page_table_row)
        hkv, dev = kp.shape[1], kp.device
        pad = torch.zeros((1, hkv, extra, kp.shape[3]), dtype=pool.k.dtype,
                          device=dev)
        ones = torch.ones((1, hkv, extra), dtype=torch.float32, device=dev)
        minis.append(KVCache(
            k=torch.cat([kp, pad], dim=2),
            v=torch.cat([vp, pad], dim=2),
            length=int(pre_len),
            k_scale=None if kps is None else torch.cat([kps, ones], dim=2),
            v_scale=None if vps is None else torch.cat([vps, ones], dim=2),
        ))
    return minis


def _greedy_accept(logits, props, pick_k: int):
    """Greedy verify: the target's argmax over the ``pick_k + 1`` verified
    positions, and how many leading proposals it agrees with (the
    cumulative product of positional matches) — one definition behind the
    draft round's greedy branch and the lookup round."""
    greedy = torch.argmax(logits, dim=-1)
    match = props.long() == greedy[:, :pick_k]
    accept = torch.cumprod(match.long(), dim=1).sum(dim=1)
    return greedy, accept


def _cursor_key_pos(n: int, pos: torch.Tensor, extra: int = 0):
    """Per-row slot validity for cursor-based caches: [b, n] of the slot
    index where ``slot <= pos + extra``, else -1 (the decode_attention
    masking convention), in ``pos``'s integer type."""
    ids = torch.arange(n, dtype=pos.dtype, device=pos.device)
    return torch.where(ids[None, :] <= pos[:, None] + extra, ids[None, :],
                       torch.full_like(ids[None, :], -1))


def _pick_first(pick, logits, length: int, generator, temp, top_k, top_p):
    """First token of a batch-1 prefill: the per-request pick from the
    logits row at ``length - 1``."""
    return pick(logits[:, length - 1], generator, np.reshape(temp, (1,)),
                np.reshape(top_k, (1,)), np.reshape(top_p, (1,)))[0]


def _make_paged_io(attention: str, page_table, wpid, woff):
    """Cache-IO object for the paged decode step: ``append`` writes the
    fresh K/V at the host-chosen (page, offset) coordinates; attention
    either gathers a dense view (``attention='gather'``) or attends the
    pages in place through kernel B7 (``attention='flash'``, where the
    resident cache crosses device memory once per step instead of
    twice)."""

    class _IO:
        @staticmethod
        def append(pool, k, v):
            return write_token(pool, k, v, wpid, woff)

        @staticmethod
        def view(pool):
            return gather_view(pool, page_table)

    # where each row's K/V land: the trash page 0 for a parked row (a
    # hybrid model's Mamba layers advance only the other rows)
    _IO.wpid = wpid

    if attention == "flash":
        from ..ops.paged_attention import paged_decode_attention

        def attend(q, pool, sm_scale, window, key_pos, q_pos):
            return paged_decode_attention(
                q.contiguous(), pool, page_table, key_pos, q_pos,
                sm_scale=sm_scale, window=window)

        _IO.attend = staticmethod(attend)
    return _IO


def _copy_state(big: MambaState, mini: MambaState, slot: int) -> None:
    """A batch-1 scratch Mamba state into row ``slot`` (in place)."""
    big.conv[slot] = mini.conv[0]
    big.ssm[slot] = mini.ssm[0]


def _write_slot_rows(caches, minis, slot: int) -> None:
    """Copy a batch-1 scratch cache's rows into row ``slot`` of the big
    dense caches (in place)."""
    for big, m in zip(caches, minis):
        if isinstance(big, MambaState):
            _copy_state(big, m, slot)
            continue
        w = m.k.shape[2]
        big.k[slot, :, :w] = m.k[0]
        big.v[slot, :, :w] = m.v[0]
        if big.k_scale is not None:
            big.k_scale[slot, :, :w] = m.k_scale[0]
            big.v_scale[slot, :, :w] = m.v_scale[0]


class ContinuousBatcher:
    """Iteration-level scheduler over a :class:`FlashLMServer`.

    ``slots`` is the decode batch width (the card works on all slots every
    step); ``capacity`` bounds ``prompt_len + max_new - 1`` per request.
    ``prompt_buckets`` quantizes admission prefill widths (default:
    powers of two up to ``capacity``).

    >>> b = ContinuousBatcher(server, slots=4, capacity=128)
    >>> rid = b.submit([3, 1, 4], max_new=16)
    >>> done = b.run()            # {rid: np.ndarray of 16 tokens}

    ``submit`` may be called at any time, including between ``step()``
    calls while other requests are mid-flight.
    """

    def __init__(
        self,
        server,
        slots: int = 8,
        capacity: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop_token: Optional[int] = None,
        seed: int = 0,
        prompt_buckets: Optional[Sequence[int]] = None,
        paged: bool = False,
        page_size: int = 16,
        pool_pages: Optional[int] = None,
        decode_chunk: int = 1,
        prefill_chunk: Optional[int] = None,
        draft=None,
        spec_k: int = 4,
        lookup: bool = False,
        lookup_ngram: int = 2,
        stream_tokens: bool = False,
        attention: str = "gather",
        pipeline: int = 0,
    ):
        check_top_p(top_p)
        if attention not in ("gather", "flash"):
            raise ModelRuntimeError(
                f"attention must be 'gather' (dense view + decode "
                f"attention) or 'flash' (the paged-attention kernel); "
                f"got {attention!r}")
        if attention == "flash" and not paged:
            raise ModelRuntimeError(
                "attention='flash' is the paged-attention kernel; it "
                "requires ContinuousBatcher(paged=True)")
        self.attention = attention
        self._skinny0 = (matmul.skinny_launches, matmul.skinny_declined)
        self._recurrent = server.recurrent
        if self._recurrent:
            self._counts0 = server.counts(wait=True)
            what = [name for name, on in (
                ("draft=", draft is not None), ("lookup=True", lookup),
                ("prefill_chunk", prefill_chunk is not None)) if on]
            if what:
                raise ModelRuntimeError(
                    f"{', '.join(what)}: not available for a model with "
                    "Mamba layers, whose state cannot be rewound after a "
                    "rejected proposal or resumed from a prompt chunk")
        if draft is not None:
            # speculative batching: greedy (exact streams) or temperature
            # sampling (the rejection scheme, the solo distributions)
            if top_k is not None or top_p is not None:
                raise ModelRuntimeError(
                    "speculative batching supports greedy or plain "
                    "temperature sampling; top_k/top_p filters are not "
                    "part of the rejection scheme")
            if decode_chunk != 1:
                raise ModelRuntimeError(
                    "draft= and decode_chunk are mutually exclusive "
                    "(the spec round already amortizes dispatches)")
            if draft.vocab != server.vocab:
                raise ModelRuntimeError(
                    f"draft vocab {draft.vocab} != target vocab "
                    f"{server.vocab}")
        if spec_k < 1:  # stored unconditionally: validate unconditionally
            raise ModelRuntimeError(f"spec_k must be >= 1 (got {spec_k})")
        if lookup:
            # prompt-lookup speculation (no draft): per-slot proposals
            # from an ngram match over the slot's prompt and emitted
            # history, which the host holds for stop detection anyway;
            # exact greedy, so sampling settings are refused
            if draft is not None:
                raise ModelRuntimeError(
                    "lookup=True and draft= are mutually exclusive "
                    "(lookup IS the draft-free speculation variant)")
            if temperature != 0.0 or top_k is not None or top_p is not None:
                raise ModelRuntimeError(
                    "lookup speculation is exact-greedy only; it has no "
                    "proposal distribution for the rejection scheme "
                    "(use draft= for sampled speculation)")
            if decode_chunk != 1:
                raise ModelRuntimeError(
                    "lookup=True and decode_chunk are mutually exclusive "
                    "(the verify round already amortizes dispatches)")
            if lookup_ngram < 1:
                raise ModelRuntimeError(
                    f"lookup_ngram must be >= 1 (got {lookup_ngram})")
        self.draft = draft
        self.lookup = bool(lookup)
        self.lookup_ngram = int(lookup_ngram)
        self._spec = draft is not None or self.lookup
        self.spec_k = int(spec_k)
        if decode_chunk < 1:
            raise ModelRuntimeError(
                f"decode_chunk must be >= 1 (got {decode_chunk})")
        tp = getattr(server, "_tp", None)
        if decode_chunk > 1 and tp is not None \
                and not tp.capturable(server.device):
            raise ModelRuntimeError(
                "decode_chunk > 1 captures each chunk as a CUDA graph, and "
                "the collectives of a multi-rank gloo mesh run on the host "
                "and cannot be captured; use decode_chunk=1 on this mesh")
        if pipeline < 0:
            raise ModelRuntimeError(
                f"pipeline must be >= 0 (got {pipeline})")
        self.decode_chunk = int(decode_chunk)
        if pipeline and self._spec:
            raise ModelRuntimeError(
                "pipeline= and speculation are mutually exclusive (the spec "
                "round's acceptance is data-dependent per dispatch)")
        if pipeline and decode_chunk < 2:
            raise ModelRuntimeError(
                "pipeline= requires decode_chunk >= 2 (pipelining "
                "amortizes the per-dispatch round trip over chunks)")
        # pipelined chunked decode: keep `pipeline` extra chunk dispatches
        # in flight, chained on the device on the previous dispatch's
        # (tok, pos); the host reads a chunk's tokens back only when it
        # drains.  Greedy streams equal pipeline=0 (rows are independent,
        # tokens past a stop are fenced or discarded).  A stopped row
        # wastes at most `pipeline` chunks of device work, and its slot
        # is released only once the pipe drains.
        self.pipeline = int(pipeline)
        self._pipe: deque = deque()
        self._pending_release: list = []
        self._deferred_finished: list = []
        self._pipe_draining = False
        self._dev_tok = None
        self._dev_pos = None
        self._shadow_pos = None
        # CUDA graphs of the chunk dispatch, by key
        self.chunk_graphs: dict = {}
        if prefill_chunk is not None:
            if not paged:
                raise ModelRuntimeError(
                    "prefill_chunk requires ContinuousBatcher(paged=True)")
            if prefill_chunk < 1 or prefill_chunk % int(page_size):
                raise ModelRuntimeError(
                    f"prefill_chunk must be a positive multiple of "
                    f"page_size {page_size} (got {prefill_chunk})"
                )
        self.prefill_chunk = (
            None if prefill_chunk is None else int(prefill_chunk))
        self.server = server
        self.device = server.device
        self.slots = int(slots)
        self.capacity = int(capacity or server.max_seq)
        if self.capacity > server.max_seq:
            raise ModelRuntimeError(
                f"capacity {self.capacity} exceeds the model's max_seq "
                f"{server.max_seq} position embeddings"
            )
        if draft is not None and self.capacity > draft.max_seq:
            # the spec round feeds the draft the same positions
            raise ModelRuntimeError(
                f"capacity {self.capacity} exceeds the DRAFT model's "
                f"max_seq {draft.max_seq}"
            )
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stop_token = stop_token
        self.prompt_buckets = normalize_buckets(
            "pow2" if prompt_buckets is None else prompt_buckets,
            "prompt bucket",
        )
        self._row_pick = make_row_picker(server.vocab)
        # per-slot sampling params (per-request values land here at
        # reservation)
        self.req_temp = np.zeros(self.slots, np.float32)
        self.req_topk = np.full(self.slots, server.vocab, np.int32)
        self.req_topp = np.ones(self.slots, np.float32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.paged = bool(paged)
        if self.paged:
            # a shared page pool + per-slot page tables; ``pool_pages``
            # usable pages (default: the dense equivalent) + one trash
            # page (id 0) that inactive rows write to.  Pages allocate on
            # demand and pool exhaustion preempts by recompute.
            self.page_size = int(page_size)
            if self.page_size < 1:
                raise ModelRuntimeError("page_size must be >= 1")
            self.pages_per_slot = -(-self.capacity // self.page_size)
            usable = (pool_pages if pool_pages is not None
                      else self.slots * self.pages_per_slot)
            if usable < 1:
                raise ModelRuntimeError("pool_pages must be >= 1")
            self.pool_pages = int(usable)
            self.caches = [
                init_pool(self.pool_pages + 1, server.kv_heads,
                          self.page_size, server.head_dim,
                          dtype=server.cache_dtype, device=self.device)
                if kind == "attention" else server.init_state(self.slots)
                for kind in server.mixers
            ]
            self.free_pages = list(range(1, self.pool_pages + 1))
            self.slot_pages: list[list[int]] = [[] for _ in range(slots)]
            self.page_table = np.zeros(
                (self.slots, self.pages_per_slot), np.int32)
            self._preempts = 0
            self._window_evicted = 0
            self._evict_cursor = np.zeros(self.slots, np.int64)
            # prefix cache: registered (tokens, pinned pages) entries
            # whose K/V pages are shared read-only by matching prompts
            self._prefixes: list[tuple[np.ndarray, list[int]]] = []
            self._slot_pinned = np.zeros(self.slots, np.int64)
            self._prefix_hits = 0
        else:
            self.caches = server.init_caches(self.slots, self.capacity)
        self.pos = np.zeros(self.slots, np.int32)     # cached tokens/slot
        self.last = np.zeros(self.slots, np.float32)  # next token to feed
        self.active = np.zeros(self.slots, bool)
        self._req: list[Optional[_Request]] = [None] * self.slots
        self.queue: deque[_Request] = deque()
        self._next_rid = 0
        self._steps = 0
        self._dispatches = 0
        self._prefill_tokens = 0  # true prompt tokens prefilled
        self._prefill_padded = 0  # bucket padding prefilled beside them
        self._decode_tokens = 0   # tokens the decode dispatches emitted
        self._admitted = 0        # first tokens picked by admission
        self._rows = 0            # rows of the current step's dispatch
        # bounded: a long-running server must not leak one record per
        # request (drain with request_metrics(reset=True) to keep all)
        self._metrics: deque = deque(maxlen=4096)
        self.stream_tokens = bool(stream_tokens)
        self._stream: list[tuple] = []
        if self.draft is not None:
            # the draft's K/V are always a dense per-slot cache (a small
            # model), its per-row cursors mirroring the target's positions
            self.draft_caches = self.draft.init_caches(self.slots,
                                                       self.capacity)
        if self._spec:
            self._spec_emitted = 0
            self._spec_rounds = 0

    # -- device work ---------------------------------------------------
    def _dev(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _prefill_scratch(self, srv, prompt, length: int):
        """Prefill a [1, width] padded prompt of ``length`` true tokens on
        a batch-1 scratch cache of ``srv``: (logits, scratch caches)."""
        width = prompt.shape[1]
        mini = srv.init_caches(1, width)
        lens = self._dev([length], torch.int32)
        pos_ids, key_pos = srv._ragged_positions(lens, width, width)
        x = srv._embed_at(self._dev(prompt), pos_ids)
        return srv._step(x, mini, 0, key_pos=key_pos, q_pos=pos_ids)

    def _admit(self, prompt, length: int, slot: int, temp, tk, tp):
        """Prefill a [1, width] padded prompt on a scratch cache, pick the
        first token, and write the K/V region into the slot's rows."""
        logits, mini = self._prefill_scratch(self.server, prompt, length)
        first = _pick_first(self._row_pick, logits, length, self._gen, temp,
                            tk, tp)
        _write_slot_rows(self.caches, mini, slot)
        return first

    def _admit_draft(self, slot) -> None:
        """Prefill the draft's dense cache row for a just-activated slot
        (no token is picked: the target's admission did)."""
        req = self._req[slot]
        width = self._bucket(req.tokens.size)
        prompt = np.zeros((1, width), np.float32)
        prompt[0, :req.tokens.size] = req.tokens
        _, mini = self._prefill_scratch(self.draft, prompt, req.tokens.size)
        _write_slot_rows(self.draft_caches, mini, slot)

    def _decode(self):
        """One decode step for every slot: feed each slot's pending token
        at its own position, write K/V at its own cursor, pick the next."""
        srv = self.server
        pos = self._dev(self.pos)
        key_pos = _cursor_key_pos(self.capacity, pos)
        x = srv._embed_at(self._dev(self.last)[:, None], pos[:, None])
        logits, self.caches = srv._step(
            x, self.caches, 0, key_pos=key_pos, q_pos=pos[:, None],
            row_starts=pos)
        return self._row_pick(logits[:, -1], self._gen, self.req_temp,
                              self.req_topk, self.req_topp)

    def _decode_paged(self, wpid, woff):
        """One paged decode step for every slot: fresh K/V land at the
        host-chosen (page, offset) coordinates; attention reads each
        row's pages through a gathered view or kernel B7."""
        srv = self.server
        virtual = self.pages_per_slot * self.page_size
        pos = self._dev(self.pos)
        key_pos = _cursor_key_pos(virtual, pos)
        x = srv._embed_at(self._dev(self.last)[:, None], pos[:, None])
        io = _make_paged_io(self.attention, self._dev(self.page_table),
                            self._dev(wpid), self._dev(woff))
        logits, self.caches = srv._step(
            x, self.caches, 0, key_pos=key_pos, q_pos=pos[:, None],
            cache_io=io)
        return self._row_pick(logits[:, -1], self._gen, self.req_temp,
                              self.req_topk, self.req_topp)

    def _chunk_steps(self, tok, pos, stop_at, table, temp, top_k, top_p,
                     n=None, generator=None, sampled=False):
        """``n`` (default ``decode_chunk``) decode steps for every slot on
        device tensors — the body of a chunk dispatch, which a CUDA graph
        captures: a row advances only while ``pos < stop_at``; a parked
        row writes the trash page (paged, ``wpid`` read from the page
        table on the device) or its own next slot (dense), masked by
        position either way.  Returns (tokens [n, slots], final tok,
        final pos)."""
        srv = self.server
        toks = []
        for _ in range(self.decode_chunk if n is None else n):
            alive = pos < stop_at
            x = srv._embed_at(tok[:, None], pos[:, None])
            if self.paged:
                pg = self.page_size
                entry = (pos // pg).clamp(max=table.shape[1] - 1)
                wpid = torch.gather(table, 1, entry[:, None].long())[:, 0]
                wpid = torch.where(alive, wpid, torch.zeros_like(wpid))
                io = _make_paged_io(self.attention, table, wpid, pos % pg)
                logits, _ = srv._step(
                    x, self.caches, 0, q_pos=pos[:, None], cache_io=io,
                    key_pos=_cursor_key_pos(
                        self.pages_per_slot * pg, pos))
            else:
                logits, _ = srv._step(
                    x, self.caches, 0, q_pos=pos[:, None], row_starts=pos,
                    key_pos=_cursor_key_pos(self.capacity, pos))
            if sampled:
                nxt = sample_rows(logits[:, -1], generator, temp, top_k,
                                  top_p, srv.vocab)
            else:
                nxt = torch.argmax(logits[:, -1], dim=-1)
            toks.append(nxt)
            tok = torch.where(alive, nxt.to(tok.dtype), tok)
            pos = pos + alive.to(pos.dtype)
        return torch.stack(toks), tok, pos

    def _dispatch_chunk(self, stop_at, table, chained: bool) -> Pending:
        """Issue one chunk dispatch from the host's ``last`` and ``pos``,
        or, ``chained``, from the previous dispatch's device-side (tok,
        pos); no read back.  On the card it is one replay of the chunk's
        CUDA graph, captured on the first dispatch of its key; on the CPU
        the steps run eagerly."""
        with self._dispatch_span(self.decode_chunk):
            return self._run_chunk(stop_at, table, chained)

    def _dispatch_span(self, steps: int):
        """The span of one decode dispatch of ``steps`` steps over the rows
        decoding now (also the step span's ``rows``)."""
        if not tracing.enabled():
            return tracing.NULL
        self._rows = int(self.active.sum())
        return tracing.span("egt.batcher.dispatch", rows=self._rows,
                            steps=steps)

    def _run_chunk(self, stop_at, table, chained: bool) -> Pending:
        s = self.slots
        ints = np.concatenate([self.pos, stop_at, self.req_topk,
                               table.reshape(-1)]).astype(np.int32)
        floats = np.concatenate([self.last, self.req_temp,
                                 self.req_topp]).astype(np.float32)
        sampled = bool((self.req_temp > 0.0).any())
        prev = (self._dev_tok, self._dev_pos) if chained else None
        if self.device.type != "cuda":
            dev = self.device
            ti = torch.from_numpy(ints).to(dev)
            tf = torch.from_numpy(floats).to(dev)
            tok, pos = prev if chained else (tf[:s], ti[:s])
            toks, self._dev_tok, self._dev_pos = self._chunk_steps(
                tok, pos, ti[s:2 * s], ti[3 * s:].view(s, -1), tf[s:2 * s],
                ti[2 * s:3 * s], tf[2 * s:], generator=self._gen,
                sampled=sampled)
            return Pending(toks.cpu())
        key = ("cb_chunk", self.decode_chunk, self.paged, s,
               self.pages_per_slot if self.paged else self.capacity,
               self.pool_pages if self.paged else 0,
               self.page_size if self.paged else 0, self.attention,
               str(self.server.cache_dtype), sampled)
        graph = self.chunk_graphs.get(key)
        if graph is None:
            gen = self._gen if sampled else None

            def steps(*args, n=None):
                return self._chunk_steps(*args, n=n, generator=gen,
                                         sampled=sampled)

            graph = ChunkGraph(steps, s, table.shape[1], self.caches,
                               self.device, ints, floats, prev, gen)
            self.chunk_graphs[key] = graph
        pending = graph.launch(ints, floats, self.caches, prev)
        self._dev_tok, self._dev_pos = graph.tok, graph.pos
        return pending

    def _verify(self, tok, pos, props, wpid, woff):
        """The target's ``spec_k + 1``-wide step over each slot's pending
        token and its proposals, at positions ``pos .. pos + spec_k``:
        dense caches write at per-row cursors, paged pools at the
        host-chosen (page, offset) coordinates and attend through the
        gathered view or kernel B7.  Returns logits [slots, k + 1, V]."""
        srv, k = self.server, self.spec_k
        seq = torch.cat([tok[:, None], props.to(tok.dtype)], dim=1)
        qp = pos[:, None] + torch.arange(k + 1, dtype=pos.dtype,
                                         device=pos.device)[None, :]
        x = srv._embed_at(seq, qp)
        if self.paged:
            virtual = self.pages_per_slot * self.page_size
            io = _make_paged_io(self.attention, self._dev(self.page_table),
                                self._dev(wpid), self._dev(woff))
            logits, self.caches = srv._step(
                x, self.caches, 0, key_pos=_cursor_key_pos(virtual, pos, k),
                q_pos=qp, cache_io=io)
        else:
            logits, self.caches = srv._step(
                x, self.caches, 0,
                key_pos=_cursor_key_pos(self.capacity, pos, k), q_pos=qp,
                row_starts=pos)
        return logits

    def _spec_round(self, wpid, woff):
        """One speculative round for the whole slot batch: the draft
        proposes ``spec_k`` tokens a row (greedy, or sampled at the
        batcher's temperature), the target verifies them in one step,
        and each row's acceptance comes back: greedy matching, or the
        rejection scheme whose output distribution is plain target
        sampling.  Returns (tokens [slots, k + 1], accepted [slots]): a
        row emits its first ``accepted + 1`` tokens.  The draft runs one
        more write-only step, so its cache has no hole when every
        proposal is accepted."""
        draft, k = self.draft, self.spec_k
        temp = float(self.temperature)
        sampled = temp > 0.0
        tok = self._dev(self.last)
        pos = self._dev(self.pos)
        dt, dpos, outs, qs = tok, pos, [], []
        for _ in range(k + 1):
            x = draft._embed_at(dt[:, None], dpos[:, None])
            logits, self.draft_caches = draft._step(
                x, self.draft_caches, 0,
                key_pos=_cursor_key_pos(self.capacity, dpos),
                q_pos=dpos[:, None], row_starts=dpos)
            row = logits[:, -1].float()
            if sampled:
                q = torch.softmax(row / temp, dim=-1)
                nxt = torch.multinomial(q, 1, generator=self._gen)[:, 0]
                qs.append(q)
            else:
                nxt = torch.argmax(row, dim=-1)
            outs.append(nxt)
            dt, dpos = nxt.to(tok.dtype), dpos + 1
        props = torch.stack(outs[:k], dim=1)                  # [b, k]
        logits = self._verify(tok, pos, props, wpid, woff)
        if not sampled:
            return _greedy_accept(logits, props, k)
        # the rejection scheme per row (_spec.py's math): accept proposal
        # i while u_i < p(d_i) / q(d_i); the first rejection draws the
        # correction from normalize(relu(p - q)); full acceptance draws
        # the bonus from position k's target distribution
        qs = torch.stack(qs[:k], dim=1)                       # [b, k, V]
        rows = torch.arange(props.shape[0], device=props.device)
        cols = torch.arange(k, device=props.device)[None, :]
        p = torch.softmax(logits.float() / temp, dim=-1)      # [b, k+1, V]
        ratio = (p[rows[:, None], cols, props]
                 / qs[rows[:, None], cols, props].clamp(min=1e-30))
        acc = torch.rand(ratio.shape, generator=self._gen,
                         device=ratio.device) < ratio
        a = torch.cumprod(acc.long(), dim=1).sum(dim=1)       # 0..k
        rej = a.clamp(max=k - 1)
        resid = (p[rows, rej] - qs[rows, rej]).clamp(min=0.0)
        rs = resid.sum(dim=1, keepdim=True)
        resid = torch.where(rs > 1e-30, resid / rs, p[rows, rej])
        corr = torch.multinomial(resid, 1, generator=self._gen)[:, 0]
        bonus = torch.multinomial(p[:, k], 1, generator=self._gen)[:, 0]
        emit = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
        emit[rows, a] = torch.where(a == k, bonus, corr)
        return emit, a

    def _lookup_props(self, slot) -> np.ndarray:
        """Prompt-lookup proposals for one slot from the history the
        scheduler already holds (prompt and emitted tokens); an inactive
        slot proposes zeros."""
        req = self._req[slot]
        if req is None or not self.active[slot]:
            return np.zeros(self.spec_k, np.int64)
        # a preemption folds out[:absorbed] into the continuation prompt
        # (req.tokens): only the unabsorbed tail is appended here
        hist = np.concatenate([req.tokens.astype(np.int64),
                               np.asarray(req.out[req.absorbed:], np.int64)])
        return lookup_propose(hist, self.spec_k, self.lookup_ngram)

    def _lookup_round(self, wpid, woff):
        """One draft-free verify round: the host's lookup proposals ride
        in as data, the target verifies them, greedy acceptance comes
        back (``_spec_round``'s contract)."""
        props = self._dev(np.stack([self._lookup_props(s)
                                    for s in range(self.slots)]))
        logits = self._verify(self._dev(self.last), self._dev(self.pos),
                              props, wpid, woff)
        return _greedy_accept(logits, props, self.spec_k)

    def _register_prefix_pages(self, prompt, page_ids) -> None:
        """Prefill the prefix (batch-1, full width) and pin its K/V into
        the given pool pages."""
        srv = self.server
        mini = srv.init_caches(1, len(page_ids) * self.page_size)
        _, mini = srv.prefill(prompt, mini)
        for pool, m in zip(self.caches, mini):
            write_prefill(pool, m, page_ids)

    def _admit_prefix(self, suffix, s_len: int, pre_len: int,
                      page_table_row, own_pages, temp, tk, tp, row: int):
        """Paged admission tail: gather the slot's pages so far (pinned
        prefix + chunk-prefilled pages) as the front of a scratch cache,
        prefill the remaining suffix against it, pick the first token,
        and copy the suffix's pages out."""
        srv = self.server
        pg = self.page_size
        width_s = suffix.shape[1]
        cap_s = -(-width_s // pg) * pg
        virtual = self.pages_per_slot * pg
        minis = _scratch_caches(self.caches, page_table_row, pre_len, cap_s)
        dev = self.device
        pos_ids = (pre_len + torch.clamp(torch.arange(width_s, device=dev),
                                         max=s_len - 1))[None]
        slot = torch.arange(virtual + cap_s, device=dev)
        key_pos = torch.where(slot < pre_len + s_len, slot, -1)[None]
        x = srv._embed_at(self._dev(suffix), pos_ids)
        logits, minis = srv._step(x, minis, 0, key_pos=key_pos,
                                  q_pos=pos_ids)
        first = _pick_first(self._row_pick, logits, s_len, self._gen, temp,
                            tk, tp)
        for pool, m in zip(self.caches, minis):
            if isinstance(pool, MambaState):
                _copy_state(pool, m, row)
            else:
                write_prefill_at(pool, m, own_pages, pre_len)
        return first

    def _prefill_chunk(self, tokens, pre_len: int, page_table_row,
                       new_pages) -> None:
        """One page-aligned prompt chunk: append its K/V at the slot's
        depth and write them into freshly allocated pages.  No token is
        picked: the final (ragged) tail goes through _admit_prefix."""
        srv = self.server
        chunk = tokens.shape[1]
        virtual = self.pages_per_slot * self.page_size
        minis = _scratch_caches(self.caches, page_table_row, pre_len, chunk)
        dev = self.device
        pos_ids = (pre_len + torch.arange(chunk, device=dev))[None]
        slot = torch.arange(virtual + chunk, device=dev)
        key_pos = torch.where(slot < pre_len + chunk, slot, -1)[None]
        x = srv._embed_at(self._dev(tokens), pos_ids)
        _, minis = srv._step(x, minis, 0, key_pos=key_pos, q_pos=pos_ids)
        for pool, m in zip(self.caches, minis):
            write_prefill_at(pool, m, new_pages, pre_len)

    # -- paged bookkeeping ---------------------------------------------
    def _admit_chunk(self):
        """Admission chunk size: the user's prefill_chunk, or — for
        window models, which rely on between-chunk eviction to bound
        their prefill burst — an implicit band-sized chunk."""
        if self.prefill_chunk:
            return self.prefill_chunk
        window = self.server.window
        if window is None:
            return None
        return (-(-int(window) // self.page_size) * self.page_size
                + self.page_size)

    def _pages_for(self, n_rows: int) -> int:
        return -(-n_rows // self.page_size)

    def _free_slot_pages(self, slot) -> None:
        self._evict_cursor[slot] = 0
        pinned = int(self._slot_pinned[slot])
        # 0 entries are window-evicted placeholders, already in the pool
        self.free_pages.extend(
            p for p in self.slot_pages[slot][pinned:] if p)
        self.slot_pages[slot] = []
        self._slot_pinned[slot] = 0
        self.page_table[slot, :] = 0

    def _match_prefix(self, tokens: np.ndarray):
        """Longest registered prefix usable for this prompt (>= 1 token
        must remain as suffix): (aligned length, pinned page ids)."""
        pg = self.page_size
        best_len, best_pages = 0, None
        limit = (tokens.size - 1) // pg * pg
        for arr, pages in self._prefixes:
            use = min(arr.size, limit)
            if use <= best_len or use < pg:
                continue
            if np.array_equal(tokens[:use], arr[:use]):
                best_len, best_pages = use, pages[:use // pg]
        return best_len, best_pages

    def _preempt_one(self, protect: int) -> bool:
        """Evict a resident slot (other than ``protect``) and requeue it at
        the front as a recompute continuation; free its pages.
        Mid-prefill slots go first (least invested, by consumed tokens),
        then the active slot with the fewest generated tokens.  Greedy
        decoding makes the recompute emit the same stream."""
        pre = [s for s in range(self.slots)
               if s != protect and not self.active[s]
               and self._req[s] is not None]
        if pre:
            victim = min(pre, key=lambda s: self._req[s].consumed)
            req = self._req[victim]
            req.consumed = 0
            req.preempted += 1
            self.queue.appendleft(req)
            self._req[victim] = None
            self._free_slot_pages(victim)
            self._preempts += 1
            return True
        victims = [s for s in range(self.slots)
                   if self.active[s] and s != protect]
        if not victims:
            return False
        victim = min(victims, key=lambda s: len(self._req[s].out))
        req = self._req[victim]
        # fold only the not-yet-absorbed output into the continuation
        # prompt: the total footprint stays prompt+max_new-1 across any
        # number of preemptions
        req.tokens = np.concatenate(
            [req.tokens, np.asarray(req.out[req.absorbed:], np.float32)])
        req.absorbed = len(req.out)
        req.consumed = 0
        req.preempted += 1
        self.queue.appendleft(req)
        self.active[victim] = False
        self._req[victim] = None
        self._free_slot_pages(victim)
        self._preempts += 1
        return True

    def _ensure_pages_upto(self, slot, upto: int) -> None:
        """Allocate pages until ``slot`` owns the page that position
        ``upto`` lands in; preempt others if the pool is dry."""
        page_idx = int(upto) // self.page_size
        self._alloc_pages(slot, page_idx + 1 - len(self.slot_pages[slot]))

    def _alloc_pages(self, slot, n: int) -> None:
        """Append ``n`` fresh pages to the slot's table, preempting other
        residents if the pool is dry."""
        for _ in range(max(0, n)):
            while not self.free_pages:
                if not self._preempt_one(protect=slot):
                    raise ModelRuntimeError(
                        "page pool exhausted with a single resident "
                        "request; this cannot happen when submit()'s "
                        "feasibility check passed"
                    )
            pid = self.free_pages.pop()
            self.slot_pages[slot].append(pid)
            self.page_table[slot, len(self.slot_pages[slot]) - 1] = pid

    def _pinned_total(self) -> int:
        return sum(len(p) for _, p in self._prefixes) if self.paged else 0

    def _own_pages_needed(self, tokens: np.ndarray, remaining: int) -> int:
        """Worst-case pages a request must allocate itself: its full
        footprint (a speculative round's ``spec_k`` rows past the fed
        position count) minus the pages the registered prefixes cover.
        Window models evict pages behind the attention band, also between
        prefill chunks, so their worst-case simultaneous residency is the
        band plus the largest write run between evictions: an admission
        chunk, a decode chunk or a speculative round."""
        margin = max(self.spec_k if self._spec else 0, self.decode_chunk)
        need = tokens.size + remaining - 1
        if self._spec:
            need += self.spec_k
        _, pages = self._match_prefix(tokens)
        shared = len(pages) if pages else 0
        full = self._pages_for(need) - shared
        window = self.server.window
        if window is None:
            return full
        burst = max(margin, self._admit_chunk() or 0)
        steady = self._pages_for(int(window) + burst + 1) + 2
        return min(full, steady)

    # -- public API ----------------------------------------------------
    def register_prefix(self, tokens) -> int:
        """Pin a shared prompt prefix (a system prompt) into pool pages:
        every later ``submit`` whose prompt starts with it reuses the
        pinned K/V pages read-only.  Only whole pages are shared; returns
        the page-aligned length cached.  Paged mode only."""
        if not self.paged:
            raise ModelRuntimeError(
                "prefix caching requires ContinuousBatcher(paged=True)")
        if self._recurrent:
            raise ModelRuntimeError(
                "prefix sharing is not available for a model with Mamba "
                "layers: a shared prefix's state is not kept")
        tokens = np.asarray(tokens, np.float32).reshape(-1)
        aligned = tokens.size // self.page_size * self.page_size
        if aligned < self.page_size:
            raise ModelRuntimeError(
                f"prefix must span at least one page "
                f"({self.page_size} tokens; got {tokens.size})"
            )
        if self.server.pos is not None and aligned > self.server.max_seq:
            raise ModelRuntimeError(
                f"prefix length {aligned} exceeds max_seq "
                f"{self.server.max_seq}"
            )
        tokens = tokens[:aligned]
        for arr, pages in self._prefixes:
            if arr.size == aligned and np.array_equal(arr, tokens):
                return aligned  # already registered
        n = aligned // self.page_size
        if len(self.free_pages) < n:
            raise ModelRuntimeError(
                f"prefix needs {n} pages but only {len(self.free_pages)} "
                "are free"
            )
        # pinning must not strand any admitted request: every resident
        # or queued request must still fit in the shrunken unpinned pool
        avail = self.pool_pages - self._pinned_total() - n
        for req in list(self.queue) + [r for r in self._req if r]:
            own = self._own_pages_needed(
                req.tokens, req.max_new - len(req.out))
            if own > avail:
                raise ModelRuntimeError(
                    f"pinning this prefix ({n} pages) would leave only "
                    f"{avail} unpinned pages — too few for an admitted "
                    f"request needing {own}"
                )
        pages = [self.free_pages.pop() for _ in range(n)]
        self._register_prefix_pages(tokens[None, :],
                                    np.asarray(pages, np.int32))
        self._prefixes.append((tokens, pages))
        return aligned

    def release_prefix(self, tokens) -> None:
        """Unpin a registered prefix and return its pages to the pool.
        Raises while any resident request still shares the pages."""
        if not self.paged:
            raise ModelRuntimeError(
                "prefix caching requires ContinuousBatcher(paged=True)")
        tokens = np.asarray(tokens, np.float32).reshape(-1)
        aligned = tokens.size // self.page_size * self.page_size
        for i, (arr, pages) in enumerate(self._prefixes):
            if arr.size != aligned or not np.array_equal(
                    arr, tokens[:aligned]):
                continue
            held = set(pages)
            for slot in range(self.slots):
                if self._req[slot] is not None and held & set(
                        self.slot_pages[slot][:int(self._slot_pinned[slot])]):
                    raise ModelRuntimeError(
                        "prefix is in use by a resident request")
            # queued (and preempted-continuation) requests may have been
            # accepted counting on this prefix's pages
            del self._prefixes[i]
            avail = self.pool_pages - self._pinned_total()
            for req in self.queue:
                own = self._own_pages_needed(
                    req.tokens, req.max_new - len(req.out))
                if own > avail:
                    self._prefixes.insert(i, (arr, pages))
                    raise ModelRuntimeError(
                        "a queued request depends on this prefix's "
                        "pages; drain it before releasing"
                    )
            self.free_pages.extend(pages)
            return
        raise ModelRuntimeError("prefix is not registered")

    def submit(self, prompt, max_new: int, rid=None,
               temperature=None, top_k=None, top_p=None, stop_seq=None):
        """Queue a request; returns its id.  Admission happens inside
        ``step()`` when a slot frees up.

        ``stop_seq`` (a list of token ids) finishes this request once its
        emitted tail equals the sequence; it composes with the
        batcher-level ``stop_token``.  ``temperature``/``top_k``/``top_p``
        override the batcher-level sampling settings for this request (not
        in speculative mode, whose rejection scheme is built for the
        batcher-level temperature; lookup is exact greedy)."""
        if (self._spec
                and (temperature is not None or top_k is not None
                     or top_p is not None)):
            raise ModelRuntimeError(
                "per-request sampling overrides are not available in "
                "speculative mode (the rejection scheme is built for "
                "the batcher-level temperature; lookup is exact-greedy)")
        check_top_p(top_p)
        tokens = np.asarray(prompt, np.float32).reshape(-1)
        if tokens.size < 1:
            raise ModelRuntimeError("empty prompt")
        if max_new < 1:
            raise ModelRuntimeError(f"max_new must be >= 1 (got {max_new})")
        need = tokens.size + max_new - 1
        margin = ""
        if self._spec:
            # a verify round writes spec_k rows beyond the fed position
            need += self.spec_k
            margin = f" + spec_k {self.spec_k}"
        if need > self.capacity:
            raise ModelRuntimeError(
                f"prompt_len + max_new - 1{margin} = {need} exceeds cache "
                f"capacity {self.capacity}"
            )
        if need > self.server.max_seq:
            raise ModelRuntimeError(
                f"prompt_len + max_new - 1 = {need} exceeds the model's "
                f"max_seq {self.server.max_seq} position embeddings"
            )
        if self.paged:
            avail = self.pool_pages - self._pinned_total()
            own = self._own_pages_needed(tokens, int(max_new))
            if own > avail:
                raise ModelRuntimeError(
                    f"request needs {own} pages beyond any pinned-prefix "
                    f"reuse but only {avail} are unpinned "
                    f"({self.pool_pages} pool minus {self._pinned_total()} "
                    "pinned); even preempting every other request could "
                    "not fit it"
                )
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid if isinstance(rid, int)
                             else self._next_rid) + 1
        req = _Request(rid, tokens, int(max_new))
        req.stop_seq = _check_stop_seq(stop_seq, self.server.vocab)
        req.temp = float(self.temperature if temperature is None
                         else temperature)
        tk = top_k if top_k is not None else self.top_k
        if tk is not None and tk < 1:
            raise ModelRuntimeError(f"top_k must be >= 1 (got {tk})")
        req.top_k = int(self.server.vocab if tk is None else tk)
        tp = top_p if top_p is not None else self.top_p
        req.top_p = float(1.0 if tp is None else tp)
        self.queue.append(req)
        return rid

    def _bucket(self, width: int) -> int:
        # bucket widths never exceed the cache (a user bucket list may)
        return min(bucket_for(self.prompt_buckets, width), self.capacity)

    def _progress_admission(self, slot, allow_preempt: bool = False):
        """One admission unit for a reserved paged slot: a page-aligned
        prompt chunk (``prefill_chunk``), or the final ragged tail which
        prefills against everything cached so far and picks the first
        token.  Returns a finished (rid, tokens) pair when the first token
        already completes the request, else None (also when the unit must
        wait for free pages)."""
        req = self._req[slot]
        size = req.tokens.size
        chunk = self._admit_chunk()
        if chunk and size - req.consumed - 1 >= chunk:
            if (len(self.free_pages) < chunk // self.page_size
                    and not allow_preempt):
                return None  # wait for decoders to free pages
            self._alloc_pages(slot, chunk // self.page_size)
            new_pages = self.slot_pages[slot][-(chunk // self.page_size):]
            with _PrefillUnit(self, req, chunk, chunk, first=False):
                self._prefill_chunk(
                    req.tokens[None, req.consumed:req.consumed + chunk],
                    req.consumed, self.page_table[slot].copy(),
                    np.asarray(new_pages, np.int32))
            req.consumed += chunk
            # window models evict behind the band between chunks, which
            # keeps the prefill burst at O(window + chunk)
            self._evict_window_pages(slot, frontier=req.consumed)
            return None  # next chunk (or the tail) next step
        # final tail: 1..bucket tokens
        s = size - req.consumed
        width_s = self._bucket(s)
        n_own = self._pages_for(s)
        if len(self.free_pages) < n_own and not allow_preempt:
            return None  # wait for decoders to free pages
        self._alloc_pages(slot, n_own)
        own = self.slot_pages[slot][-n_own:]
        suffix = np.zeros((1, width_s), np.float32)
        suffix[0, :s] = req.tokens[req.consumed:]
        with _PrefillUnit(self, req, s, width_s, first=not req.out):
            first = int(self._admit_prefix(
                suffix, s, req.consumed, self.page_table[slot].copy(),
                np.asarray(own, np.int32), req.temp, req.top_k, req.top_p,
                slot))
        self._admitted += 1
        self.active[slot] = True
        self.pos[slot] = size
        self.last[slot] = float(first)
        self._evict_window_pages(slot)
        if self.draft is not None:
            self._admit_draft(slot)
        if self._emit(slot, first):
            return self._finish(slot)
        return None

    def _finish(self, slot) -> tuple:
        req = self._req[slot]
        req.finished_at = time.perf_counter()
        self._metrics.append({
            "rid": req.rid,
            "prompt_tokens": int(req.tokens.size) - req.absorbed,
            "generated_tokens": len(req.out),
            "ttft_s": req.first_token_at - req.submitted,
            "latency_s": req.finished_at - req.submitted,
            "preemptions": req.preempted,
            "queue_s": req.prefill_at - req.submitted,
            "prefill_s": req.prefill_s,
            "prefix_tokens": req.prefix_tokens,
        })
        self.active[slot] = False
        if self._pipe_draining and self._pipe:
            # dispatches in flight still write this slot's pages (their
            # page-table snapshots predate the finish): quarantine the slot
            # until the pipe drains, then release it
            self._pending_release.append(slot)
        else:
            self._req[slot] = None
            if self.paged:
                self._free_slot_pages(slot)
        return (req.rid, np.asarray(req.out, np.int64))

    def _evict_window_pages(self, slot, frontier=None) -> None:
        """Sliding-window models never attend positions at or below
        ``frontier - window`` (the slot's cursor, or mid-admission the
        tokens consumed), so pages wholly outside the band go back to the
        pool (their table entries become the trash page; the stale rows
        were window-masked already).  Pinned prefix pages stay.
        ``_evict_cursor`` remembers the first possibly-live index."""
        window = self.server.window
        if window is None:
            return
        if frontier is None:
            frontier = int(self.pos[slot])
        keep_from = int(frontier) - int(window) + 1
        pages = self.slot_pages[slot]
        idx = max(int(self._evict_cursor[slot]),
                  int(self._slot_pinned[slot]))
        while idx < len(pages) and (idx + 1) * self.page_size <= keep_from:
            pid = pages[idx]
            if pid:
                self.free_pages.append(pid)
                pages[idx] = 0
                self.page_table[slot, idx] = 0
                self._window_evicted += 1
            idx += 1
        self._evict_cursor[slot] = idx

    def _apply_tokens(self, slot, tokens, finished) -> int:
        """Advance a slot through emitted tokens (pos/last bookkeeping),
        finishing on budget or stop; returns how many were applied."""
        applied = 0
        for tok in tokens:
            tok = int(tok)
            self.pos[slot] += 1
            self.last[slot] = float(tok)
            applied += 1
            if self._emit(slot, tok):
                finished.append(self._finish(slot))
                break
        else:
            if self.paged and applied:
                self._evict_window_pages(slot)
        self._decode_tokens += applied
        return applied

    def _emit(self, slot, token: int) -> bool:
        """Record one generated token; True when the request is done."""
        req = self._req[slot]
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        req.out.append(token)
        if self.stream_tokens:
            self._stream.append((req.rid, token))
        if _stop_seq_hit(req):
            return True
        if self.stop_token is not None and token == self.stop_token:
            return True
        return len(req.out) >= req.max_new

    def _can_pipeline(self) -> bool:
        """Chunk dispatches may be issued ahead only in steady state: every
        resident slot decoding, nothing queued, nothing quarantined —
        admissions and preemptions need a drained pipe (they re-chain
        host-authoritative state)."""
        return (not self.queue and not self._pending_release
                and bool(self.active.any())
                and all(self.active[s] or self._req[s] is None
                        for s in range(self.slots)))

    def _chunk_fence(self, start, chunk: int):
        """Per-active-row absolute budget fence for a chunk dispatch whose
        rows start at ``start``, and each row's last written position
        inside the chunk span.  ``pos`` and ``len(out)`` advance in
        lockstep, so the fence is the same for every in-flight chunk of a
        request: the pipelined path's equality to the sequential one rests
        on both computing it here."""
        stop_at = start.copy()
        upto = {}
        for slot in range(self.slots):
            if self.active[slot]:
                req = self._req[slot]
                stop_at[slot] = self.pos[slot] + req.max_new - len(req.out)
                upto[slot] = int(min(int(start[slot]) + chunk,
                                     int(stop_at[slot]))) - 1
        return stop_at, upto

    def _issue_chunk(self, chunk: int) -> bool:
        """Issue one chunk dispatch chained on the previous one's
        device-side (tok, pos): uploads only, no read back.  Returns False
        (issuing nothing) when in-flight chunks already fence every active
        row's budget, or when the pool cannot cover the chunk span without
        preempting; the caller then takes the sequential path, which may
        preempt."""
        start = (self._shadow_pos if self._pipe else self.pos
                 ).astype(np.int32).copy()
        stop_at, upto = self._chunk_fence(start, chunk)
        if not any(int(stop_at[s]) > int(start[s])
                   for s in range(self.slots) if self.active[s]):
            return False  # all budget already covered in flight
        if self.paged:
            needed = sum(
                max(0, u // self.page_size + 1 - len(self.slot_pages[slot]))
                for slot, u in upto.items())
            if needed > len(self.free_pages):
                return False
            for slot, u in upto.items():
                self._ensure_pages_upto(slot, u)
            table = self.page_table.copy()
        else:
            table = np.zeros((self.slots, 1), np.int32)
        chained = bool(self._pipe)
        self._steps += chunk
        self._dispatches += 1
        pending = self._dispatch_chunk(stop_at, table, chained)
        # the kernel's rule: pos += 1 while pos < stop_at
        self._shadow_pos = np.minimum(
            start + chunk, np.maximum(start, stop_at)).astype(np.int32)
        self._pipe.append({"toks": pending, "start": start,
                           "stop_at": stop_at, "active": self.active.copy()})
        return True

    def _pipelined_chunk_step(self, finished, issue: bool = True):
        """Fill the pipe to ``1 + pipeline`` in-flight chunk dispatches,
        then drain the oldest (its tokens: stop detection, budgets,
        metrics).  Returns ``finished``, or None when nothing is in flight
        and steady state does not hold: the caller falls through to the
        sequential paths (admission, preemption, one dispatch)."""
        chunk = self.decode_chunk
        while (issue and self._can_pipeline()
               and len(self._pipe) < 1 + self.pipeline):
            if not self._issue_chunk(chunk):
                break
        if not self._pipe:
            return None
        entry = self._pipe.popleft()
        toks = entry["toks"].tokens()
        self._pipe_draining = True
        try:
            with tracing.span("egt.batcher.apply"):
                for slot in range(self.slots):
                    if not (entry["active"][slot] and self.active[slot]):
                        continue
                    taken = min(chunk, int(entry["stop_at"][slot])
                                - int(entry["start"][slot]))
                    self._apply_tokens(slot, toks[:taken, slot], finished)
        finally:
            self._pipe_draining = False
        if not self.active.any():
            # every row finished or was cancelled: no dispatch in flight
            # is needed, so wait them out now and release the quarantined
            # slots without further step() calls
            while self._pipe:
                self._pipe.popleft()["toks"].tokens()
        if not self._pipe:
            for slot in self._pending_release:
                self._req[slot] = None
                if self.paged:
                    self._free_slot_pages(slot)
            self._pending_release.clear()
            self._dev_tok = self._dev_pos = self._shadow_pos = None
        return finished

    def step(self):
        """One scheduler iteration: admit queued requests into free slots
        (prefill + first token each), then run one batched decode
        dispatch for every active slot (``decode_chunk`` steps).  Returns
        the ``(request_id, tokens)`` pairs that completed this
        iteration."""
        if not tracing.enabled():
            return self._step()
        admitted, self._rows = self._admitted, 0
        with tracing.span("egt.batcher.step") as sp:
            finished = self._step()
        if sp is not None:
            sp.attrs.update(admitted=self._admitted - admitted,
                            rows=self._rows)
        return finished

    def _step(self) -> list:
        finished = []
        if self._deferred_finished:
            finished.extend(self._deferred_finished)
            self._deferred_finished.clear()

        # 0) dispatches in flight while steady state broke (a submission
        # arrived, or a finished slot is quarantined): drain before any
        # admission, which the device-chained dispatches would not see
        if self._pipe and not self._can_pipeline():
            self._pipelined_chunk_step(finished)
            return finished

        # 1) reserve free slots for queued requests
        with tracing.span("egt.batcher.admit"):
            self._reserve_slots(finished)

        # 1b) progress paged admissions one unit each (a prompt chunk, or
        # the final tail which picks the first token).  Admission waits
        # for free pages rather than stealing from decoders — except that
        # when nothing is active, the first reserved slot may preempt
        # other reserved slots so the system always makes progress.
        if self.paged:
            privileged = None
            if not self.active.any():
                for slot in range(self.slots):
                    if self._req[slot] is not None:
                        privileged = slot
                        break
            for slot in range(self.slots):
                if self._req[slot] is None or self.active[slot]:
                    continue
                done = self._progress_admission(
                    slot, allow_preempt=(slot == privileged))
                if done is not None:
                    finished.append(done)

        # 2) a speculative round: the draft (or the host's lookup match)
        # proposes, the target verifies, each slot advances by its own
        # accepted count plus one
        if self.active.any() and self._spec:
            self._spec_step(finished)
            return finished

        # 2a) pipelined chunks: keep `pipeline` more chunk dispatches in
        # flight (chained on the device), drain the oldest
        if self.pipeline and self.active.any():
            res = self._pipelined_chunk_step(finished)
            if res is not None:
                return res

        # 2b) one chunk dispatch for the whole slot batch
        if self.active.any() and self.decode_chunk > 1:
            self._chunk_step(finished)
            return finished

        # 2c) one decode step for the whole slot batch
        if self.active.any():
            self._steps += 1
            self._dispatches += 1
            if self.paged:
                wpid, woff = self._decode_pages()
            with self._dispatch_span(1):
                nxt = (self._decode_paged(wpid, woff) if self.paged
                       else self._decode())
            with tracing.span("egt.batcher.readback"):
                nxt = nxt.cpu().numpy()
            with tracing.span("egt.batcher.apply"):
                for slot in range(self.slots):
                    if self.active[slot]:
                        self._apply_tokens(slot, nxt[slot:slot + 1],
                                           finished)
        return finished

    def _reserve_slots(self, finished) -> None:
        """Reserve free slots for queued requests: a paged slot takes the
        longest registered prefix its prompt starts with; a dense slot
        prefills its prompt and picks the first token at once."""
        for slot in range(self.slots):
            if not self.queue:
                break
            if self.active[slot] or self._req[slot] is not None:
                continue
            req = self.queue.popleft()
            self._req[slot] = req
            self.req_temp[slot] = req.temp
            self.req_topk[slot] = req.top_k
            self.req_topp[slot] = req.top_p
            if self.paged:
                pre_len, pre_pages = self._match_prefix(req.tokens)
                req.consumed = req.prefix_tokens = pre_len
                if pre_len:
                    self._prefix_hits += 1
                pages = list(pre_pages or [])
                self.slot_pages[slot] = pages
                self._slot_pinned[slot] = len(pages)
                self.page_table[slot, :] = 0
                self.page_table[slot, :len(pages)] = pages
            else:
                size = req.tokens.size
                width = self._bucket(size)
                prompt = np.zeros((1, width), np.float32)
                prompt[0, :size] = req.tokens
                with _PrefillUnit(self, req, size, width, first=not req.out):
                    first = int(self._admit(prompt, size, slot, req.temp,
                                            req.top_k, req.top_p))
                self._admitted += 1
                self.active[slot] = True
                self.pos[slot] = size
                self.last[slot] = float(first)
                if self.draft is not None:
                    self._admit_draft(slot)
                if self._emit(slot, first):
                    finished.append(self._finish(slot))

    def _decode_pages(self):
        """Pages for each active row's next position (which may preempt),
        and where a decode step writes each row's K/V: (page ids,
        offsets)."""
        for slot in range(self.slots):
            if self.active[slot]:
                self._ensure_pages_upto(slot, int(self.pos[slot]))
        wpid = np.zeros(self.slots, np.int32)  # 0 = trash page
        woff = np.zeros(self.slots, np.int32)
        for slot in range(self.slots):
            if self.active[slot]:
                p = int(self.pos[slot])
                wpid[slot] = self.slot_pages[slot][p // self.page_size]
                woff[slot] = p % self.page_size
        return wpid, woff

    def _chunk_step(self, finished) -> None:
        """One chunk dispatch, read back at once: pages for every row's
        whole chunk span first (which may preempt), then the fence, then
        each active row's tokens up to its fence."""
        chunk = self.decode_chunk
        if self.paged:
            _, upto = self._chunk_fence(self.pos.copy(), chunk)
            for slot, u in upto.items():
                if self.active[slot]:  # an ensure may preempt mid-loop
                    self._ensure_pages_upto(slot, u)
        # after the pages: a preempted row is parked (fence = pos), so the
        # dispatch never writes its freed pages
        stop_at, _ = self._chunk_fence(self.pos.copy(), chunk)
        table = (self.page_table.copy() if self.paged
                 else np.zeros((self.slots, 1), np.int32))
        self._steps += chunk
        self._dispatches += 1
        toks = self._dispatch_chunk(stop_at, table, chained=False).tokens()
        with tracing.span("egt.batcher.apply"):
            for slot in range(self.slots):
                if not self.active[slot]:
                    continue
                taken = min(chunk, int(stop_at[slot]) - int(self.pos[slot]))
                self._apply_tokens(slot, toks[:taken, slot], finished)

    def _spec_step(self, finished) -> None:
        """Dispatch one speculative round and apply each active slot's
        accepted tokens (one read back of the round's tokens and counts)."""
        k = self.spec_k
        wpid = np.zeros((self.slots, k + 1), np.int32)  # 0 = trash page
        woff = np.zeros((self.slots, k + 1), np.int32)
        if self.paged:
            for slot in range(self.slots):
                if self.active[slot]:  # may preempt other slots
                    self._ensure_pages_upto(slot, int(self.pos[slot]) + k)
            for slot in range(self.slots):
                if self.active[slot]:
                    p = int(self.pos[slot]) + np.arange(k + 1)
                    wpid[slot] = [self.slot_pages[slot][i]
                                  for i in p // self.page_size]
                    woff[slot] = p % self.page_size
        self._dispatches += 1
        self._spec_rounds += 1
        with self._dispatch_span(k + 1):
            if self.draft is not None:
                emit, accept = self._spec_round(wpid, woff)
            else:
                emit, accept = self._lookup_round(wpid, woff)
        with tracing.span("egt.batcher.readback"):
            host = torch.cat([emit, accept[:, None]], dim=1).cpu().numpy()
        with tracing.span("egt.batcher.apply"):
            for slot in range(self.slots):
                if not self.active[slot]:
                    continue
                take = int(host[slot, k + 1]) + 1
                self._steps += take
                self._spec_emitted += self._apply_tokens(
                    slot, host[slot, :take], finished)

    def run(self) -> dict:
        """Drive ``step()`` until every queued and active request is done;
        returns ``{request_id: np.ndarray of generated tokens}``."""
        out = {}
        while (self.queue or self.active.any()
               or any(r is not None for r in self._req)
               or self._deferred_finished or self._pipe):
            for rid, toks in self.step():
                out[rid] = toks
        return out

    def cancel(self, rid) -> bool:
        """Abort a request (client disconnect): drop it from the queue, or
        free its slot and pages at once if resident (after draining the
        dispatches in flight, which still write them).  Returns whether
        anything was cancelled; finished requests return False.
        Cancelled requests produce no result and no metrics record."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                return True
        for slot in range(self.slots):
            req = self._req[slot]
            if req is not None and req.rid == rid:
                if self._pipe:
                    # requests that finish during this drain surface on
                    # the next step()
                    while self._pipe:
                        self._pipelined_chunk_step(
                            self._deferred_finished, issue=False)
                    if self._req[slot] is None or self._req[slot].rid != rid:
                        return False  # finished during the drain
                self.active[slot] = False
                self._req[slot] = None
                if self.paged:
                    self._free_slot_pages(slot)
                return True
        return False

    def drain_tokens(self) -> list:
        """Tokens emitted since the last drain, in emission order, as
        ``(request_id, token_id)`` pairs — the hook for streaming
        responses token by token.  Requires ``stream_tokens=True``."""
        if not self.stream_tokens:
            raise ModelRuntimeError(
                "token streaming is off; construct with "
                "ContinuousBatcher(..., stream_tokens=True)")
        out = self._stream
        self._stream = []
        return out

    def request_metrics(self, reset: bool = False) -> list:
        """Per-finished-request records, in completion order: request id,
        prompt/generated token counts, time to first token (``ttft_s``:
        submit to first emitted token), total ``latency_s``, how often
        the request was preempted, ``queue_s`` (submit to the start of its
        first prefill unit: the wait for a slot and behind the step's
        other admissions), ``prefill_s`` (wall seconds of its prefill
        units until the first token, each ended by its read back) and
        ``prefix_tokens`` (prompt tokens a registered prefix covered).
        ``reset=True`` drains the list."""
        out = list(self._metrics)
        if reset:
            self._metrics.clear()
        return out  # bounded FIFO: at most the newest 4096 records

    @property
    def stats(self) -> dict:
        """Scheduler counters: decode iterations run and occupancy now;
        ``prefill_tokens`` (true prompt tokens prefilled, again after a
        preemption), ``prefill_padded_tokens`` (bucket width minus those,
        prefilled as padding) and ``decode_tokens`` (tokens the decode
        dispatches emitted; a request's first token, and a preempted
        one's next, are admission's); ``skinny_launches`` and
        ``skinny_declined`` (``ops.matmul``'s weight products of at most
        32 rows on the weight-streaming kernel, and those it sent to
        torch, since this batcher was built: every such product of the
        process, a chunk graph's replays counting what they ran)."""
        out = {
            "decode_steps": self._steps,
            "dispatches": self._dispatches,
            "active": int(self.active.sum()),
            "queued": len(self.queue),
            "prefill_tokens": self._prefill_tokens,
            "prefill_padded_tokens": self._prefill_padded,
            "decode_tokens": self._decode_tokens,
            "skinny_launches": matmul.skinny_launches - self._skinny0[0],
            "skinny_declined": matmul.skinny_declined - self._skinny0[1],
        }
        if self._spec:
            out["spec_rounds"] = self._spec_rounds
            out["spec_emitted"] = self._spec_emitted
        if self.paged:
            out["free_pages"] = len(self.free_pages)
            out["pool_pages"] = self.pool_pages
            out["preemptions"] = self._preempts
            out["window_evicted"] = self._window_evicted
            out["prefixes"] = len(self._prefixes)
            out["prefix_hits"] = self._prefix_hits
        if self._recurrent:
            out.update(self._hybrid_stats())
        return out

    def _hybrid_stats(self) -> dict:
        """A hybrid model's ``FlashLMServer.counts`` since this batcher
        was built: what its steps ran, and any other call on the same
        server meanwhile (read without waiting for the card: exact once
        it is idle)."""
        now = self.server.counts()
        return {k: n - self._counts0[k] for k, n in now.items()}


class Seq2SeqBatcher:
    """Continuous batching for encoder-decoder serving
    (:class:`~exprgrad_torch.models.Seq2SeqServer`): the scheduler's
    seq2seq sibling.

    Each request is encoded once at admission (right-padded to the
    shared ``max_src`` width, its pad positions masked by the server's
    ``kv_mask``), and its encoder memory, cross K/V and mask are written
    into the slot's rows of per-slot tensors.  Decoding then runs one
    step for the whole slot batch with per-row cursors on the decoder's
    self-attention caches (``ops.decode.append_at`` and position
    masking), :class:`ContinuousBatcher`'s mechanism.  The caches are
    dense (no page pool).  Greedy streams equal
    ``Seq2SeqServer.generate`` on each source alone; sampling settings
    are per request, every draw from one ``torch.Generator`` seeded with
    ``seed``.

    ``lookup=True`` makes each dispatch a draft-free verify round:
    ``spec_k`` proposals a slot from an ngram match of the slot's last
    emitted tokens over its source and generation (the copy regime of
    translation and summarization), verified in one ``spec_k + 1``-wide
    step; exact greedy only.
    """

    def __init__(self, server, slots: int = 8, max_src=None,
                 capacity=None, temperature: float = 0.0, top_k=None,
                 top_p=None, stop_token=None, bos: int = 0, seed: int = 0,
                 stream_tokens: bool = False, lookup: bool = False,
                 spec_k: int = 4, lookup_ngram: int = 2):
        check_top_p(top_p)
        if lookup:
            if temperature != 0.0 or top_k is not None or top_p is not None:
                raise ModelRuntimeError(
                    "lookup speculation is exact-greedy only (no "
                    "proposal distribution for a rejection scheme)")
            if lookup_ngram < 1:
                raise ModelRuntimeError(
                    f"lookup_ngram must be >= 1 (got {lookup_ngram})")
        if spec_k < 1:  # stored unconditionally: validate unconditionally
            raise ModelRuntimeError(f"spec_k must be >= 1 (got {spec_k})")
        self.lookup = bool(lookup)
        self.spec_k = int(spec_k)
        self.lookup_ngram = int(lookup_ngram)
        self.server = server
        self.device = server.device
        self.slots = int(slots)
        self.max_src = int(max_src or server.max_src)
        if self.max_src > server.max_src:
            raise ModelRuntimeError(
                f"max_src {self.max_src} exceeds the model's "
                f"{server.max_src} source positions")
        self.capacity = int(capacity or server.max_tgt)
        if self.capacity > server.max_tgt:
            raise ModelRuntimeError(
                f"capacity {self.capacity} exceeds the model's max_tgt "
                f"{server.max_tgt} target positions")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stop_token = stop_token
        self.bos = int(bos)
        self.stream_tokens = bool(stream_tokens)
        self._stream: list[tuple] = []
        self._row_pick = make_row_picker(server.vocab)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        n_dec = len(server.dec)
        h, hd, dim = server.heads, server.head_dim, server.dim
        dtype = server.p["src.embed"].dtype
        self.enc_mem = torch.zeros((self.slots, self.max_src, dim),
                                   dtype=dtype, device=self.device)
        self.enc_ck = [torch.zeros((self.slots, h, self.max_src, hd),
                                   dtype=dtype, device=self.device)
                       for _ in range(n_dec)]
        self.enc_cv = [torch.zeros_like(ck) for ck in self.enc_ck]
        self.enc_mask = torch.zeros((self.slots, self.max_src),
                                    dtype=torch.bool, device=self.device)
        self.caches = server.init_caches(self.slots, self.capacity)

        self.pos = np.zeros(self.slots, np.int32)
        self.last = np.full(self.slots, float(bos), np.float32)
        self.active = np.zeros(self.slots, bool)
        self.req_temp = np.zeros(self.slots, np.float32)
        self.req_topk = np.full(self.slots, server.vocab, np.int32)
        self.req_topp = np.ones(self.slots, np.float32)
        self._req: list = [None] * self.slots
        self.queue: deque = deque()
        self._next_rid = 0
        self._steps = 0
        self._dispatches = 0
        self._spec_rounds = 0
        self._spec_emitted = 0
        self._metrics: deque = deque(maxlen=4096)

    def _dev(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- device work ---------------------------------------------------
    def _admit(self, src, length: int, slot: int) -> None:
        """Encode a [1, max_src] padded source and write its memory, cross
        K/V and validity mask into the slot's rows (in place)."""
        enc = self.server.encode(src, lengths=[length])
        self.enc_mem[slot] = enc.memory[0]
        for big, one in zip(self.enc_ck, enc.ck):
            big[slot] = one[0]
        for big, one in zip(self.enc_cv, enc.cv):
            big[slot] = one[0]
        self.enc_mask[slot] = enc.kv_mask[0]

    def _enc(self):
        from .seq2seq_serve import _Enc

        return _Enc(self.enc_mem, tuple(self.enc_ck), tuple(self.enc_cv),
                    self.enc_mask)

    def _decode(self):
        """One decode step for every slot: per-row cursor positions on
        the decoder self-caches, cross-attention against the slot's
        encoder state, per-request sampling."""
        pos = self._dev(self.pos)
        logits, self.caches = self.server._step(
            self._dev(self.last)[:, None], self._enc(), self.caches,
            q_pos=pos[:, None], key_pos=_cursor_key_pos(self.capacity, pos),
            row_starts=pos)
        return self._row_pick(logits[:, -1], self._gen, self.req_temp,
                              self.req_topk, self.req_topp)

    def _lookup_props(self, slot) -> np.ndarray:
        """Lookup proposals over SOURCE + generation: the last emitted
        ngram is matched against the source too, so copy-heavy outputs
        propose straight from the source text.  An inactive slot
        proposes zeros."""
        req = self._req[slot]
        if req is None or not self.active[slot]:
            return np.zeros(self.spec_k, np.int64)
        hist = np.concatenate([req.tokens.astype(np.int64),
                               np.asarray(req.out, np.int64)])
        return lookup_propose(hist, self.spec_k, self.lookup_ngram)

    def _lookup_round(self):
        """A draft-free verify round for the whole slot batch: the host's
        proposals ride in as data, the decoder verifies all
        ``spec_k + 1`` positions in one forward (per-row cursors and
        position masking: rejected rows' K/V are overwritten by the next
        round's writes, no rewind), greedy acceptance counts come back.
        The encoder state is read-only throughout."""
        k = self.spec_k
        props = self._dev(np.stack([self._lookup_props(s)
                                    for s in range(self.slots)]))
        tok = self._dev(self.last)
        pos = self._dev(self.pos)
        seq = torch.cat([tok[:, None], props.to(tok.dtype)], dim=1)
        qp = pos[:, None] + torch.arange(k + 1, dtype=pos.dtype,
                                         device=pos.device)[None, :]
        logits, self.caches = self.server._step(
            seq, self._enc(), self.caches, q_pos=qp,
            key_pos=_cursor_key_pos(self.capacity, pos, k), row_starts=pos)
        return _greedy_accept(logits, props, k)

    # -- public API ----------------------------------------------------
    def submit(self, src, max_new: int, rid=None, temperature=None,
               top_k=None, top_p=None, stop_seq=None):
        """Queue a source sequence; returns its id.  Per-request sampling
        overrides and ``stop_seq`` as on :class:`ContinuousBatcher`."""
        check_top_p(top_p)
        tokens = np.asarray(src, np.float32).reshape(-1)
        if tokens.size < 1:
            raise ModelRuntimeError("empty source")
        if tokens.size > self.max_src:
            raise ModelRuntimeError(
                f"source length {tokens.size} exceeds max_src "
                f"{self.max_src}")
        if max_new < 1:
            raise ModelRuntimeError(f"max_new must be >= 1 (got {max_new})")
        margin = self.spec_k if self.lookup else 0
        if max_new + margin > self.capacity:
            extra = f" + spec_k {margin}" if margin else ""
            raise ModelRuntimeError(
                f"max_new {max_new}{extra} exceeds target capacity "
                f"{self.capacity}")
        if self.lookup and (temperature is not None or top_k is not None
                            or top_p is not None):
            raise ModelRuntimeError(
                "per-request sampling overrides are not available in "
                "lookup mode (exact greedy only)")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid if isinstance(rid, int)
                             else self._next_rid) + 1
        req = _Request(rid, tokens, int(max_new))
        req.stop_seq = _check_stop_seq(stop_seq, self.server.vocab)
        req.temp = float(self.temperature if temperature is None
                         else temperature)
        tk = top_k if top_k is not None else self.top_k
        if tk is not None and tk < 1:
            raise ModelRuntimeError(f"top_k must be >= 1 (got {tk})")
        req.top_k = int(self.server.vocab if tk is None else tk)
        tp = top_p if top_p is not None else self.top_p
        req.top_p = float(1.0 if tp is None else tp)
        self.queue.append(req)
        return rid

    def cancel(self, rid) -> bool:
        """Abort a queued or resident request; returns whether anything
        was cancelled (a cancelled request gives no result)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                return True
        for slot in range(self.slots):
            req = self._req[slot]
            if req is not None and req.rid == rid:
                self.active[slot] = False
                self._req[slot] = None
                return True
        return False

    def _emit(self, slot, token: int) -> bool:
        """Record one generated token; True when the request is done."""
        req = self._req[slot]
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        req.out.append(token)
        if self.stream_tokens:
            self._stream.append((req.rid, token))
        if _stop_seq_hit(req):
            return True
        if self.stop_token is not None and token == self.stop_token:
            return True
        return len(req.out) >= req.max_new

    def _advance(self, slot, tokens, finished) -> int:
        """Advance a slot through emitted tokens (pos/last bookkeeping,
        finish on budget or stop); returns how many were applied."""
        applied = 0
        for tok in tokens:
            tok = int(tok)
            self.pos[slot] += 1
            self.last[slot] = float(tok)
            applied += 1
            if self._emit(slot, tok):
                finished.append(self._finish(slot))
                break
        return applied

    def _finish(self, slot):
        req = self._req[slot]
        req.finished_at = time.perf_counter()
        self._metrics.append({
            "rid": req.rid,
            "prompt_tokens": int(req.tokens.size),
            "generated_tokens": len(req.out),
            "ttft_s": req.first_token_at - req.submitted,
            "latency_s": req.finished_at - req.submitted,
            "preemptions": 0,
        })
        self.active[slot] = False
        self._req[slot] = None
        return (req.rid, np.asarray(req.out, np.int64))

    def step(self):
        """One scheduler iteration: encode-admit queued requests into
        free slots, then one batched decode step (or one lookup verify
        round); returns the completed ``(rid, tokens)`` pairs."""
        finished = []
        for slot in range(self.slots):
            if not self.queue:
                break
            if self.active[slot]:
                continue
            req = self.queue.popleft()
            src = np.zeros((1, self.max_src), np.float32)
            src[0, :req.tokens.size] = req.tokens
            self._admit(src, req.tokens.size, slot)
            self._req[slot] = req
            self.active[slot] = True
            self.pos[slot] = 0
            self.last[slot] = float(self.bos)
            self.req_temp[slot] = req.temp
            self.req_topk[slot] = req.top_k
            self.req_topp[slot] = req.top_p

        if self.active.any() and self.lookup:
            self._dispatches += 1
            self._spec_rounds += 1
            greedy, accept = self._lookup_round()
            k = self.spec_k
            host = torch.cat([greedy, accept[:, None]], dim=1).cpu().numpy()
            for slot in range(self.slots):
                if not self.active[slot]:
                    continue
                take = int(host[slot, k + 1]) + 1
                self._steps += take
                self._spec_emitted += self._advance(
                    slot, host[slot, :take], finished)
            return finished

        if self.active.any():
            self._steps += 1
            self._dispatches += 1
            nxt = self._decode().cpu().numpy()
            for slot in range(self.slots):
                if self.active[slot]:
                    self._advance(slot, [int(nxt[slot])], finished)
        return finished

    def run(self) -> dict:
        """Drive ``step()`` until every queued and active request is done;
        returns ``{request_id: np.ndarray of generated tokens}``."""
        out = {}
        while self.queue or self.active.any():
            for rid, toks in self.step():
                out[rid] = toks
        return out

    def drain_tokens(self) -> list:
        """Tokens emitted since the last drain, as ``(request_id,
        token_id)`` pairs.  Requires ``stream_tokens=True``."""
        if not self.stream_tokens:
            raise ModelRuntimeError(
                "token streaming is off; construct with "
                "Seq2SeqBatcher(..., stream_tokens=True)")
        out = self._stream
        self._stream = []
        return out

    def request_metrics(self, reset: bool = False) -> list:
        """Per-finished-request records (ids, token counts, ``ttft_s``,
        ``latency_s``), in completion order; ``reset=True`` drains."""
        out = list(self._metrics)
        if reset:
            self._metrics.clear()
        return out

    @property
    def stats(self) -> dict:
        """Scheduler counters: decode iterations run and occupancy now."""
        out = {
            "decode_steps": self._steps,
            "dispatches": self._dispatches,
            "active": int(self.active.sum()),
            "queued": len(self.queue),
        }
        if self.lookup:
            out["spec_rounds"] = self._spec_rounds
            out["spec_emitted"] = self._spec_emitted
        return out
