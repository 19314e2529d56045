"""Open-loop serving through ``ContinuousBatcher`` over ``FlashLMServer``.

Set-up builds the model's program, gives it the seeded weights, builds
the server and the batcher from the workload's settings, and warms every
prompt bucket the traffic reaches and the decode chunk's graph.  The
window then submits each request when it comes due and calls ``step()``
while there is work, on one thread; every token is timestamped by this
clock when ``step()`` hands it over.  Requests due in the window are
finished after it closes; the rates count only what was done inside it.

``correct``: a sample of the finished requests drawn from the seed (the
longest among them) is run once through the plain reference (prompt
and served tokens, K/V rounded to the cache's bfloat16); the number
compared is the widest gap by which a served token's reference logit
lies below the reference's best at that position.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from .. import flops, weights
from ..harness import (TraceSlice, device_line, mark, percentile,
                       reference_for, span)

# the profiled slice's length, and how long requests due in the window
# may take to finish after it closes
TRACE_SECONDS = 8.0
DRAIN_SECONDS = 120.0


def build(ctx):
    """The program under test: (model, server, batcher)."""
    import exprgrad_torch as egt
    from exprgrad_torch.model import Model
    from exprgrad_torch.models import ContinuousBatcher, FlashLMServer

    mark(ctx, "import exprgrad_torch")
    cfg = ctx.config
    source = egt.to_program(egt.models.flash_transformer(**cfg["build"]),
                            schedule_scope="cpu")
    mark(ctx, "program")
    model = Model(source, init_params=False, precision="highest",
                  device=ctx.device)
    mark(ctx, "model")
    give_weights(model, cfg, ctx.seed, ctx.device)
    mark(ctx, "weights")
    server = FlashLMServer(model, eps=cfg["rms_norm_eps"])
    batcher = ContinuousBatcher(server, stream_tokens=True,
                                **ctx.workload["batcher"])
    mark(ctx, "server")
    return model, server, batcher


def give_weights(model, cfg, seed, device) -> None:
    """Hand the seeded leaves to the program, checking its parameters'
    names and shapes against the configuration's layout."""
    prog = model.program
    have = [(prog.tensors[t].name, tuple(prog.tensors[t].shape))
            for t in prog.params]
    want = weights.layout(cfg)
    if have != want:
        raise SystemExit(f"the program's parameters {have[:4]}... are not "
                         f"the configuration's layout {want[:4]}...")
    model.params = dict(zip(prog.params, weights.make(cfg, seed, device)))


def buckets(lo: int, hi: int) -> list[int]:
    """Powers of two from the bucket of ``lo`` to that of ``hi`` (the
    batcher's ``pow2`` prompt buckets)."""
    out, w = [], 1
    while w < hi:
        w *= 2
        if w >= lo:
            out.append(w)
    return out or [hi]


class Clock:
    """Per-request times on the benchmark's clock (seconds after the
    window opened)."""

    def __init__(self, reqs):
        n = len(reqs)
        self.due = np.array([r["due"] for r in reqs])
        self.max_new = [r["max_new"] for r in reqs]
        self.submit = np.full(n, np.nan)
        self.first = np.full(n, np.nan)
        self.last = np.full(n, np.nan)
        self.out = [[] for _ in range(n)]
        self.times = [[] for _ in range(n)]


def drain(batcher, clock, rid_index, now, on_token) -> int:
    """Stamp the tokens ``step()`` handed over; returns how many requests
    they finished."""
    finished = 0
    for rid, tok in batcher.drain_tokens():
        i = rid_index[rid]
        if not clock.out[i]:
            clock.first[i] = now
        clock.last[i] = now
        clock.out[i].append(int(tok))
        clock.times[i].append(now)
        on_token(i, len(clock.out[i]) - 1)
        finished += len(clock.out[i]) == clock.max_new[i]
    return finished


def setup(ctx):
    """Build the program and warm it: every prompt bucket the traffic
    reaches and the decode chunk's graph.  Returns (model, server,
    batcher)."""
    wl, traffic = ctx.workload, ctx.workload["traffic"]
    s = flops.sizes(ctx.config)
    model, server, batcher = build(ctx)
    warm = generator(wl).warmup(
        {**traffic, "decode_chunk": wl["batcher"].get("decode_chunk", 1)},
        ctx.seed, s["vocab"],
        buckets(traffic["prompt_min"], traffic["prompt_max"]))
    for r in warm:
        batcher.submit(r["prompt"], r["max_new"])
    batcher.run()
    batcher.drain_tokens()
    batcher.request_metrics(reset=True)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    mark(ctx, "warm-up")
    return model, server, batcher


def generator(wl):
    return importlib.import_module(f"portbench.generators.{wl['generator']}")


def window(ctx, batcher, reqs, T: float, sl=None, waiting=None) -> dict:
    """Offer ``reqs`` open loop for ``T`` seconds and finish those due in
    it.  ``sl`` profiles a slice; ``waiting`` (a list) gets ``(seconds,
    requests queued)`` after each ``step()``.  Returns the clock, the
    batcher's counters over the window and the slice's record."""
    wl = ctx.workload
    s = flops.sizes(ctx.config)
    stats0 = dict(batcher.stats)
    clock = Clock(reqs)
    rid_index = {}
    slice_at = (T * wl["trace_from"], T * wl["trace_from"] + TRACE_SECONDS)
    # what the slice's steps did: wall seconds, model flops, B7 contexts
    rec = {"step_s": [], "flops": 0, "b7_contexts": [], "steps": 0}
    prompts = [len(r["prompt"]) for r in reqs]

    def on_token(i, j):
        if not (sl and sl.active):
            return
        if j == 0:
            rec["flops"] += flops.prefill_flops(s, prompts[i])
        else:
            rec["flops"] += flops.decode_flops(s, prompts[i] + j)
            rec["b7_contexts"].append(prompts[i] + j)

    t0 = time.perf_counter()
    nxt, outstanding = 0, 0
    deadline = T + DRAIN_SECONDS
    while True:
        now = time.perf_counter() - t0
        while nxt < len(reqs) and reqs[nxt]["due"] <= now:
            with span("portbench.submit", bool(sl and sl.active)):
                rid = batcher.submit(reqs[nxt]["prompt"],
                                     reqs[nxt]["max_new"])
            rid_index[rid] = nxt
            clock.submit[nxt] = time.perf_counter() - t0
            nxt += 1
            outstanding += 1
        if sl is not None and not sl.started and now >= slice_at[0]:
            sl.start()
        if sl is not None and sl.active and now >= slice_at[1]:
            sl.stop()
        if outstanding:
            a = time.perf_counter()
            with span("portbench.step", bool(sl and sl.active)):
                batcher.step()
            b = time.perf_counter()
            n_before = rec["flops"]
            outstanding -= drain(batcher, clock, rid_index, b - t0,
                                 on_token)
            if sl is not None and sl.active and rec["flops"] > n_before:
                rec["step_s"].append(b - a)
                rec["steps"] += 1
            if waiting is not None:
                waiting.append((b - t0, batcher.stats["queued"]))
        elif nxt >= len(reqs):
            break
        else:
            time.sleep(min(5e-4, max(0.0, reqs[nxt]["due"] - now)))
        if now > deadline:
            break
    if sl is not None and sl.active:
        sl.stop()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    stats1 = dict(batcher.stats)
    if sl is not None:
        sl.finish()
    # a traced run's slice slows the loop, and a backlog it leaves lasts:
    # the lag is read over the requests due before the slice
    due = np.array([r["due"] for r in reqs])
    lag = (clock.submit - clock.due) * 1e3
    if sl is not None:
        lag = lag[due < slice_at[0]]
    return {"clock": clock, "rec": rec, "submit_lag_ms": lag, "stats": {
        k: stats1[k] - stats0.get(k, 0) for k in stats1
        if isinstance(stats1[k], (int, np.integer))}}


def summary(reqs, clock, T: float) -> tuple[dict, np.ndarray, int]:
    """(end-to-end metrics, which requests finished, failed count)."""
    done = np.array([len(o) == r["max_new"] for o, r in zip(clock.out, reqs)])
    gen = np.array([len(o) for o in clock.out])
    # work inside the window: prompts whose first token came in it, and
    # generated tokens handed over in it
    in_window = 0
    for i, r in enumerate(reqs):
        if clock.first[i] <= T:
            in_window += len(r["prompt"])
        in_window += sum(t <= T for t in clock.times[i])
    ok = done & (gen > 1)
    ttft = (clock.first - clock.due)[done] * 1e3
    tpot = ((clock.last - clock.first)[ok] / (gen[ok] - 1)) * 1e3
    e2e = {"ttft_p95_ms": percentile(ttft, 95) if ttft.size else None,
           "tpot_p95_ms": percentile(tpot, 95) if tpot.size else None,
           "serve_tokens_per_s": in_window / T,
           "ttft_p50_ms": percentile(ttft, 50) if ttft.size else None,
           "tpot_p50_ms": percentile(tpot, 50) if tpot.size else None}
    return e2e, done, int((~done).sum())


def run(ctx):
    cfg, wl = ctx.config, ctx.workload
    model, server, batcher = setup(ctx)
    reqs = generator(wl).generate(wl["traffic"], ctx.seed, ctx.seconds,
                                  flops.sizes(cfg)["vocab"])
    T = float(ctx.seconds)
    sl = TraceSlice(torch) if ctx.trace else None
    ctx.setup_done()
    w = window(ctx, batcher, reqs, T, sl)
    clock, rec = w["clock"], w["rec"]
    e2e, done, failed = summary(reqs, clock, T)
    counters = {
        "submit_lag_ms": w["submit_lag_ms"],
        "slice_step_s": rec["step_s"], "slice_flops": rec["flops"],
        "b7_contexts": rec["b7_contexts"],
    }
    gen = np.array([len(o) for o in clock.out])
    device = device_line(torch, ctx.chips,
                         sl.trace if sl is not None else None)

    # -- correct: the sample against the plain reference ----------------
    pick = sample(ctx.seed, reqs, clock, done, wl["check"])
    del model, server, batcher
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    seqs = [(reqs[i]["prompt"], clock.out[i]) for i in pick]
    gap = logit_gap(cfg, ctx.seed, ctx.device, seqs)
    limit = wl["limits"]["logit_gap"]
    compared = {"logit_gap": (gap, limit)}
    correct = failed == 0 and gap <= limit
    return {"correct": bool(correct), "attempted": len(reqs),
            "failed": failed, "e2e": e2e, "compared": compared,
            "device": device, "trace": sl.trace if sl else None,
            "counters": counters, "check": {"seqs": seqs}, "notes": {
                "checked_requests": len(pick),
                "checked_tokens": int(sum(len(clock.out[i]) for i in pick)),
                "served_tokens": int(gen.sum())}}


def sample(seed, reqs, clock, done, check) -> list[int]:
    """Finished requests to check: the longest (prompt plus served),
    then others drawn from the seed until ``check["tokens"]`` served
    tokens are covered or ``check["requests"]`` are taken."""
    idx = [i for i in range(len(reqs)) if done[i]]
    if not idx:
        return []
    size = lambda i: len(reqs[i]["prompt"]) + len(clock.out[i])  # noqa
    longest = max(idx, key=size)
    rng = np.random.default_rng([int(seed), 0xc4ec])
    pick, tokens = [longest], len(clock.out[longest])
    for i in rng.permutation(idx):
        if len(pick) >= check["requests"] or tokens >= check["tokens"]:
            break
        if i != longest:
            pick.append(int(i))
            tokens += len(clock.out[i])
    return pick


def logit_gap(cfg, seed, device, seqs, tf32: bool = False) -> float:
    """Widest gap, over every served position of ``seqs`` ([(prompt,
    served)]), between the reference's best logit and the served
    token's.  With ``tf32`` the served tokens are those the reference
    computed in TF32 puts first (the control)."""
    reference = reference_for(cfg)
    w = reference.Weights(cfg, weights.make(cfg, seed, device))
    kv = getattr(torch, cfg.get("kv_cache_dtype", "float32"))
    worst = 0.0
    with reference.precision(False):
        for prompt, served in seqs:
            ref, top = served_logits(reference, w, prompt, served, kv,
                                     device, tf32)
            best = ref.max(dim=-1).values
            got = ref.gather(1, top[:, None])[:, 0]
            worst = max(worst, float((best - got).max()))
    return worst


def served_logits(reference, w, prompt, served, kv, device, tf32: bool):
    """(reference logits at the positions that chose each served token,
    the tokens judged: the served ones, or TF32's argmax there)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])
    toks = torch.as_tensor(seq, dtype=torch.long, device=device)
    rows = slice(len(prompt) - 1, len(seq))
    ref = reference.logits(w, toks, kv)[rows]
    if tf32:
        with reference.precision(True):
            top = reference.logits(w, toks, kv)[rows].argmax(dim=-1)
    else:
        top = torch.as_tensor(served, dtype=torch.long, device=device)
    return ref, top


def control(ctx, out) -> dict:
    """The control's reading on the run's checked sequences: the gap of
    the tokens the reference computed in TF32 puts first."""
    return {"control": {"logit_gap": logit_gap(
        ctx.config, ctx.seed, ctx.device, out["check"]["seqs"], tf32=True)}}
