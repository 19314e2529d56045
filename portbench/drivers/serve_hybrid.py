"""Open-loop serving of a hybrid Jamba model through ``ContinuousBatcher``
over ``FlashLMServer``.

The window, the end-to-end summary, the sample of the check and the
warm-up traffic are ``serve_open``'s.  What is this module's own: the
build (``models.jamba.jamba_lm`` from the configuration's ``build``),
the seeded weights in the program's order (the assumptions of the
configuration's ``assumed``), the arithmetic of the traced slice (the
FLOPs each handed-over token activated, its routed experts only, and the
bytes and operations of the Mamba kernels it ran, ``flops_hybrid``), the
counters of the two hybrid metrics, and the check: the widest gap by
which a served token's reference logit lies below the reference's best
at that position, over the sample, with the reference's K/V rounded to
the cache's bfloat16 and its state in float32 (``reference/jamba.py``);
the control reads the same gap with the tokens the reference computed in
TF32 puts first.
"""

from __future__ import annotations

import contextlib
import gc
import math

import numpy as np
import torch

from .. import flops_hybrid, weights
from ..harness import TraceSlice, device_line, mark, reference_for
from . import serve_open


def layout(cfg: dict) -> list:
    return reference_for(cfg).layout(cfg)


def groups(cfg: dict) -> list:
    """(name, shape, leaf indices) of each group of leaves of one name and
    shape, in first-seen order (drawn together, one stream each)."""
    out: dict = {}
    for i, (name, shape) in enumerate(layout(cfg)):
        out.setdefault((name, shape), []).append(i)
    return [(n, sh, idx) for (n, sh), idx in out.items()]


def draw_group(cfg: dict, seed: int, g: int, device) -> torch.Tensor:
    """Group ``g``'s stacked leaves: gains and D 1, the conv's and the
    head's biases 0, a_log ``log(1..d_state)``, the step bias softplus^-1
    of steps log-uniform in [0.001, 0.1], every other leaf uniform with
    the configuration's ``initializer_range`` as its standard deviation."""
    name, shape, idx = groups(cfg)[g]
    full = (len(idx),) + tuple(shape)
    f32 = dict(dtype=torch.float32, device=device)
    if name.endswith(("rms.g", "_norm")) or name == "mamba.d":
        return torch.ones(full, **f32)
    if name in ("bias", "mamba.conv_b"):
        return torch.zeros(full, **f32)
    if name == "mamba.a_log":
        a = torch.log(torch.arange(1, shape[1] + 1, **f32))
        return a.expand(full).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.stream_seed(seed, "jamba", g))
    out = torch.empty(full, **f32)
    if name == "mamba.dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(out.uniform_(lo, hi, generator=gen))
        return dt + torch.log(-torch.expm1(-dt))
    half = cfg["initializer_range"] * 3 ** 0.5
    return out.uniform_(-half, half, generator=gen)


def make(cfg: dict, seed: int, device) -> list:
    """Every leaf, in ``layout`` order (views of the stacked groups)."""
    leaves: list = [None] * len(layout(cfg))
    for g, (_, _, idx) in enumerate(groups(cfg)):
        for i, leaf in zip(idx, draw_group(cfg, seed, g, device).unbind(0)):
            leaves[i] = leaf
    return leaves


def build(ctx):
    """The program under test: (model, server, batcher)."""
    # a program without ``models.jamba`` fails here, before any work
    from exprgrad_torch.models.jamba import jamba_lm

    import exprgrad_torch as egt
    from exprgrad_torch.model import Model
    from exprgrad_torch.models import ContinuousBatcher, FlashLMServer

    mark(ctx, "import exprgrad_torch")
    cfg = ctx.config
    source = egt.to_program(jamba_lm(**cfg["build"]), schedule_scope="cpu")
    mark(ctx, "program")
    model = Model(source, init_params=False, precision="highest",
                  device=ctx.device)
    mark(ctx, "model")
    prog = model.program
    have = [(prog.tensors[t].name, tuple(prog.tensors[t].shape))
            for t in prog.params]
    if have != layout(cfg):
        raise SystemExit(f"the program's parameters {have[:4]}... are not "
                         f"the configuration's layout {layout(cfg)[:4]}...")
    model.params = dict(zip(prog.params, make(cfg, ctx.seed, ctx.device)))
    mark(ctx, "weights")
    server = FlashLMServer(model)
    batcher = ContinuousBatcher(server, stream_tokens=True,
                                **ctx.workload["batcher"])
    mark(ctx, "server")
    return model, server, batcher


def setup(ctx):
    """Build the program and warm it (``serve_open.setup``'s warm-up: every
    prompt bucket the traffic reaches and the decode chunk's graph)."""
    wl, traffic = ctx.workload, ctx.workload["traffic"]
    model, server, batcher = build(ctx)
    warm = serve_open.generator(wl).warmup(
        {**traffic, "decode_chunk": wl["batcher"].get("decode_chunk", 1)},
        ctx.seed, ctx.config["vocab_size"],
        serve_open.buckets(traffic["prompt_min"], traffic["prompt_max"]))
    for r in warm:
        batcher.submit(r["prompt"], r["max_new"])
    batcher.run()
    batcher.drain_tokens()
    batcher.request_metrics(reset=True)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    mark(ctx, "warm-up")
    return model, server, batcher


class Tally:
    """The arithmetic ``serve_open.window`` asks of its ``flops`` module
    for each token handed over in the traced slice, for a hybrid: the
    FLOPs the token activated, and, beside them, the operations and bytes
    its rows added to the Mamba kernels' launches (a prompt's row at its
    bucket's width, a decode row at width 1)."""

    def __init__(self, cfg: dict, buckets):
        self.s = flops_hybrid.sizes(cfg)
        self.buckets = buckets
        self.scan_ops = 0
        self.scan_bytes = 0

    def sizes(self, cfg):
        return self.s

    def _rows(self, tokens: int, width: int) -> None:
        ops, nbytes = flops_hybrid.row_cost(self.s, tokens, width)
        self.scan_ops += self.s["mamba_layers"] * ops
        self.scan_bytes += self.s["mamba_layers"] * nbytes

    def prefill_flops(self, s, prompt: int) -> int:
        width = next((w for w in self.buckets if w >= prompt), prompt)
        self._rows(prompt, width)
        return flops_hybrid.prefill_flops(s, prompt)

    def decode_flops(self, s, context: int) -> int:
        self._rows(1, 1)
        return flops_hybrid.decode_flops(s, context)


@contextlib.contextmanager
def hybrid_arithmetic(tally: Tally):
    """``serve_open.window`` with ``tally`` as its ``flops`` module."""
    saved = serve_open.flops
    serve_open.flops = tally
    try:
        yield
    finally:
        serve_open.flops = saved


def run(ctx):
    cfg, wl = ctx.config, ctx.workload
    model, server, batcher = setup(ctx)
    reqs = serve_open.generator(wl).generate(wl["traffic"], ctx.seed,
                                             ctx.seconds, cfg["vocab_size"])
    T = float(ctx.seconds)
    sl = TraceSlice(torch) if ctx.trace else None
    traffic = wl["traffic"]
    tally = Tally(cfg, serve_open.buckets(traffic["prompt_min"],
                                          traffic["prompt_max"]))
    ctx.setup_done()
    with hybrid_arithmetic(tally):
        w = serve_open.window(ctx, batcher, reqs, T, sl)
    clock, rec, stats = w["clock"], w["rec"], w["stats"]
    e2e, done, failed = serve_open.summary(reqs, clock, T)
    counters = {
        "submit_lag_ms": w["submit_lag_ms"],
        "slice_step_s": rec["step_s"], "slice_flops": rec["flops"],
        "b7_contexts": rec["b7_contexts"],
        "scan_ops": tally.scan_ops, "scan_bytes": tally.scan_bytes,
        "scan_launch_bytes": flops_hybrid.launch_bytes(tally.s),
        "moe_routed_rows": stats.get("moe_routed_rows", 0),
        "moe_computed_rows": stats.get("moe_computed_rows", 0),
    }
    gen = np.array([len(o) for o in clock.out])
    device = device_line(torch, ctx.chips,
                         sl.trace if sl is not None else None)

    # -- correct: the sample against the plain reference ----------------
    pick = serve_open.sample(ctx.seed, reqs, clock, done, wl["check"])
    del model, server, batcher
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    seqs = [(reqs[i]["prompt"], clock.out[i]) for i in pick]
    gap, margin = logit_gap(cfg, ctx.seed, ctx.device, seqs)
    limit = wl["limits"]["logit_gap"]
    correct = failed == 0 and gap <= limit
    return {"correct": bool(correct), "attempted": len(reqs),
            "failed": failed, "e2e": e2e,
            "compared": {"logit_gap": (gap, limit)},
            "device": device, "trace": sl.trace if sl else None,
            "counters": counters, "check": {"seqs": seqs}, "notes": {
                "checked_requests": len(pick),
                "checked_tokens": int(sum(len(clock.out[i]) for i in pick)),
                "served_tokens": int(gen.sum()),
                "routing_margin_min": margin,
                "window_stats": {k: int(v) for k, v in stats.items()}}}


def logit_gap(cfg, seed, device, seqs, tf32: bool = False):
    """(widest gap, over every served position of ``seqs`` [(prompt,
    served)], between the reference's best logit and the served token's;
    the smallest relative margin, over the checked tokens and MoE layers,
    between the router's 2nd and 3rd probabilities, where rounding could
    swap an expert).  With ``tf32`` the served tokens are those the
    reference computed in TF32 puts first (the control)."""
    reference = reference_for(cfg)
    w = reference.Weights(cfg, make(cfg, seed, device))
    kv = getattr(torch, cfg.get("kv_cache_dtype", "float32"))
    worst, margin = 0.0, math.inf
    with reference.precision(False), torch.no_grad():
        for prompt, served in seqs:
            seq = np.concatenate([np.asarray(prompt),
                                  np.asarray(served[:-1])])
            toks = torch.as_tensor(seq, dtype=torch.long, device=device)
            rows = slice(len(prompt) - 1, len(seq))
            routes: list = []
            ref = reference.forward(w, toks[None], kv, probs=routes)[0][rows]
            for p in routes:
                top = torch.sort(p[0], dim=-1, descending=True).values
                margin = min(margin, float(((top[:, 1] - top[:, 2])
                                            / top[:, 1]).min()))
            if tf32:
                with reference.precision(True):
                    top = reference.forward(w, toks[None], kv)[0][rows]
                judged = top.argmax(dim=-1)
            else:
                judged = torch.as_tensor(served, dtype=torch.long,
                                         device=device)
            best = ref.max(dim=-1).values
            got = ref.gather(1, judged[:, None])[:, 0]
            worst = max(worst, float((best - got).max()))
    return worst, margin


def control(ctx, out) -> dict:
    """The control's reading on the run's checked sequences: the gap of
    the tokens the reference computed in TF32 puts first."""
    gap, _ = logit_gap(ctx.config, ctx.seed, ctx.device,
                       out["check"]["seqs"], tf32=True)
    return {"control": {"logit_gap": gap}}
