"""Training steps through the DSL: ``Model.apply("train")``.

Set-up builds the model's program, gives it the seeded weights and zero
optimizer state, and drives that same model through its first three
steps (the window's own call on the window's feed; each step's rows
differ), reading for the check each step's loss (the program's ``loss``
target on the step's batch, before the step), the first gradient as
Adam got it (its first moment after one step over ``1 - beta1``) and,
after three, each leaf's change.  The window then runs further steps on
the same model until ``--seconds`` have passed, and a synchronize ends
it.

``correct``: once the program is freed, the plain reference (float32,
TF32 off, autograd, Adam) follows the same three steps from the same
weights and batches; ``readings`` gives the numbers compared, each
beside its limit.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from .. import flops, weights
from ..harness import TraceSlice, device_line, mark, reference_for, span
from .serve_open import give_weights

CHECK_STEPS = 3
TRACE_STEPS = 2  # steps in a traced run's profiled slice


def build(ctx):
    import exprgrad_torch as egt
    from exprgrad_torch.model import Model

    mark(ctx, "import exprgrad_torch")
    cfg = ctx.config
    source = egt.to_program(egt.models.flash_transformer(**cfg["build"]),
                            schedule_scope="cpu")
    mark(ctx, "program")
    model = Model(source, init_params=False, precision="highest",
                  device=ctx.device)
    mark(ctx, "model")
    give_weights(model, cfg, ctx.seed, ctx.device)
    prog = model.program
    model.caches = {t: torch.zeros(tuple(prog.tensors[t].shape),
                                   dtype=torch.float32, device=ctx.device)
                    for t in prog.caches}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    mark(ctx, "weights")
    return model


def first_moments(model) -> list:
    """Adam's first moment of each parameter, in parameter order (the
    program creates ``adam.m`` then ``adam.v`` per parameter)."""
    prog = model.program
    ms = [t for t in prog.caches if prog.tensors[t].name == "adam.m"]
    if len(ms) != len(prog.params):
        raise SystemExit("the program's optimizer state is not adam's")
    return [model.caches[t] for t in ms]


def changes(cfg, seed, device, now) -> list[float]:
    """Each leaf's ``||now - initial||``, the initial weights drawn again
    a group at a time."""
    out = [0.0] * len(now)
    for g, (_, _, idx) in enumerate(weights.groups(cfg)):
        init = weights.draw_group(cfg, seed, g, device)
        for k, i in enumerate(idx):
            out[i] = float(torch.linalg.vector_norm(now[i] - init[k]))
        del init
    return out


def leaf_gaps(got, ref) -> np.ndarray:
    """Each leaf's ``|got - ref| / max(ref, median ref)``."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    return np.abs(got - ref) / np.maximum(ref, np.median(ref))


def readings(got: dict, ref: dict) -> tuple[dict, dict]:
    """The numbers compared, of a run ``got`` against the reference's
    ``ref``, and others read beside them.  Compared: the first step's
    loss, the worst leaf's first gradient and the worst leaf's change
    after three steps.  Read beside: the worst step's loss, which the
    later steps' round-off moves (PERF.md), which leaf's change is the
    worst, and the smallest leaf's reference gradient as a share of the
    median leaf's (a leaf whose gradient is round-off would move by
    round-off alone under Adam: none is)."""
    change = leaf_gaps(got["change_norms"], ref["change_norms"])
    compared = {
        "loss1_gap": abs(got["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "grad_norm_gap": float(leaf_gaps(got["grad_norms"],
                                         ref["grad_norms"]).max()),
        "change_norm_gap": float(change.max()),
    }
    beside = {
        "loss_gap": float(np.max(np.abs(np.subtract(got["losses"],
                                                    ref["losses"]))
                                 / np.abs(ref["losses"]))),
        "change_worst_leaf": int(np.argmax(change)),
        "grad_min_share": float(np.min(ref["grad_norms"])
                                / np.median(ref["grad_norms"])),
    }
    return compared, beside


def run(ctx):
    cfg, wl = ctx.config, ctx.workload
    s = flops.sizes(cfg)
    tr = wl["traffic"]
    rows, seq = int(tr["sequences"]), int(tr["seq_len"])
    model = build(ctx)
    feed = importlib.import_module(
        f"portbench.generators.{wl['generator']}").Batches(
        tr, ctx.seed, s["vocab"], ctx.device)
    beta1 = 0.9

    prog_losses, grad_norms = [], None
    for step in range(1, CHECK_STEPS + 1):
        args = feed.args(step)
        prog_losses.append(float(np.asarray(model.call("loss", args))[0]))
        model.epoch = step
        model.apply("train", args)
        if step == 1:
            grad_norms = [float(torch.linalg.vector_norm(m)) / (1 - beta1)
                          for m in first_moments(model)]
        mark(ctx, f"check step {step}")
    prog = model.program
    change_norms = changes(cfg, ctx.seed, ctx.device,
                           [model.params[t] for t in prog.params])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    mark(ctx, "changes")

    sl = TraceSlice(torch) if ctx.trace else None
    trace_at = wl["trace_from"] * ctx.seconds
    host_s, step, traced = [], CHECK_STEPS + 1, 0
    ctx.setup_done()
    t0 = time.perf_counter()
    while True:
        if sl is not None and not sl.started \
                and time.perf_counter() - t0 >= trace_at:
            sl.start()
        args = feed.args(step)
        model.epoch = step
        a = time.perf_counter()
        with span("portbench.apply", bool(sl and sl.active)):
            model.apply("train", args)
        host_s.append(time.perf_counter() - a)
        step += 1
        if sl is not None and sl.active:
            traced += 1
            if traced == TRACE_STEPS:
                sl.stop()
        if time.perf_counter() - t0 >= ctx.seconds \
                and not (sl is not None and sl.active):
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    steps = len(host_s)
    if sl is not None:
        sl.finish()
    e2e = {"train_tokens_per_s": steps * rows * seq / window}
    counters = {"host_ms_per_step": 1e3 * float(np.mean(host_s)),
                "steps": steps, "window_s": window,
                "model_flops": steps * flops.train_flops(s, rows, seq),
                "batch": rows, "seq": seq, "traced_steps": traced}
    device = device_line(torch, ctx.chips,
                         sl.trace if sl is not None else None)

    # -- correct: the reference follows the first three steps -----------
    del model, prog, args
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cfg, ctx.seed, ctx.device, feed)
    got = {"losses": prog_losses, "grad_norms": grad_norms,
           "change_norms": change_norms}
    read, beside = readings(got, ref)
    compared = {k: (v, wl["limits"][k]) for k, v in read.items()}
    correct = all(v <= lim for v, lim in compared.values())
    return {"correct": bool(correct), "attempted": steps + CHECK_STEPS,
            "failed": 0, "e2e": e2e, "compared": compared,
            "device": device, "trace": sl.trace if sl else None,
            "counters": counters, "check": {"got": got, "ref": ref},
            "notes": {"losses": prog_losses, "ref_losses": ref["losses"],
                      **beside}}


def reference_steps(cfg, seed, device, feed, tf32=False,
                    tokens_kept=None) -> dict:
    """The reference's three steps from the seeded weights on the same
    batches: each step's loss, the first gradient's norm by leaf, and
    each leaf's change after the three.  ``tf32`` computes it in TF32
    (the control); ``tokens_kept`` trains on the first that many tokens
    of each row (a fault: part of the batch left out)."""
    reference = reference_for(cfg)
    params: list = [None] * len(weights.layout(cfg))
    for g, (_, _, idx) in enumerate(weights.groups(cfg)):
        group = weights.draw_group(cfg, seed, g, device)
        for k, i in enumerate(idx):
            params[i] = group[k].clone().requires_grad_(True)
        del group
    w = reference.Weights(cfg, params)
    opt = reference.Adam(params, eta=cfg["build"].get("eta", 0.005))
    losses, grad_norms = [], None
    with reference.precision(tf32):
        for step in range(1, CHECK_STEPS + 1):
            ids = feed.tokens(step)
            if tokens_kept is not None:
                ids = ids[:, :tokens_kept + 1]
            loss = reference.loss(w, ids[:, :-1], ids[:, 1:])
            grads = torch.autograd.grad(loss, params)
            losses.append(loss.item())
            if step == 1:
                grad_norms = [float(torch.linalg.vector_norm(g))
                              for g in grads]
            opt.step(grads)
            del grads, loss
    change_norms = changes(cfg, seed, device, [p.detach() for p in params])
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms}


def control(ctx, out) -> dict:
    """Readings of the control (the reference in TF32) and of a planted
    fault (each row's second half left out, the mean over the rest),
    each in the program's place against the run's reference."""
    wl, ref = ctx.workload, out["check"]["ref"]
    feed = importlib.import_module(
        f"portbench.generators.{wl['generator']}").Batches(
        wl["traffic"], ctx.seed, flops.sizes(ctx.config)["vocab"],
        ctx.device)
    seq = int(wl["traffic"]["seq_len"])
    out = {}
    for name, kw in (("control", {"tf32": True}),
                     ("half_batch", {"tokens_kept": seq // 2})):
        got = reference_steps(ctx.config, ctx.seed, ctx.device, feed, **kw)
        compared, beside = readings(got, ref)
        out[name] = {**compared, "loss_gap": beside["loss_gap"]}
    return out
