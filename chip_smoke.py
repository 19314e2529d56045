"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, train.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. build the port's CUDA kernels from exprgrad_torch/csrc;
2. hold the flash-attention kernels (forward; backward dq and dkv)
   against their plain PyTorch versions on the card at the serving shape
   and at GQA, window, rectangular, offset, dead-row and bfloat16
   shapes, and time them at the serving shape;
3. compile the serving model flash_transformer(vocab=2048, dim=512,
   heads=4, hidden=2048, blocks=2, max_seq=256) and drive the main path
   once: "predict" on [8, 256] tokens, then 8 requests of 128-token
   prompts for 128 new tokens through FlashLMServer, greedy and sampled.
   The kernel must launch exactly twice in that run (both in predict:
   decoding attends through plain torch, as in the JAX package), the
   rows must be finite distributions, the result must match the same
   model on the CPU, and the token ids must lie in the vocabulary;
4. time predict and greedy generation, check the server's forward
   against predict on the same tokens, and check that predict at a
   200-token length, which the JAX package routes to plain attention,
   still launches the kernel;
5. train the same model on 32 sequences of 256 tokens: two
   apply("train") steps, which must launch the forward, dq and dkv
   kernels exactly twice each per step and agree with the same steps of
   the CPU port; fit for a few epochs (the loss on the first batch must
   fall); one scan_batches epoch against a per-batch epoch from the same
   state; a checkpoint written from the card must predict the same on
   the CPU; and the time of a train step.

It needs a CUDA device and the rest of the repository; without either
it fails.  The last line of output is a JSON object naming the device.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances of the kernel against its plain version.  float32: both sum
# in float32 in different orders.  bfloat16: both compute in float32 from
# the same bfloat16 inputs and round the output once, so they differ by
# at most about one bfloat16 step (2^-7 relative) of the output.
F32_OUT = dict(rtol=1e-4, atol=1e-5)
F32_LSE_ATOL = 1e-4
BF16_OUT = dict(rtol=2e-2, atol=2e-2)
BF16_LSE_ATOL = 1e-3
# Tolerances of the backward kernels against their plain version.
# float32: dq sums up to 256 kv rows and dk/dv up to 1024 (query rows of
# a GQA group) of products in another order than the plain einsums, and
# the kernels take P from the saved lse where the plain version takes a
# fresh softmax; gradients here are of order 1 to 10.  bfloat16: both
# compute in float32 from the same bfloat16 inputs and round each
# gradient once, about one bfloat16 step (2^-7 relative).
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
BF16_GRAD = dict(rtol=2e-2, atol=2e-2)
# The train step on the card against the CPU port, float32 (TF32 off) on
# both.  One step of plain gradient descent agrees closely (on an H100:
# the loss to 2e-6 relative, each parameter to 5e-5), but adam divides
# each gradient entry by its own running magnitude: an entry within
# float32 rounding of 0 can take either sign, and its parameter then
# moves by +eta or -eta (eta = 0.005), and small entries carry their
# rounding into the update as eta * error / |g|.  After two steps on 8.5M
# parameters more than 5e5 entries differ by more than 1e-4, some by
# 0.017.  So the check holds the whole update, not each entry: the
# difference of the two models' parameters, in L2 norm over all of them,
# within 10% of the norm of the update the steps made; and the loss
# within 1e-3.
TRAIN_UPDATE_RTOL = 0.1
TRAIN_LOSS = dict(rtol=1e-3, atol=0.0)
# predict on the card against predict on the CPU (float32 both ways)
PREDICT = dict(rtol=1e-4, atol=1e-6)

SERVING = dict(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
               max_seq=256)
BATCH, SEQ, PROMPT, NEW = 8, 256, 128, 128
TRAIN_SEQS, TRAIN_EPOCHS, TIMED_STEPS = 32, 3, 5


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean milliseconds per call by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, out_tol, lse_atol) -> float:
    """Assert kernel == plain within tolerance; returns max |out error|."""
    (out, lse), (ref_out, ref_lse) = got, want
    torch.testing.assert_close(out.float(), ref_out.float(), **out_tol,
                               msg=lambda m: f"{name} out: {m}")
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse), dead), f"{name}: dead rows differ"
    torch.testing.assert_close(lse[~dead], ref_lse[~dead], rtol=0,
                               atol=lse_atol,
                               msg=lambda m: f"{name} lse: {m}")
    err = (out.float() - ref_out.float()).abs().max().item()
    diff = (lse[~dead] - ref_lse[~dead]).abs()
    lse_err = diff.max().item() if diff.numel() else 0.0
    print(f"kernel check {name}: max |out err| {err:.3e}, "
          f"max |lse err| {lse_err:.3e}, {int(dead.sum())} dead rows")
    return err


def compare_grads(name, got, want, tol, lse) -> tuple:
    """Assert kernel (dq, dk, dv) == plain within tolerance, no NaN, and
    dq = 0 on dead rows; returns (max |dq err|, max |dk, dv err|)."""
    errs = []
    for part, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), f"{name} {part}: not finite"
        torch.testing.assert_close(a.float(), b.float(), **tol,
                                   msg=lambda m: f"{name} {part}: {m}")
        errs.append((a.float() - b.float()).abs().max().item())
    dq = got[0]
    dead = torch.isneginf(lse).reshape(dq.shape[:3])
    assert torch.all(dq[dead] == 0), f"{name}: dq of a dead row is not 0"
    print(f"kernel check {name} backward: max |dq err| {errs[0]:.3e}, "
          f"|dk err| {errs[1]:.3e}, |dv err| {errs[2]:.3e}, "
          f"{int(dead.sum())} dead rows with dq 0")
    return errs[0], max(errs[1], errs[2])


def lm_data(rng, vocab, n, t):
    """Cyclic +1 sequences with random phase, labels the next token
    one-hot (examples/flash_lm.py)."""
    phase = rng.integers(0, vocab, n)
    toks = (phase[:, None] + np.arange(t)[None, :]) % vocab
    labels = np.eye(vocab, dtype=np.float32)[(toks + 1) % vocab]
    return {"tokens": toks.astype(np.float32), "labels": labels}


def update_err(params, ref, start) -> tuple:
    """(|params - ref| / |ref - start| in L2 norm over every parameter,
    max elementwise |params - ref|): how far apart two runs of the same
    steps from ``start`` ended, against how far the steps moved."""
    diff = moved = 0.0
    worst = 0.0
    for tid, value in ref.items():
        value = value.double().cpu()
        d = params[tid].double().cpu() - value
        diff += float((d * d).sum())
        moved += float(((value - start[tid].double().cpu()) ** 2).sum())
        worst = max(worst, float(d.abs().max()))
    return (diff / moved) ** 0.5, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    from exprgrad_torch.io import load_model, save_model
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    from exprgrad_torch.ops import attention
    from exprgrad_torch.utils import kernels

    gpu = gpu_line()
    dev = torch.device("cuda")
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{kernels.library_path()} (host of {gpu})")
    if kernels.build_log.strip():
        print(kernels.build_log.strip())

    # 2. kernel against its plain version -------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(b, h, hkv, sq, skv, d, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, h, sq, d), (b, hkv, skv, d),
                              (b, hkv, skv, d))]

    cases = [
        ("serving [8,4,256,128] f32 causal", qkv(8, 4, 4, 256, 256, 128),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("gqa h4/hkv1 causal", qkv(2, 4, 1, 256, 256, 128),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("window 64", qkv(2, 4, 2, 256, 256, 128),
         dict(causal=True, window=64), F32_OUT, F32_LSE_ATOL),
        ("non-causal sq 128, skv 320", qkv(2, 4, 4, 128, 320, 128),
         dict(), F32_OUT, F32_LSE_ATOL),
        ("ragged sq 100, d 64", qkv(2, 2, 2, 100, 100, 64),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("offsets (192, 0)", qkv(2, 4, 2, 64, 256, 128),
         dict(causal=True, offsets=(192, 0)), F32_OUT, F32_LSE_ATOL),
        ("offsets (0, 16) window 8", qkv(2, 4, 2, 64, 64, 128),
         dict(causal=True, offsets=(0, 16), window=8), F32_OUT,
         F32_LSE_ATOL),
        ("dead shard offsets (0, 512)", qkv(1, 4, 4, 64, 64, 128),
         dict(causal=True, offsets=(0, 512)), F32_OUT, F32_LSE_ATOL),
        ("serving shape bf16 causal",
         qkv(8, 4, 4, 256, 256, 128, torch.bfloat16),
         dict(causal=True), BF16_OUT, BF16_LSE_ATOL),
    ]
    slice_err = None
    for name, (q, k, v), kw, out_tol, lse_atol in cases:
        got = attention.flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention.attention_forward_plain(q, k, v, **kw)
        err = compare(name, got, want, out_tol, lse_atol)
        if slice_err is None:
            slice_err = err

    q, k, v = cases[0][1]
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = (attention.attention_forward_plain if which == "plain"
              else attention.flash_attention_forward)
        times[which].append(cuda_ms(lambda: fn(q, k, v, causal=True)))
    kernel_ms = sum(times["kernel"]) / 2
    plain_ms = sum(times["plain"]) / 2
    print(f"flash fwd [8,4,256,128] f32 causal: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (runs {times}) on {gpu}")

    # the backward kernels against their plain version, on the forward
    # kernel's (out, lse) as the train step hands them over
    bwd_err = None
    for name, (q, k, v), kw, _, _ in cases:
        tol = F32_GRAD if q.dtype == torch.float32 else BF16_GRAD
        out, lse = attention.flash_attention_forward(q, k, v, **kw)
        g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = attention.flash_attention_backward(q, k, v, out, lse, g, **kw)
        torch.cuda.synchronize()
        want = attention.attention_backward_plain(q, k, v, out, lse, g, **kw)
        err = compare_grads(name, got, want, tol, lse)
        if bwd_err is None:
            bwd_err = err

    q, k, v = cases[0][1]
    out, lse = attention.flash_attention_forward(q, k, v, causal=True)
    g = torch.randn(q.shape, generator=gen, device=dev)
    _, delta = attention.flash_bwd_dq(q, k, v, out, lse, g, causal=True)
    bwd_times = {"plain": [], "dq": [], "dkv": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            bwd_times["plain"].append(cuda_ms(
                lambda: attention.attention_backward_plain(
                    q, k, v, out, lse, g, causal=True)))
            continue
        bwd_times["dq"].append(cuda_ms(
            lambda: attention.flash_bwd_dq(q, k, v, out, lse, g,
                                           causal=True)))
        bwd_times["dkv"].append(cuda_ms(
            lambda: attention.flash_bwd_dkv(q, k, v, lse, delta, g,
                                            causal=True)))
    dq_ms = sum(bwd_times["dq"]) / 2
    dkv_ms = sum(bwd_times["dkv"]) / 2
    plain_bwd_ms = sum(bwd_times["plain"]) / 2
    print(f"flash bwd [8,4,256,128] f32 causal: dq {dq_ms:.4f} ms, "
          f"dkv {dkv_ms:.4f} ms, plain backward (dq, dk, dv) "
          f"{plain_bwd_ms:.4f} ms (runs {bwd_times}) on {gpu}")

    # 3. predict through the compiled model ----------------------------
    graph = flash_transformer(**SERVING)
    model = egt.compile(graph, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SERVING["vocab"], (BATCH, SEQ)).astype(
        np.float32)

    # the main path: one predict call and two generate calls, as a user
    # makes them; the counter must show the kernel ran inside it
    server = FlashLMServer(model)
    prompts = tokens[:, :PROMPT]
    attention.launches = 0
    t0 = time.perf_counter()
    probs = model.call("predict", {"tokens": tokens})
    first_ms = (time.perf_counter() - t0) * 1e3
    predict_launches = attention.launches
    greedy = server.generate(prompts, n_new=NEW)
    sampled = server.generate(prompts, n_new=NEW, temperature=0.8, top_k=50,
                              seed=0)
    torch.cuda.synchronize()
    launches = attention.launches
    print(f"main path: flash kernel launches {launches} "
          f"({predict_launches} in predict)")
    assert predict_launches == 2, predict_launches
    assert launches == 2, launches

    stats = model.lowering_stats("predict")
    assert stats.get("attention-impl:flash") == 2, stats
    assert probs.shape == (BATCH, SEQ, SERVING["vocab"]), probs.shape
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=0, atol=1e-4)
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        assert out.shape == (BATCH, NEW), (name, out.shape)
        ids = out.cpu().numpy()
        assert np.all((ids >= 0) & (ids < SERVING["vocab"])), name
        assert np.array_equal(ids, np.round(ids)), name

    t0 = time.perf_counter()
    for _ in range(5):
        model.call("predict", {"tokens": tokens})
    predict_ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"predict [{BATCH},{SEQ}]: {predict_ms:.2f} ms warm, "
          f"{first_ms:.2f} ms first call; lowering {stats} on {gpu}")

    cpu_model = egt.compile(graph, seed=0, device="cpu")
    for tid, value in model.params.items():
        assert torch.equal(value.cpu(), cpu_model.params[tid]), tid
    cpu_probs = cpu_model.call("predict", {"tokens": tokens})
    predict_err = float(np.abs(probs - cpu_probs).max())
    np.testing.assert_allclose(probs, cpu_probs, **PREDICT)
    print(f"predict vs the CPU port: max |err| {predict_err:.3e}")

    # 4. serve -----------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = server.generate(prompts, n_new=NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert torch.equal(again, greedy), "greedy generate is not repeatable"
    print(f"generate {BATCH}x{PROMPT} -> {NEW} greedy (bf16 cache): "
          f"{gen_s:.3f} s, {BATCH * NEW / gen_s:.1f} tokens/s on {gpu}")

    # the server's forward against predict on the same tokens
    server32 = FlashLMServer(model, cache_dtype=torch.float32)
    logits, _ = server32.prefill(tokens, server32.init_caches(BATCH))
    serve_probs = torch.softmax(logits, dim=-1).cpu().numpy()
    np.testing.assert_allclose(serve_probs, probs, rtol=1e-4, atol=1e-5)
    # greedy continuation against re-running predict on the grown window
    few = server32.generate(prompts[:2], n_new=4).cpu().numpy()
    window = prompts[:2].copy()
    for i in range(4):
        nxt = model.call("predict", {"tokens": window})[:, -1].argmax(-1)
        assert np.array_equal(few[:, i], nxt), (i, few[:, i], nxt)
        window = np.concatenate([window, nxt[:, None].astype(np.float32)],
                                axis=1)
    print("serve checks: prefill matches predict, greedy matches predict")

    # a length the TPU kernels' block rule sends to plain attention: on
    # the port "auto" still launches the kernel, once per block
    before = attention.launches
    ragged = model.call("predict", {"tokens": tokens[:2, :200]})
    assert attention.launches - before == 2, attention.launches - before
    np.testing.assert_allclose(ragged, probs[:2, :200], **PREDICT)
    print("ragged predict [2,200]: 2 kernel launches, matches predict")

    # 5. train -------------------------------------------------------------
    data = lm_data(np.random.default_rng(0), SERVING["vocab"], TRAIN_SEQS,
                   SEQ)
    first = {name: value[:BATCH] for name, value in data.items()}
    assert model.epoch == cpu_model.epoch == 0
    # the main path of training: two steps as a user makes them; each runs
    # the forward, dq and dkv kernels once per block
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        model.epoch += 1
        model.apply("train", first)
    torch.cuda.synchronize()
    first_steps_ms = (time.perf_counter() - t0) * 1e3
    train_launches = {"forward": attention.launches,
                      "dq": attention.dq_launches,
                      "dkv": attention.dkv_launches}
    print(f"train main path: kernel launches {train_launches} in 2 steps")
    assert train_launches == {"forward": 4, "dq": 4, "dkv": 4}, \
        train_launches
    stats = model.lowering_stats("train")
    assert stats.get("attention-grad-impl:flash") == 2, stats
    assert stats.get("extern:attention_grad") == 6, stats

    start = {t: v.clone() for t, v in cpu_model.params.items()}
    t0 = time.perf_counter()
    for _ in range(2):
        cpu_model.epoch += 1
        cpu_model.apply("train", first)
    cpu_steps_s = time.perf_counter() - t0
    loss = float(model.call("loss", first)[0])
    cpu_loss = float(cpu_model.call("loss", first)[0])
    rel, worst = update_err(model.params, cpu_model.params, start)
    print(f"2 train steps (card {first_steps_ms:.1f} ms, CPU "
          f"{cpu_steps_s:.1f} s): loss {loss:.6f} vs CPU {cpu_loss:.6f}; "
          f"parameters vs CPU: |diff| / |update| {rel:.3e}, max |diff| "
          f"{worst:.3e}; on {gpu}")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel

    losses = [loss]
    for _ in range(TRAIN_EPOCHS):
        losses.append(model.fit("train", data, batch_size=BATCH,
                                log_status=False, monitor="loss"))
    print(f"fit {TRAIN_EPOCHS} epochs of {TRAIN_SEQS // BATCH} batches: "
          f"loss on the first batch {' -> '.join(f'{x:.6f}' for x in losses)}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    # one scan_batches epoch against a per-batch epoch from the same state
    state = ({t: v.clone() for t, v in model.params.items()},
             {t: v.clone() for t, v in model.caches.items()},
             model.epoch, model._rng.bit_generator.state)
    model.fit("train", data, batch_size=BATCH, log_status=False)
    per_batch = {t: v.clone() for t, v in model.params.items()}
    params, caches, epoch, rng_state = state
    model.params, model.caches, model.epoch = dict(params), dict(caches), epoch
    model._rng.bit_generator.state = rng_state
    model.fit("train", data, batch_size=BATCH, log_status=False,
              scan_batches=True)
    bitwise = all(torch.equal(model.params[t], v)
                  for t, v in per_batch.items())
    rel, worst = update_err(model.params, per_batch, params)
    print(f"scan epoch vs per-batch epoch: |diff| / |update| {rel:.3e}, "
          f"max |diff| {worst:.3e}, equal bit for bit: {bitwise}")
    assert rel <= TRAIN_UPDATE_RTOL, rel

    # a checkpoint written from the card predicts the same on the CPU
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = kernels.BUILD_DIR / "chip_smoke_checkpoint.egt"
    save_model(model, str(ckpt))
    loaded = load_model(str(ckpt), device="cpu")
    ckpt.unlink()
    assert loaded.epoch == model.epoch, (loaded.epoch, model.epoch)
    trained = model.call("predict", {"tokens": tokens})
    reloaded = loaded.call("predict", {"tokens": tokens})
    ckpt_err = float(np.abs(reloaded - trained).max())
    np.testing.assert_allclose(reloaded, trained, **PREDICT)
    print(f"checkpoint from the card, predict on the CPU: max |err| "
          f"{ckpt_err:.3e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.epoch += 1
        model.apply("train", first)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"train step [{BATCH},{SEQ}]: {step_ms:.2f} ms (mean of "
          f"{TIMED_STEPS} warm steps), {BATCH * SEQ / step_ms * 1e3:.1f} "
          f"training tokens/s on {gpu}")
    assert "jax" not in sys.modules, "the port imported jax"

    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_forward",
        "route": "cuda",
        "source": "exprgrad_torch/csrc/flash_fwd.cu",
        "replaces": "exprgrad_tpu/ops/attention.py:293",
        "launches": launches,
        "max_abs_err": slice_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "flash_attention_backward_dq",
        "route": "cuda",
        "source": "exprgrad_torch/csrc/flash_bwd.cu",
        "replaces": "exprgrad_tpu/ops/attention.py:375",
        "launches": train_launches["dq"],
        "max_abs_err": bwd_err[0],
        "ms": dq_ms,
        "plain_ms": plain_bwd_ms,
    }, {
        "name": "flash_attention_backward_dkv",
        "route": "cuda",
        "source": "exprgrad_torch/csrc/flash_bwd.cu",
        "replaces": "exprgrad_tpu/ops/attention.py:444",
        "launches": train_launches["dkv"],
        "max_abs_err": bwd_err[1],
        "ms": dkv_ms,
        "plain_ms": plain_bwd_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
