"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. build the port's CUDA kernels from exprgrad_torch/csrc;
2. hold the flash-attention kernel against its plain PyTorch version on
   the card at the serving shape and at GQA, window, rectangular,
   offset and bfloat16 shapes, and time both at the serving shape;
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
   still launches the kernel.

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

SERVING = dict(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
               max_seq=256)
BATCH, SEQ, PROMPT, NEW = 8, 256, 128, 128


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
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
          f"{kernels.library_path()}")
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
    np.testing.assert_allclose(probs, cpu_probs, rtol=1e-4, atol=1e-6)
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
    np.testing.assert_allclose(ragged, probs[:2, :200], rtol=1e-4, atol=1e-6)
    print("ragged predict [2,200]: 2 kernel launches, matches predict")
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
