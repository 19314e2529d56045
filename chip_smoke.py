"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve,
train, run scheduled contractions, map/reduce kernels and row chains, and
serve a continuous batch over a paged KV pool.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. build the port's CUDA kernels from exprgrad_torch/csrc;
2. hold the flash-attention kernels (forward; backward dq and dkv)
   against their plain PyTorch versions on the card at the serving shape
   and at GQA, window, rectangular, offset, dead-row, head_dim 36,
   ragged (sq 200, skv 77; GQA h8/hkv2 at sq 300, d 64) and bfloat16
   shapes, check that two backward runs on the same inputs give the same
   bits, and time them at the serving shape (the backward in float32 and
   bfloat16) beside scaled_dot_product_attention and its backward (whose
   kernels torch.profiler names and times at the end of the run);
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
   the CPU; and the time of a train step;
6. hold the scheduled matmul kernel (B1) against its plain version at
   4096^3, ragged 30x50x70 and 1000^3, a transposed store, each extra
   operand pattern of the epilogue (row bias, col broadcast, full
   residual, with relu and select; the residual also at 4095x4097x33)
   and bfloat16 inputs, and time it at 4096^3 beside torch.matmul (TF32
   off);
7. path (a): c[y,x] = a[y,it]*b[it,x] at 4096^3 float32 with
   schedule(tile 512), compiled with schedule_mode="force": one kernel
   launch per call, lowering {"matmul": 1}, the product against
   torch.matmul in float64;
8. path (b): a scheduled MLP at the flash_transformer FFN width (dense
   512->2048, relu, dense 2048->512, residual add, squared error, adam)
   on [2048, 512] rows: predict folds bias, relu and the residual into
   two kernel launches (matmul-fused 2) and matches the CPU port; three
   fit steps agree with the CPU port; the time of a train step;
9. hold the generated map/reduce kernel (B5) and fused row chain (B6)
   against their plain versions (the port's own lowering of the same
   IR, schedule_mode="ignore") on the card: one program per family of
   the classifier in float32 (ten in bfloat16), then 14 seeds each of
   the JAX package's three map/reduce fuzzers, and bench.py's scatter-add
   with every index on one destination, with 90% on one and with 5%
   outside [0, v); every case runs the generated kernels twice, which
   must give the same bits; and time B6
   at softmax 8192^2 and B5 at bench.py's scatter-add (n=16384, v=2048,
   d=512) beside their plain versions, torch.softmax and index_add;
10. path (c): the programs of examples/scheduled_kernels.py sections 3-9
   and bench.py's two map/reduce cells under schedule_mode="force":
   each launches its kernels once, as its lowering stats say, and
   matches the plain lowering; the warm time of the softmax 8192^2 call;
11. path (d): the flash_transformer head (rms_norm(row_tile=32), dense
   512->2048 scheduled as path (b)'s, softmax(row_tile=32), the
   cross-entropy, adam) on [2048, 512] rows: predict (two row chains,
   one B1 launch) and three fit steps launch the kernels as the stats
   say and agree with the CPU port; the time of a train step;
12. hold the paged decode-attention kernel (B7) against its plain
   version (decode_attention over gather_view) on the seven cases of
   tests/test_paged_attention.py, path (e)'s decode step, bench.py's
   paged shape and a few edges (the splits' among them: live pages that
   end inside a split, splits with no resident page, a window that ends
   inside a split, int8 pages over six splits, a one-entry table, rows of
   2048 slots at page 16), each run twice for the same bits, and time it
   at path (e)'s decode step and bench.py's shape beside the plain
   version and gather_view + scaled_dot_product_attention; then
   path (e): the serving model behind ContinuousBatcher(slots=8,
   capacity=256, paged=True, page_size=32, pool_pages=32) under
   bench.py's staggered mix of 12 requests.  With attention="flash" B7
   launches once per block per decode dispatch, with "gather" never;
   the pool preempts and every page comes back; with a float32 cache
   the greedy streams of flash, gather and solo generate agree but at
   near-ties of the solo logits; the bfloat16 drives are timed.

B1-B4 compute float32 on the tensor cores as split TF32 and are held
to the same tolerances as the float32 kernels before them
(tests/test_torch_tf32x3.py gives the argument); the bounds of B1-B4
are reckoned at split TF32, 3 x operations over 495 TFLOP/s.  Each path
runs with the kernels' launch counters set to 0 just before it and read
just after.  After the timed phases torch.profiler gives the device
time of every kernel a B5 scatter-add, a B6 softmax and a B7 call
launch, beside index_add's, torch.softmax's and the library route's.
It needs a CUDA device and the rest of the repository; without either
it fails.  The line before the
last is the JSON list of kernels (time, bound, plain and library times);
the last line is a JSON object naming the device.
"""

import json
import math
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


def matmul_f32_tol(k):
    """The matmul kernel against its plain version (a float64 product,
    then the epilogue in float64): float32 accumulation over k terms of
    order one errs by about 1e-7 * sqrt(k) times the sum's scale, so the
    absolute bound grows as sqrt(k)."""
    return dict(rtol=1e-4, atol=1e-5 * math.sqrt(k))


# a bfloat16 output rounds once more than the float64 plain version
MATMUL_BF16_OUT = dict(rtol=1e-2, atol=1e-2)

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# float32 outside the tensor cores, TF32 on the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# float32 products at float32's accuracy on the tensor cores: split TF32
# runs three TF32 products per product (csrc/tf32x3.cuh), so the bound of
# a float32 product is 3 x its operations over the TF32 rate
SPLIT_TF32 = dict(passes=3, rate=PEAK_TF32_FLOPS)

SERVING = dict(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
               max_seq=256)
BATCH, SEQ, PROMPT, NEW = 8, 256, 128, 128
TRAIN_SEQS, TRAIN_EPOCHS, TIMED_STEPS = 32, 3, 5
# the scheduled paths: the repo's matmul cell (bench.py) and an MLP at
# the serving model's FFN width on 8 x 256 token rows
MATMUL_N, MATMUL_TILE = 4096, 512
MLP = dict(dim=512, hidden=2048, tile=128)
MLP_ROWS, MLP_STEPS = 2048, 3
# the map/reduce cells of bench.py, and the flash_transformer head at the
# serving width (8 x 256 tokens of dim 512, vocabulary 2048)
SOFTMAX_N = 8192
SCATTER = dict(n=16384, v=2048, d=512, tile={"i": 512, "x": 256})
HEAD = dict(rows=2048, dim=512, vocab=2048)
HEAD_STEPS = 3

# Tolerances of the generated kernels (B5, B6) against their plain
# version, the port's own lowering of the same IR on the card.  float32:
# both compute in float32; sums of up to 32768 terms run in another order
# (a program's blocks, then tl.sum's tree, against torch's reductions).
GEN_F32 = dict(rtol=1e-5, atol=1e-5)
# the softmax rows: every value is below 1 and each row sums 8192 exps
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-6)
# scatters: the kernel sums each destination's positions in position
# order (in register chains and fixed pieces), the plain lowering in the
# order of torch's indexed accumulation; a target sums up to 16384 values
# (all indices on one destination), of order 1/sqrt(512) each
GEN_SCATTER = dict(rtol=1e-5, atol=1e-5)
# bfloat16: the kernel computes in float32 and rounds once, the plain
# lowering rounds after every op in bfloat16 (2^-8 relative each)
GEN_BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_FAMILIES = ("elementwise", "ragged", "stencil", "gather", "scatter_add",
                 "scatter_max", "scatter_min", "pure_scatter", "softmax",
                 "rms_norm")
# the differential fuzzers' own tolerance (sums of up to 7200 terms of
# exp-scaled products)
GEN_FUZZ = dict(rtol=3e-4, atol=3e-4)
FUZZ_SEEDS = 14

# Phase 12, paged serving.  Path (e): the serving model behind the
# continuous batcher, 8 slots over the model's whole context, pages of 32
# slots and half the dense reservation (32 of 64 pages), so recompute
# preemption must happen; bench.py's staggered mix (bench.py:575-622): 12
# requests, prompts of 48-159 tokens, budgets of 32-95.
BATCHER = dict(slots=8, capacity=256, paged=True, page_size=32,
               pool_pages=32)
MIX = dict(n=12, prompt=(48, 160), budget=(32, 96))
# two greedy streams may part only where the solo run's top two logits are
# this close: float32 sums in another order can flip such a near-tie
NEAR_TIE = 1e-4
# B7's shapes: path (e)'s decode step (8 slots, 4 heads, d 128, tables of 8
# pages of 32, 4 resident a row in the 33-page bfloat16 pool), and
# bench.py:1111's (b 8, hkv 8, group 1, d 128, 16 pages of 128 a row,
# every slot live, a bfloat16 pool of 129 pages)
PAGED_SERVING_CASE = (8, 4, 4, 1, 128, 8, 32, torch.bfloat16)
PAGED_SERVING_LENS = (100, 128, 97, 120, 105, 128, 110, 99)
PAGED_BENCH_CASE = (8, 8, 8, 1, 128, 16, 128, torch.bfloat16)
PAGED_BENCH_LENS = (2048,) * 8
PAGED_BENCH_PAGES = 8 * 16 + 1
# rows of bench.py's paged shape whose live pages end inside a split (1000,
# 1500, 700, 1800 slots) and whose later splits hold no resident page (129
# and 1 slots)
PAGED_SPLIT_LENS = (2048, 1000, 1500, 700, 2000, 129, 1, 1800)


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


def host_us(fn, calls=200) -> float:
    """Host microseconds per call of ``fn``, enqueue only (no synchronize
    inside the timed calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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


def bound(flops: float, nbytes: float, rate: float = PEAK_F32_FLOPS,
          passes: int = 1) -> tuple:
    """(the least milliseconds the card could take, what bounds it): the
    operations (``passes`` times ``flops``) over ``rate``, float32 outside
    the tensor cores by default, or the bytes over HBM's rate."""
    op_ms = passes * flops / rate * 1e3
    byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def attention_bounds(b, h, s, d) -> dict:
    """Bounds of the flash kernels at a causal [b, h, s, d] float32 call:
    multiply-adds over the live (row, key) pairs only (s(s+1)/2 of s^2),
    each input read once and each output written once.  Per live pair
    the forward does QK and PV (4d flops), dq recomputes S and does dP
    and dS.K (6d), dkv recomputes S and does P^T.dO, dP and dS^T.Q (8d).
    All three at split TF32, the route on which the card can do float32
    products at float32's accuracy fastest."""
    pairs = b * h * s * (s + 1) / 2
    full, rows = b * h * s * d * 4, b * h * s * 4
    return {
        "forward": bound(4 * d * pairs, 3 * full + full + rows, **SPLIT_TF32),
        "dq": bound(6 * d * pairs, 5 * full + rows + full + rows,
                    **SPLIT_TF32),
        "dkv": bound(8 * d * pairs, 4 * full + 2 * rows + 2 * full,
                     **SPLIT_TF32),
    }


def flash_cases(gen, dev) -> list:
    """Phase 2's shapes: (name, (q, k, v), keywords, out tolerance, lse
    tolerance), the serving shape first."""
    def qkv(b, h, hkv, sq, skv, d, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, h, sq, d), (b, hkv, skv, d),
                              (b, hkv, skv, d))]

    bf16 = torch.bfloat16
    return [
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
        # d not a multiple of 8: the MMAs' last k step reads zero columns
        ("d 36 causal", qkv(2, 4, 2, 256, 256, 36),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        # sq and skv not multiples of the 32-row q and 64-row kv tiles
        ("non-causal sq 200, skv 77", qkv(2, 4, 4, 200, 77, 128),
         dict(), F32_OUT, F32_LSE_ATOL),
        # GQA with lengths not a multiple of any tile of the kernels
        ("gqa h8/hkv2 causal sq 300, d 64", qkv(2, 8, 2, 300, 300, 64),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("serving shape bf16 causal", qkv(8, 4, 4, 256, 256, 128, bf16),
         dict(causal=True), BF16_OUT, BF16_LSE_ATOL),
        ("gqa h8/hkv2 bf16 causal sq 300, d 64",
         qkv(2, 8, 2, 300, 300, 64, bf16), dict(causal=True), BF16_OUT,
         BF16_LSE_ATOL),
        # 72-byte rows: plain loads in place of cp.async
        ("d 36 bf16 causal", qkv(2, 4, 2, 256, 256, 36, bf16),
         dict(causal=True), BF16_OUT, BF16_LSE_ATOL),
    ]


def check_flash_forward(attention, cases) -> float:
    """Phase 2: the forward kernel against its plain version at every
    case; returns the max |out error| at the serving shape."""
    errs = []
    for name, (q, k, v), kw, out_tol, lse_atol in cases:
        got = attention.flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention.attention_forward_plain(q, k, v, **kw)
        errs.append(compare(name, got, want, out_tol, lse_atol))
    return errs[0]


def kernel_names(fn) -> list:
    """The CUDA kernels one call of ``fn`` launches, by torch.profiler
    (called after the timed phases, so that no profiler session runs
    before them)."""
    return sorted(device_kernels(fn, calls=1))


def device_kernels(fn, calls=20) -> dict:
    """{kernel name: device ms per call of ``fn``} by torch.profiler over
    ``calls`` calls (after the timed phases, as kernel_names).  The
    profiler can drop events: a session in which a kernel's launches are
    not a whole multiple of the calls is taken again, up to three times."""
    for _ in range(3):
        times = _kernel_times(fn, calls)
        if times and all(len(ms) % calls == 0 for ms in times.values()):
            break
    return {name: sum(ms) / calls for name, ms in times.items()}


def _kernel_times(fn, calls) -> dict:
    """{kernel name: [ms of each launch]} over ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def check_flash_backward(attention, cases, gen, dev) -> tuple:
    """Phase 2: the backward kernels against their plain version at every
    case, on the forward kernel's (out, lse) as the train step hands them
    over, and bit for bit against a second run on the same inputs (no
    atomics: the same inputs give the same bits); returns (max |dq err|,
    max |dk, dv err|) at the serving shape."""
    errs = []
    for name, (q, k, v), kw, _, _ in cases:
        tol = F32_GRAD if q.dtype == torch.float32 else BF16_GRAD
        out, lse = attention.flash_attention_forward(q, k, v, **kw)
        g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = attention.flash_attention_backward(q, k, v, out, lse, g, **kw)
        again = attention.flash_attention_backward(q, k, v, out, lse, g,
                                                   **kw)
        torch.cuda.synchronize()
        for part, a, b in zip(("dq", "dk", "dv"), got, again):
            assert torch.equal(a, b), f"{name} {part}: two runs differ"
        want = attention.attention_backward_plain(q, k, v, out, lse, g, **kw)
        errs.append(compare_grads(name, got, want, tol, lse))
    print(f"backward repeat check: dq, dk and dv equal bit for bit in two "
          f"runs at all {len(cases)} cases")
    return errs[0]


def time_flash_backward(attention, q, k, v, gen, dev, gpu) -> dict:
    """Phase 2 timing of dq and dkv at one causal shape: the kernels and
    the plain backward in turns (plain, kernel, kernel, plain), then
    scaled_dot_product_attention's backward by CUDA events (its graph
    kept and walked again: autograd's host work included)."""
    out, lse = attention.flash_attention_forward(q, k, v, causal=True)
    g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    _, delta = attention.flash_bwd_dq(q, k, v, out, lse, g, causal=True)
    times = {"plain": [], "dq": [], "dkv": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            times["plain"].append(cuda_ms(
                lambda: attention.attention_backward_plain(
                    q, k, v, out, lse, g, causal=True)))
            continue
        times["dq"].append(cuda_ms(
            lambda: attention.flash_bwd_dq(q, k, v, out, lse, g,
                                           causal=True)))
        times["dkv"].append(cuda_ms(
            lambda: attention.flash_bwd_dkv(q, k, v, lse, delta, g,
                                            causal=True)))
    res = {key: sum(val) / 2 for key, val in times.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa_bwd = sdpa_backward(q, k, v, g)
    res["library"] = cuda_ms(sdpa_bwd)
    res["runs"] = times
    print(f"flash bwd {list(q.shape)} {str(q.dtype)[6:]} causal: dq "
          f"{res['dq']:.4f} ms, dkv {res['dkv']:.4f} ms, plain backward "
          f"(dq, dk, dv) {res['plain']:.4f} ms (runs {times}), "
          f"scaled_dot_product_attention backward (dq, dk, dv) "
          f"{res['library']:.4f} ms by CUDA events on {gpu}")
    return res


def sdpa_backward(q, k, v, g):
    """A call of scaled_dot_product_attention's backward alone at a causal
    shape: its graph is built once and walked again at every call."""
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                           is_causal=True)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), g,
                                       retain_graph=True)


def time_flash_forward(attention, q, k, v, gpu) -> dict:
    """Phase 2 timing at the serving shape: the kernel and its plain
    version in turns, then scaled_dot_product_attention (TF32 off)."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = (attention.attention_forward_plain if which == "plain"
              else attention.flash_attention_forward)
        times[which].append(cuda_ms(lambda: fn(q, k, v, causal=True)))
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"kernel": sum(times["kernel"]) / 2,
           "plain": sum(times["plain"]) / 2,
           "library": cuda_ms(lambda: sdpa(q, k, v, is_causal=True))}
    print(f"flash fwd [8,4,256,128] f32 causal: kernel {out['kernel']:.4f} "
          f"ms, plain {out['plain']:.4f} ms (runs {times}), "
          f"scaled_dot_product_attention {out['library']:.4f} ms on {gpu}")
    return out


def epilogue(code, consts=(), patterns=()):
    """An epilogue program of the matmul kernel from named steps."""
    from exprgrad_torch.ops.matmul import OPCODE, Epilogue

    return Epilogue(tuple((OPCODE[op], *regs) for op, *regs in code),
                    tuple(consts), tuple(patterns))


def matmul_graph(egt, n_tile):
    """The repo's matmul cell (bench.py, benchmarks/matmul.py)."""
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    c[y, x] = egt.input("a")[y, it] * egt.input("b")[it, x]
    c.schedule(tile={"y": n_tile, "x": n_tile, "it": n_tile},
               parallel=["y", "x"])
    return c.target("c")


def scheduled_mlp(egt, dim, hidden, tile, eta=1e-3):
    """dense -> relu -> dense, each matmul scheduled, plus the residual
    add of a flash_transformer FFN block; mean squared error against the
    input "t", adam (tests/test_pallas_fusion_chains.py's pattern)."""
    sched = dict(tile={"y": tile, "x": tile, "it": tile},
                 parallel=["y", "x"], kernel=0)
    h = egt.layers.dense(egt.input("v"), dim, hidden).schedule(**sched)
    h = egt.layers.relu(h)
    o = egt.layers.dense(h, hidden, dim).schedule(**sched)
    y, x = egt.iters("y", "x")
    out = egt.Fun("out")
    out[y, x] = egt.input("v")[y, x] + o[y, x]
    return (out.target("predict").pipe(egt.layers.mse, egt.input("t"))
            .target("loss")
            .backprop(egt.make_opt(egt.layers.adam, eta=eta))
            .target("train"))


# --- scheduled map/reduce kernels and row chains (B5, B6) ---------------
#
# Each builder takes a DSL module (exprgrad_torch here; the CPU tests also
# hand it exprgrad_tpu) and returns (graph, inputs) of one target "out";
# the inputs come from a fixed seed, so both packages see the same data.

def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def fam_elementwise(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = m.exp(inp[y, x]) + 1.0
    out.schedule(tile={"y": 16})
    (v,) = _normal(1, (64, 200))
    return out.target("out"), {"inp": v}


def fam_inblock_reduction(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x]) + b[y]
    out.schedule(tile={"y": 8}, share_cache=["x"])
    av, bv = _normal(2, (16, 32), (16,))
    return out.target("out"), {"a": av, "b": bv}


def fam_gridded_reduction(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = inp[y, x] * 2.0
    out.schedule(tile={"y": 32, "x": 128})
    (v,) = _normal(3, (64, 512))
    return out.target("out"), {"inp": v}


def fam_gridded_max(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out.maximize[y] = inp[y, x]
    out.schedule(tile={"x": 128})
    (v,) = _normal(4, (32, 512))
    return out.target("out"), {"inp": v}


def fam_stencil(m):
    img = m.input("img")
    y = m.iters("y")
    x = m.irange("x", 0, img.shape[1] - 2)
    out = m.Fun("out")
    out[y, x] = (img[y, x] + img[y, x + 1] + img[y, x + 2]) * (1.0 / 3.0)
    out.schedule(tile={"y": 16})
    (v,) = _normal(31, (64, 130))
    return out.target("out"), {"img": v}


def fam_stride_phase(m):
    imgs = m.input("imgs")
    i, y, x, c = m.iters("i", "y", "x", "c")
    out = m.Fun("out")
    out[i, y, x, c] = m.maximum(
        m.maximum(imgs[i, y * 2, x * 2, c], imgs[i, y * 2 + 1, x * 2, c]),
        m.maximum(imgs[i, y * 2, x * 2 + 1, c],
                  imgs[i, y * 2 + 1, x * 2 + 1, c]))
    out.schedule(tile={"y": 8})
    (v,) = _normal(10, (2, 16, 16, 128))
    return out.target("out"), {"imgs": v}


def fam_grouping(m):
    imgs = m.input("imgs")
    i, y, x, c = m.iters("i", "y", "x", "c")
    out = m.Fun("out")
    out[i, y, x, c] = imgs[i, y // 2, x // 2, c]
    out.with_shape([imgs.shape[0], imgs.shape[1] * 2, imgs.shape[2] * 2,
                    imgs.shape[3]])
    out.schedule(tile={"y": 8})
    (v,) = _normal(12, (2, 8, 8, 128))
    return out.target("out"), {"imgs": v}


def fam_flat_reads(m):
    a, b = m.input("a"), m.input("b")
    it = m.iters("it")
    out = m.Fun("out")
    out.raw[it] = m.exp(a.raw[it] * 0.3) + b.raw[it]
    out.schedule(tile={"it": 128})
    av, bv = _normal(62, (8, 16, 32), (8, 16, 32))
    return out.target("out"), {"a": av, "b": bv}


def fam_permuted_write(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[x, y] = a[y, x] * 2.0
    out.schedule(tile={"y": 32})
    (av,) = _normal(53, (64, 128))
    return out.target("out"), {"a": av}


def fam_permuted_read(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x]) + b[x, y]
    out.schedule(tile={"y": 16})
    av, bv = _normal(52, (32, 128), (128, 32))
    return out.target("out"), {"a": av, "b": bv}


def fam_constant_write(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[0] = m.sq(a[y, x] - b[y, x])
    out.schedule(tile={"y": 16})
    av, bv = _normal(41, (64, 128), (64, 128))
    return out.target("out"), {"a": av, "b": bv}


def fam_triangular(m):
    a = m.input("a")
    y = m.iters("y")
    x = m.irange("x", 0, y + 1)
    out = m.Fun("out")
    out.maximize[y] = a[y, x]
    out.schedule(tile={"y": 16})
    (av,) = _normal(55, (64, 64))
    return out.target("out"), {"a": av}


def fam_epoch(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = a[y, x] * m.to_scalar(m.epoch())
    out.schedule(tile={"y": 8})
    (av,) = _normal(5, (16, 128))
    return out.target("out"), {"a": av}


def fam_ragged(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x])
    out.schedule(tile={"y": 48, "x": 100})
    (av,) = _normal(23, (100, 200))
    return out.target("out"), {"a": av}


def fam_gather(m):
    n, t, d = m.iters("n", "t", "d")
    tok, table = m.input("tok"), m.input("table")
    out = m.Fun("out")
    out[n, d] = table[m.to_index(tok[n, t]), d] * 2.0 + 1.0
    out.with_shape([tok.shape[0], table.shape[1]])
    out.schedule(tile={"n": 2})
    tokv = np.random.default_rng(2).integers(0, 8, (3, 5)).astype(np.float32)
    (tab,) = _normal(6, (8, 64))
    return out.target("out"), {"tok": tokv, "table": tab}


def fam_pure_gather(m):
    i, j = m.iters("i", "j")
    xin, ain = m.input("x"), m.input("a")
    out = m.Fun("out")
    out[i, j] = xin[i, j] * ain[(i + 2 * j) % 9]
    out.with_shape([xin.shape[0], xin.shape[1]])
    out.schedule(tile={"i": 2, "j": 3})
    xv, av = _normal(9, (4, 6), (9,))
    return out.target("out"), {"x": xv, "a": av}


def _scatter(m, mode):
    i, x = m.iters("i", "x")
    tok, g = m.input("tok"), m.input("g")
    out = m.Fun("out")
    dst = out if mode == "add" else getattr(out, mode)
    dst[m.to_index(tok[i]), x] = g[i, x]
    out.with_shape([11, 24])
    out.schedule(tile={"i": 16})
    toks = np.random.default_rng(15).integers(0, 11, 48).astype(np.float32)
    (gv,) = _normal(16, (48, 24))
    return out.target("out"), {"tok": toks, "g": gv}


def fam_scatter_add(m):
    return _scatter(m, "add")


def fam_scatter_max(m):
    return _scatter(m, "maximize")


def fam_scatter_min(m):
    return _scatter(m, "minimize")


def fam_pure_scatter(m):
    i, j = m.iters("i", "j")
    vin = m.input("v")
    out = m.Fun("out")
    out[i, (i + j) % 7] = vin[i, j]
    out.with_shape([6, 7])
    out.schedule(tile={"i": 2})
    (vv,) = _normal(13, (6, 9))
    return out.target("out"), {"v": vv}


def fam_causal_mask(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.select(x <= y, a[y, x], 0.0)
    out.schedule(tile={"y": 32})
    (av,) = _normal(22, (128, 128))
    return out.target("out"), {"a": av}


def fam_shape_query(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = a[y, x] / m.to_scalar(a.shape[1])
    out.schedule(tile={"y": 16})
    (av,) = _normal(59, (64, 128))
    return out.target("out"), {"a": av}


def fam_broadcast_write(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = inp[y] * 3.0
    out.with_shape([inp.shape[0], 64])
    out.schedule(tile={"y": 16})
    (v,) = _normal(7, (32,))
    return out.target("out"), {"inp": v}


# one program per family of PallasMapReduce's classifier; each runs one
# generated kernel (one "mapreduce" stat) in both packages
MAPREDUCE_FAMILIES = {
    "elementwise": fam_elementwise,
    "inblock_reduction": fam_inblock_reduction,
    "gridded_reduction": fam_gridded_reduction,
    "gridded_max": fam_gridded_max,
    "stencil": fam_stencil,
    "stride_phase": fam_stride_phase,
    "grouping": fam_grouping,
    "flat_reads": fam_flat_reads,
    "permuted_write": fam_permuted_write,
    "permuted_read": fam_permuted_read,
    "constant_write": fam_constant_write,
    "triangular": fam_triangular,
    "epoch": fam_epoch,
    "ragged": fam_ragged,
    "gather": fam_gather,
    "pure_gather": fam_pure_gather,
    "scatter_add": fam_scatter_add,
    "scatter_max": fam_scatter_max,
    "scatter_min": fam_scatter_min,
    "pure_scatter": fam_pure_scatter,
    "causal_mask": fam_causal_mask,
    "shape_query": fam_shape_query,
    "broadcast_write": fam_broadcast_write,
}


def softmax_chain(m, tile, rows=128, cols=256, seed=0, scale=8.0):
    """The three-kernel softmax of bench.py (row max, exp-sum,
    normalize), each kernel scheduled with ``tile``."""
    inp = m.input("inp")
    funs = []
    for name in ("mx", "sums", "out"):
        y, x = m.iters("y", "x")
        f = m.Fun(name)
        if name == "mx":
            f.maximize[y] = inp[y, x]
        elif name == "sums":
            f[y] = m.exp(inp[y, x] - funs[0][y])
        else:
            f[y, x] = m.exp(inp[y, x] - funs[0][y]) / funs[1][y]
        f.schedule(tile=tile)
        funs.append(f)
    (v,) = _normal(seed, (rows, cols), scale=scale)
    return funs[-1].target("out"), {"inp": v}


def chain_layer_norm(m):
    dim = 128
    inp, gamma, beta = m.input("inp"), m.input("gamma"), m.input("beta")
    n, v, out = m.Fun("mean"), m.Fun("var"), m.Fun("out")
    y, x = m.iters("y", "x")
    n[y] = inp[y, x] * (1.0 / dim)
    y, x = m.iters("y", "x")
    v[y] = m.sq(inp[y, x] - n[y]) * (1.0 / dim)
    y, x = m.iters("y", "x")
    out[y, x] = (inp[y, x] - n[y]) / m.sqrt(v[y] + 1e-5) * gamma[x] + beta[x]
    for f in (n, v, out):
        f.schedule(tile={"y": 16})
    a, g, b = _normal(2, (64, dim), (dim,), (dim,))
    return out.target("out"), {"inp": a, "gamma": g, "beta": b}


def chain_rms(m):
    a = m.input("a")
    ss, out = m.Fun("ss"), m.Fun("out")
    y, x = m.iters("y", "x")
    ss[y] = m.sq(a[y, x]) * (1.0 / 128.0)
    y, x = m.iters("y", "x")
    out[y, x] = a[y, x] / m.sqrt(ss[y] + 1e-6)
    for f in (ss, out):
        f.schedule(tile={"y": 16})
    (av,) = _normal(2, (64, 128))
    return out.target("out"), {"a": av}


def chain_escaping(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    mx = m.Fun("mx")
    mx.maximize[y] = inp[y, x]
    y, x = m.iters("y", "x")
    sums = m.Fun("sums")
    sums[y] = m.exp(inp[y, x] - mx[y])
    esc = m.Fun("esc")
    y2 = m.iters("y2")
    esc[y2] = mx[y2] * 2.0  # a second consumer of mx, outside the chain
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = (m.exp(inp[y, x] - mx[y]) / sums[y]) + 0.001 * esc[y]
    for f in (mx, sums, out):
        f.schedule(tile={"y": 16})
    (v,) = _normal(3, (32, 128))
    return out.target("out"), {"inp": v}


def chain_shared_operand(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    mx = m.Fun("mx")
    mx.maximize[y] = inp[y, x]
    mx.schedule(parallel=["y"])
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = inp[y, x] - mx[y]
    out.schedule(parallel=["y"])
    (v,) = _normal(5, (64, 128))
    return out.target("out"), {"inp": v}


def chain_layer_softmax(m):
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    out = layers.softmax(m.input("inp"), row_tile=32)
    (v,) = _normal(7, (64, 256), scale=6.0)
    return out.target("out"), {"inp": v}


def chain_layer_rms_rank3(m):
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    out = layers.rms_norm(m.input("inp"), 128, rank=3, row_tile=16)
    (v,) = _normal(8, (4, 64, 128))
    return out.target("out"), {"inp": v}


def chain_causal_softmax(m):
    inp = m.input("inp")
    funs = []
    for name in ("mx", "sm", "out"):
        q, k = m.iters("q", "k")
        f = m.Fun(name)
        if name == "mx":
            f.maximize[q] = m.select(k <= q, inp[q, k], -1e30)
        elif name == "sm":
            f[q] = m.select(k <= q, m.exp(inp[q, k] - funs[0][q]), 0.0)
        else:
            f[q, k] = m.select(k <= q, m.exp(inp[q, k] - funs[0][q])
                               / funs[1][q], 0.0)
        f.schedule(tile={"q": 32})
        funs.append(f)
    (v,) = _normal(7, (128, 128), scale=4.0)
    return funs[-1].target("out"), {"inp": v}


def chain_ragged_rows(m):
    return softmax_chain(m, {"y": 48}, rows=100, cols=256, seed=1, scale=5.0)


# the row-chain programs of tests/test_pallas_rowchain.py that fuse; each
# runs one fused kernel (one "rowchain" stat) in both packages
ROWCHAIN_FAMILIES = {
    "softmax": lambda m: softmax_chain(m, {"y": 32}),
    "ragged_rows": chain_ragged_rows,
    "layer_norm": chain_layer_norm,
    "rms_norm": chain_rms,
    "escaping": chain_escaping,
    "shared_operand": chain_shared_operand,
    "layer_softmax": chain_layer_softmax,
    "layer_rms_rank3": chain_layer_rms_rank3,
    "causal_softmax": chain_causal_softmax,
}


# Seeded random programs, built as the JAX package's differential fuzzers
# build theirs (tests/test_fuzz_general.py, test_fuzz_cmpred.py,
# test_fuzz_rowchain.py): the same draws from the same seeds give the same
# programs and inputs.

def fuzz_general(m, rng):
    """Permuted reads and writes, maybe a triangular bound."""
    sizes = [int(rng.choice(c)) for c in
             ([13, 30, 48], [10, 24, 36], [100, 128, 200])]
    dynamic = rng.random() < 0.4
    i0 = m.iters("i0")
    if dynamic:
        c = int(rng.integers(1, 8))
        sizes[1] = sizes[0] - 1 + c
        i1 = m.irange("i1", 0, i0 + c)
    else:
        i1 = m.iters("i1")
    i2 = m.iters("i2")
    its = (i0, i1, i2)
    inputs = {"base": tuple(sizes)}
    exprs = [m.input("base")[i0, i1, i2]]
    for r in range(int(rng.integers(1, 3))):
        axes = sorted({2} | {a for a in (0, 1) if rng.random() < 0.5})
        order = list(rng.permutation(len(axes)))
        perm_axes = [axes[i] for i in order]
        inputs[f"t{r}"] = tuple(sizes[a] for a in perm_axes)
        exprs.append(m.input(f"t{r}")[tuple(its[a] for a in perm_axes)])
    expr = exprs[0]
    for other in exprs[1:]:
        op = rng.choice(["add", "mul", "max"])
        if op == "add":
            expr = expr + other
        elif op == "mul":
            expr = expr * other
        else:
            expr = m.maximum(expr, other)
    if rng.random() < 0.3:
        expr = m.exp(expr * 0.05)
    out = m.Fun("out")
    keep = sorted({2} | {0 for _ in (0,) if rng.random() < 0.7})
    if not dynamic and rng.random() < 0.5:
        keep = sorted(set(keep) | {1})
    order = list(rng.permutation(len(keep)))
    idx = tuple(its[keep[i]] for i in order)
    if rng.random() < 0.2:
        out.maximize[idx] = expr
    else:
        out[idx] = expr
    tiles = {}
    for a in keep:
        if rng.random() < 0.6:
            tiles[f"i{a}"] = int(rng.choice([8, 16, 48, 100]))
    if tiles:
        out.schedule(tile=tiles)
    else:
        out.schedule(parallel=[f"i{keep[0]}"])
    return [out.target("out")], inputs


def _index_expr(rng, its, V):
    a, b = rng.choice(len(its), size=2, replace=False)
    form = rng.integers(0, 4)
    ia, ib = its[int(a)], its[int(b)]
    if form == 0:
        e = ia * ib
    elif form == 1:
        e = ia * int(rng.integers(1, 5)) + ib * int(rng.integers(1, 5))
    elif form == 2:
        e = ia * ia + int(rng.integers(0, 7))
    else:
        e = ia // int(rng.integers(2, 5)) + ib
    return e % V


def fuzz_cmpred(m, rng):
    """Computed-index (pure-iterator) gathers and scatters."""
    sizes = [int(rng.integers(4, 20)), int(rng.integers(4, 20)),
             int(rng.choice([32, 64, 128]))]
    i0, i1, i2 = m.iters("i0", "i1", "i2")
    its = (i0, i1, i2)
    V = int(rng.integers(5, 60))
    inputs = {"base": tuple(sizes)}
    expr = m.input("base")[i0, i1, i2]
    for r in range(int(rng.integers(1, 3))):
        name = f"g{r}"
        gidx = _index_expr(rng, its, V)
        roll = rng.random()
        if roll < 0.3:
            trail = int(rng.choice([0, 1, 2]))
            inputs[name] = (V, sizes[trail])
            read = m.input(name)[gidx, its[trail]]
        elif roll < 0.5:
            V2 = int(rng.integers(4, 20))
            gidx2 = _index_expr(rng, its, V2)
            inputs[name] = (V, V2)
            read = m.input(name)[gidx, gidx2]
        else:
            inputs[name] = (V,)
            read = m.input(name)[gidx]
        expr = expr + read if rng.random() < 0.5 else expr * read
    if rng.random() < 0.3:
        expr = m.exp(expr * 0.05)
    out = m.Fun("out")
    if rng.random() < 0.35:
        acc_roll = rng.random()
        dst = (out.maximize if acc_roll < 1 / 6
               else out.minimize if acc_roll < 1 / 3 else out)
        Vout = int(rng.integers(5, 40))
        widx = _index_expr(rng, its, Vout)
        roll = rng.random()
        if roll < 0.3:
            dst[widx, i2] = expr
            shape = [Vout, sizes[2]]
        elif roll < 0.5:
            Vout2 = int(rng.integers(4, 16))
            widx2 = _index_expr(rng, its, Vout2)
            dst[widx, widx2] = expr
            shape = [Vout, Vout2]
        elif roll < 0.7:
            dst[widx, i0] = expr
            shape = [Vout, sizes[0]]
        else:
            dst[widx] = expr
            shape = [Vout]
        out.with_shape(shape)
    else:
        keep = sorted({2} | {a for a in (0, 1) if rng.random() < 0.6})
        out[tuple(its[a] for a in keep)] = expr
        out.with_shape([sizes[a] for a in keep])
    tiles = {}
    for a in range(3):
        if rng.random() < 0.5:
            tiles[f"i{a}"] = int(rng.choice([4, 8, 16, 64]))
    if tiles:
        out.schedule(tile=tiles)
    else:
        out.schedule(parallel=["i0"])
    return [out.target("out")], inputs


def fuzz_rowchain(m, rng):
    """2-4 kernel row chains, sometimes with an escaping intermediate."""
    r = int(rng.choice([48, 100, 128]))
    c = int(rng.choice([128, 200, 256]))
    inp = m.input("inp")
    tile = int(rng.choice([16, 32, 48]))
    funs = []
    y, x = m.iters("y", "x")
    head = m.Fun("k0")
    if rng.random() < 0.4:
        head.maximize[y] = inp[y, x]
    else:
        head[y] = m.exp(inp[y, x] * 0.1)
    head.schedule(tile={"y": tile})
    funs.append(head)
    for i in range(int(rng.integers(0, 2))):
        y, x = m.iters("y", "x")
        f = m.Fun(f"k{i + 1}")
        prev = funs[-1]
        kind = rng.choice(["exp", "sq", "mix"])
        if kind == "exp":
            f[y] = m.exp((inp[y, x] - prev[y]) * 0.1)
        elif kind == "sq":
            f[y] = m.sq(inp[y, x] * 0.05) + prev[y] * 0.01
        else:
            f[y] = m.maximum(inp[y, x] * 0.1, prev[y] * 0.05)
        f.schedule(tile={"y": tile})
        funs.append(f)
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    prev, first = funs[-1], funs[0]
    if rng.random() < 0.7:
        out[y, x] = (inp[y, x] - first[y] * 0.5) / m.sqrt(
            prev[y] * prev[y] + 1.0)
    else:
        out[y] = (inp[y, x] - first[y] * 0.01) * 0.1 + prev[y]
    out.schedule(tile={"y": tile})
    funs.append(out)
    graphs = [out.target("out")]
    if rng.random() < 0.4 and len(funs) > 1:
        victim = funs[int(rng.integers(0, len(funs) - 1))]
        z = m.iters("z")
        esc = m.Fun("esc")
        esc[z] = victim[z] * 3.0
        graphs.append(esc.target("esc"))
    return graphs, {"inp": (r, c)}


def fuzz_case(m, kind, seed):
    """(graphs, inputs) of the fuzzer ``kind`` at ``seed``, with the
    fuzzers' own seed offsets and input draws."""
    build, base, scale = {"general": (fuzz_general, 9100, 0.5),
                          "cmpred": (fuzz_cmpred, 41000, 0.5),
                          "rowchain": (fuzz_rowchain, 8200, 2.0)}[kind]
    rng = np.random.default_rng(base + seed)
    graphs, shapes = build(m, rng)
    args = {name: (rng.normal(size=shape) * scale).astype(np.float32)
            for name, shape in shapes.items()}
    return graphs, args


def scatter_add_graph(m, v, d, tile):
    """bench.py's embedding-gradient scatter-add demb[tok[i], x] += g[i, x]."""
    i, x = m.iters("i", "x")
    tok, g = m.input("tok"), m.input("g")
    out = m.Fun("demb")
    out[m.to_index(tok[i]), x] = g[i, x]
    out.with_shape([v, d])
    out.schedule(tile=tile)
    return out.target("demb")


def transformer_head(m, dim, vocab, eta=1e-3):
    """The head of flash_transformer (models/transformer.py: rms_norm,
    dense to the vocabulary, softmax, the cross-entropy over the tokens)
    on rank-2 rows, its row-family layers given ``row_tile=32`` and its
    dense scheduled as path (b)'s, trained with adam."""
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    h = layers.rms_norm(m.input("x"), dim, row_tile=32)
    logits = layers.dense(h, dim, vocab).schedule(
        tile={"y": 128, "x": 128, "it": 128}, parallel=["y", "x"], kernel=0)
    predict = layers.softmax(logits, row_tile=32).target("predict")
    labels = m.input("labels")
    it = m.iters("it")
    loss = m.Fun("loss")
    loss[0] = -(labels.raw[it] * m.ln(predict.raw[it] + 1e-9)) / m.to_scalar(
        labels.shape[0])
    return (loss.target("loss").backwards()
            .optimize(m.make_opt(layers.adam, eta=eta)).target("train"))


def check_matmul_kernel(gen, dev) -> float:
    """Phase 6: the kernel against its plain version at every case;
    returns the max |error| at 4096^3."""
    from exprgrad_torch.ops import matmul

    relu_row = epilogue([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
                         ("const", 3, 0, 0, 0), ("le", 4, 3, 2, 0),
                         ("select", 5, 4, 2, 3), ("mov", 0, 5, 0, 0)],
                        (0.0,), ("row",))
    col_select = epilogue([("extra", 1, 0, 0, 0), ("sub", 2, 0, 1, 0),
                           ("const", 3, 0, 0, 0), ("lt", 4, 2, 3, 0),
                           ("const", 5, 1, 0, 0), ("mul", 6, 2, 5, 0),
                           ("select", 0, 4, 6, 2)], (0.0, 0.1), ("col",))
    residual_relu = epilogue([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
                              ("const", 3, 0, 0, 0), ("le", 4, 3, 2, 0),
                              ("select", 0, 4, 2, 3)], (0.0,), ("full",))
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, (m, k, n), transposed, in/out dtype, epilogue
        ("4096^3 f32", (4096, 4096, 4096), False, f32, f32, None),
        ("ragged 30x50x70", (30, 50, 70), False, f32, f32, None),
        ("1000^3", (1000, 1000, 1000), False, f32, f32, None),
        ("transposed 512x256x384", (512, 256, 384), True, f32, f32, None),
        ("row bias + relu 1000x512x768", (1000, 512, 768), False, f32, f32,
         relu_row),
        ("col broadcast + select 333x257x129", (333, 257, 129), False, f32,
         f32, col_select),
        ("full residual + relu, transposed 300x200x500", (300, 200, 500),
         True, f32, f32, residual_relu),
        # k of 4097 (rows of 16388 bytes: plain loads), ragged tiles
        ("full residual + relu 4095x4097x33", (4095, 4097, 33), False, f32,
         f32, residual_relu),
        ("bf16 in, f32 out 1024^3", (1024, 1024, 1024), False, bf16, f32,
         None),
        ("bf16 in and out, row bias + relu 1024x1024x512",
         (1024, 1024, 512), False, bf16, bf16, relu_row),
    ]
    worst = None
    for name, (m, k, n), transposed, in_dt, out_dt, prog in cases:
        a = torch.randn(m, k, generator=gen, device=dev).to(in_dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(in_dt)
        rows, cols = (n, m) if transposed else (m, n)
        shapes = {"row": (1, cols), "col": (rows, 1), "full": (rows, cols)}
        extra = [torch.randn(shapes[p], generator=gen, device=dev).to(out_dt)
                 for p in (prog.patterns if prog else ())]
        got = matmul.matmul_impl(a, b, out_dt, prog, extra, transposed)
        torch.cuda.synchronize()
        want = matmul.matmul_plain(a, b, out_dt, prog, extra, transposed)
        tol = matmul_f32_tol(k) if out_dt == f32 else MATMUL_BF16_OUT
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got.double(), want.double(), **tol,
                                   msg=lambda msg: f"matmul {name}: {msg}")
        err = (got.double() - want.double()).abs().max().item()
        print(f"kernel check matmul {name}: max |err| {err:.3e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']:.3e})")
        if worst is None:
            worst = err
    return worst


def time_matmul(gen, dev, n, gpu) -> dict:
    """Phase 6 timing at n^3 float32: the kernel, its plain version and
    torch.matmul with TF32 off, in turns."""
    from exprgrad_torch.ops import matmul

    a = torch.randn(n, n, generator=gen, device=dev)
    b = torch.randn(n, n, generator=gen, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {"kernel": lambda: matmul.matmul_impl(a, b),
           "plain": lambda: matmul.matmul_plain(a, b),
           "library": lambda: torch.matmul(a, b)}
    runs = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library",
                 "plain"):
        runs[name].append(cuda_ms(fns[name], iters=10, warmup=2))
    out = {name: sum(v) / len(v) for name, v in runs.items()}
    out["bound"] = bound(2.0 * n ** 3, 3 * n * n * 4, **SPLIT_TF32)
    print(f"matmul {n}^3 f32: kernel {out['kernel']:.4f} ms, plain "
          f"(float64) {out['plain']:.4f} ms, torch.matmul TF32 off "
          f"{out['library']:.4f} ms, bound {out['bound'][0]:.4f} ms "
          f"({out['bound'][1]}) (runs {runs}) on {gpu}")
    return out


def path_a(egt, matmul, gpu) -> int:
    """Phase 7: the matmul cell through compile(schedule_mode="force")."""
    model = egt.compile(matmul_graph(egt, MATMUL_TILE), seed=0,
                        schedule_mode="force", device="cuda")
    rng = np.random.default_rng(0)
    n = MATMUL_N
    args = {"a": rng.standard_normal((n, n), dtype=np.float32),
            "b": rng.standard_normal((n, n), dtype=np.float32)}
    matmul.launches = 0
    t0 = time.perf_counter()
    out = model.call("c", args)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = matmul.launches
    assert launches == 1, launches
    stats = model.lowering_stats("c")
    assert stats == {"matmul": 1}, stats
    want = (torch.from_numpy(args["a"]).double().cuda()
            @ torch.from_numpy(args["b"]).double().cuda()).cpu().numpy()
    assert out.shape == (n, n) and np.isfinite(out).all()
    err = float(np.abs(out - want).max())
    np.testing.assert_allclose(out, want, **matmul_f32_tol(n))
    t0 = time.perf_counter()
    for _ in range(3):
        model.call("c", args)
    call_ms = (time.perf_counter() - t0) * 1e3 / 3
    assert matmul.launches == 4, matmul.launches
    print(f"path (a) matmul {n}^3 schedule(tile {MATMUL_TILE}) force: "
          f"{launches} launch per call, lowering {stats}, max |err| vs "
          f"torch.matmul float64 {err:.3e}; call (host arrays in and out) "
          f"{call_ms:.2f} ms warm, {first_ms:.2f} ms first, on {gpu}")
    return launches


def path_b(egt, matmul, gpu) -> dict:
    """Phase 8: the scheduled MLP, predict and three fit steps."""
    graph = scheduled_mlp(egt, **MLP)
    model = egt.compile(graph, seed=0, schedule_mode="force",
                        device="cuda")
    cpu = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    rng = np.random.default_rng(1)
    dim = MLP["dim"]
    data = {"v": rng.standard_normal((MLP_ROWS * MLP_STEPS, dim),
                                     dtype=np.float32),
            "t": rng.standard_normal((MLP_ROWS * MLP_STEPS, dim),
                                     dtype=np.float32)}
    v = {"v": data["v"][:MLP_ROWS]}
    matmul.launches = 0
    probs = model.call("predict", v)
    predict_launches = matmul.launches
    stats = model.lowering_stats("predict")
    assert stats == {"matmul-fused": 2}, stats
    assert predict_launches == 2, predict_launches
    want = cpu.call("predict", v)
    assert np.isfinite(probs).all()
    err = float(np.abs(probs - want).max())
    np.testing.assert_allclose(probs, want, **matmul_f32_tol(MLP["hidden"]))
    print(f"path (b) predict [{MLP_ROWS},{dim}]: {predict_launches} kernel "
          f"launches, lowering {stats}, max |err| vs the CPU port "
          f"{err:.3e}")

    start = {t: x.clone() for t, x in cpu.params.items()}
    matmul.launches = 0
    model.fit("train", data, batch_size=MLP_ROWS, log_status=False)
    torch.cuda.synchronize()
    fit_launches = matmul.launches
    train_stats = model.lowering_stats("train")
    per_step = train_stats.get("matmul", 0) + train_stats.get(
        "matmul-fused", 0)
    assert per_step >= 1 and fit_launches == MLP_STEPS * per_step, (
        fit_launches, train_stats)
    t0 = time.perf_counter()
    cpu.fit("train", data, batch_size=MLP_ROWS, log_status=False)
    cpu_s = time.perf_counter() - t0
    first = {"v": data["v"][:MLP_ROWS], "t": data["t"][:MLP_ROWS]}
    loss = float(model.call("loss", first)[0])
    cpu_loss = float(cpu.call("loss", first)[0])
    rel, worst = update_err(model.params, cpu.params, start)
    print(f"path (b) fit {MLP_STEPS} steps: {fit_launches} kernel launches "
          f"({per_step} per step), lowering {train_stats}; loss {loss:.6f} "
          f"vs CPU {cpu_loss:.6f} (CPU {cpu_s:.1f} s); parameters vs CPU: "
          f"|diff| / |update| {rel:.3e}, max |diff| {worst:.3e}")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel

    model.epoch += 1
    model.apply("train", first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.apply("train", first)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"path (b) train step [{MLP_ROWS},{dim}]: {step_ms:.2f} ms (mean "
          f"of {TIMED_STEPS} warm steps), {per_step} kernel launches per "
          f"step, on {gpu}")
    return {"predict": predict_launches, "fit": fit_launches}


def executor_of(model):
    (ex,) = model._executors.values()
    return ex


def kernel_vs_plain(egt, graphs, args, target="out", epoch=3):
    """The target on the card through the generated kernels
    (schedule_mode="force"), twice, which must give the same bits, and
    through the plain lowering (schedule_mode="ignore"), same parameters
    and inputs: (kernel output, plain output, the kernel model's
    stats)."""
    outs = []
    for mode in ("force", "ignore"):
        model = egt.compile(graphs, seed=0, schedule_mode=mode,
                            device="cuda")
        model.epoch = epoch
        outs.append(model.call(target, args))
        if mode == "force":
            stats = model.lowering_stats(target)
            again = model.call(target, args)
            assert np.array_equal(outs[0], again, equal_nan=True), (
                f"{target}: two runs of the generated kernels differ")
    return outs[0], outs[1], stats


def bf16_kernel_vs_plain(egt, graph, args, epoch=3):
    """The same pair in bfloat16: the compiled program with its scalar
    type set to bfloat16, run by an executor of each mode on bfloat16
    copies of the inputs and parameters (the generated kernels twice,
    which must give the same bits)."""
    from exprgrad_torch.backend.executor import TorchExecutor
    from exprgrad_torch.passes import infer_shapes

    model = egt.compile(graph, seed=0, device="cuda")
    prog = model.program.copy()
    prog.scalar_type = egt.ir.ScalarType.BF16
    shapes = infer_shapes(prog, "out", [(prog.inputs[n], list(v.shape))
                                        for n, v in args.items()])
    tensors = {prog.inputs[n]: torch.from_numpy(v).to(model.device)
               .bfloat16() for n, v in args.items()}
    tensors.update({t: p.bfloat16() for t, p in model.params.items()})
    out = prog.targets["out"].output
    got = {}
    for mode in ("force", "ignore"):
        ex = TorchExecutor(prog, "out", shapes, model.device, mode)
        got[mode] = ex.run(dict(tensors), shapes, epoch, 0)[out].float()
        if mode == "force":
            again = ex.run(dict(tensors), shapes, epoch, 0)[out].float()
            assert torch.equal(got[mode], again), (
                "two bfloat16 runs of the generated kernels differ")
    return got["force"], got["ignore"]


def assert_same(name, got, want, tol) -> float:
    """got == want within tol, with the same infinities (an empty row of a
    max or min scatter keeps its identity); returns max |error|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=name)
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all(), name
    np.testing.assert_allclose(got[fin], want[fin], **tol, err_msg=name)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def check_generated_kernels(egt, gpu) -> dict:
    """Phase 9: B5 and B6 against their plain versions on the card, one
    program per family in float32 (and ten in bfloat16), then the seeded
    sweep of random kernels and chains, each run twice for the same
    bits.  Returns the max |error| of each kernel."""
    worst = {"mapreduce": 0.0, "rowchain": 0.0}
    families = [(n, f, "mapreduce") for n, f in MAPREDUCE_FAMILIES.items()]
    families += [(n, f, "rowchain") for n, f in ROWCHAIN_FAMILIES.items()]
    for name, family, kind in families:
        graph, args = family(egt)
        got, want, stats = kernel_vs_plain(egt, graph, args)
        assert stats.get(kind) == 1, (name, stats)
        tol = GEN_SCATTER if "scatter" in name else GEN_F32
        err = assert_same(f"{kind} {name}", got, want, tol)
        worst[kind] = max(worst[kind], err)
        line = (f"kernel check {kind} {name}: two runs equal bit for bit; "
                f"max |err| {err:.3e}")
        if name in BF16_FAMILIES:
            got, want = bf16_kernel_vs_plain(egt, graph, args)
            bf_err = assert_same(f"{kind} {name} bf16", got.cpu(),
                                 want.cpu(), GEN_BF16)
            line += f", bfloat16 {bf_err:.3e}"
        print(line)
    hits = {}
    for kind in ("general", "cmpred", "rowchain"):
        hits[kind] = 0
        for seed in range(FUZZ_SEEDS):
            graphs, args = fuzz_case(egt, kind, seed)
            for target in ("out", "esc")[:len(graphs)]:
                got, want, stats = kernel_vs_plain(egt, graphs, args, target)
                assert_same(f"fuzz {kind} seed {seed} {target}", got, want,
                            GEN_FUZZ)
                if target == "out":
                    hits[kind] += bool(stats.get("mapreduce")
                                       or stats.get("rowchain"))
    # a gathered index outside the table reads 0, as the TPU kernel does
    graph, args = fam_gather(egt)
    tok = args["tok"].copy()
    tok[0, 0], tok[1, 2], tok[2, 4] = 8, -1, 1000
    got = egt.compile(graph, seed=0, schedule_mode="force",
                      device="cuda").call("out", {**args, "tok": tok})
    idx = tok.astype(np.int64)
    inside = (idx >= 0) & (idx < args["table"].shape[0])
    rows = np.where(inside[..., None],
                    args["table"][np.clip(idx, 0, args["table"].shape[0] - 1)],
                    0.0)
    assert_same("gather out of range", got, (rows * 2.0 + 1.0).sum(1),
                GEN_F32)
    print("kernel check mapreduce gather with indices outside the table: "
          "they read 0")
    print(f"seeded sweep: {FUZZ_SEEDS} seeds each of the general, "
          f"computed-index and row-chain fuzzers match the plain version; "
          f"seeds that ran a generated kernel {hits}")
    return worst


def scatter_tokens(kind, n, v, seed=0):
    """bench.py's scatter-add indices (uniform in [0, v)) and the edges of
    phase 9: every index on one destination, 90% on one, 5% outside
    [0, v)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, v, n)
    if kind == "all on one destination":
        tok = np.full(n, 7)
    elif kind == "90% on one destination":
        tok = np.where(rng.random(n) < 0.9, 11, tok)
    elif kind == "5% outside [0, v)":
        tok = np.where(rng.random(n) < 0.05,
                       rng.choice([-1, v, v + 100, -50], n), tok)
    return tok.astype(np.float32)


SCATTER_EDGES = ("all on one destination", "90% on one destination",
                 "5% outside [0, v)")


def check_scatter_cases(egt) -> float:
    """Phase 9 (b): bench.py's scatter-add at its full shape with every
    index on one destination, with 90% on one and with 5% outside [0, v),
    each run twice on the card (the same bits both times) and held against
    the plain lowering.  The indices outside are dropped; the plain
    lowering clamps them, as the JAX package's XLA path does, so that case
    is held against numpy's sum in float64.  Returns the max |error|."""
    worst = 0.0
    v, d, n = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    graph = scatter_add_graph(egt, v, d, SCATTER["tile"])
    g = (np.random.default_rng(1).normal(size=(n, d)) / np.sqrt(d)).astype(
        np.float32)
    for kind in SCATTER_EDGES:
        tok = scatter_tokens(kind, n, v)
        args = {"tok": tok, "g": g}
        idx = tok.astype(np.int64)
        keep = (idx >= 0) & (idx < v)
        exact = np.zeros((v, d))
        np.add.at(exact, idx[keep], g[keep].astype(np.float64))
        got, want, _ = kernel_vs_plain(egt, graph, args, "demb")
        if not keep.all():
            want = exact
        err = assert_same(f"scatter-add {kind}", got, want, GEN_SCATTER)
        worst = max(worst, err)
        print(f"kernel check mapreduce scatter-add n={n} v={v} d={d}, "
              f"{kind}: two runs equal bit for bit; max |err| "
              f"{err:.3e} against the "
              f"{'plain lowering' if keep.all() else 'float64 sum'}, "
              f"{float(np.abs(got - exact).max()):.3e} against the float64 "
              f"sum")
    return worst


def time_generated_kernels(egt, gpu) -> dict:
    """Phase 9 timing: B6 at softmax 8192^2 and B5 at bench.py's scatter-
    add shape, each beside its plain version and one PyTorch call for the
    same function, with CUDA events, in turns."""
    from exprgrad_torch.ops import mapreduce, rowchain

    out = {}
    n = SOFTMAX_N
    graph, args = softmax_chain(egt, {"y": 32}, rows=n, cols=n, scale=1.0)
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    model.call("out", args)
    ex = executor_of(model)
    (chain,) = ex.row_fused.values()
    dev = model.device
    x = torch.from_numpy(args["inp"]).to(dev)
    prog = model.program
    tensors = {prog.inputs["inp"]: x,
               prog.targets["out"].output: torch.zeros_like(x)}
    fns = {"kernel": lambda t=tensors: chain.lower(t),
           "plain": lambda t=tensors: chain.plain(t, 0),
           "library": lambda: torch.softmax(x, -1)}
    got = fns["kernel"]()[prog.targets["out"].output]
    want = fns["plain"]()[prog.targets["out"].output]
    err = assert_same("rowchain softmax 8192^2", got.cpu(), want.cpu(),
                      SOFTMAX_TOL)
    out["rowchain"] = timed(fns, chain.compiled().plan["bytes"])
    out["rowchain"]["err"] = err
    rowchain_fns = {"B6 softmax 8192^2": fns["kernel"],
                    "torch.softmax 8192^2": fns["library"]}
    print(f"rowchain softmax {n}x{n} f32: {out['rowchain']} on {gpu}")

    v, d, rows = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, v, rows).astype(np.float32)
    g = (rng.normal(size=(rows, d)) / np.sqrt(d)).astype(np.float32)
    model = egt.compile(scatter_add_graph(egt, v, d, SCATTER["tile"]),
                        seed=0, schedule_mode="force", device="cuda")
    model.call("demb", {"tok": tok, "g": g})
    ex = executor_of(model)
    (low,) = ex._lowerings.values()
    mr = low.scheduled_mapreduce()
    prog = model.program
    tok_t, g_t = torch.from_numpy(tok).to(dev), torch.from_numpy(g).to(dev)
    prev = torch.zeros(v, d, device=dev)
    tensors = {prog.inputs["tok"]: tok_t, prog.inputs["g"]: g_t,
               prog.targets["demb"].output: prev}
    tok_long = tok_t.long()
    fns = {"kernel": lambda t=tensors: mr.lower(t),
           "plain": lambda t=tensors: mr.plain(t, 0),
           "library": lambda: prev.index_add(0, tok_long, g_t)}
    err = assert_same("mapreduce scatter-add", fns["kernel"]().cpu(),
                      fns["plain"]().cpu(), GEN_SCATTER)
    out["mapreduce"] = timed(fns, mr.compiled().plan["bytes"])
    out["mapreduce"]["err"] = err
    out["mapreduce"]["host_us"] = {name: host_us(fns[name])
                                   for name in ("kernel", "library")}
    print(f"mapreduce scatter-add n={rows} v={v} d={d} f32: "
          f"{out['mapreduce']} on {gpu}")
    # the kernel and index_add on each edge's indices, for the device
    # times taken after the timed phases
    profiled = {"scatter-add uniform": fns["kernel"],
                "index_add uniform": fns["library"]}
    for kind in SCATTER_EDGES[:2]:
        skew = torch.from_numpy(scatter_tokens(kind, rows, v)).to(dev)
        edge = {**tensors, prog.inputs["tok"]: skew}
        profiled[f"scatter-add {kind}"] = lambda edge=edge: mr.lower(edge)
        profiled[f"index_add {kind}"] = (
            lambda skew=skew.long(): prev.index_add(0, skew, g_t))
    out["mapreduce"]["profiled"] = profiled
    out["rowchain"]["profiled"] = rowchain_fns
    mapreduce.launches = rowchain.launches = 0
    return out


def timed(fns, nbytes) -> dict:
    """Mean ms of each function by CUDA events, in turns, and the bound
    of the bytes it must move."""
    runs = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library",
                 "plain"):
        runs[name].append(cuda_ms(fns[name], iters=20, warmup=3))
    res = {name: sum(v) / len(v) for name, v in runs.items()}
    res["bound"] = bound(0.0, nbytes)
    return res


def path_c_programs(m):
    """The programs of examples/scheduled_kernels.py sections 3-9 at the
    example's sizes, and the two map/reduce cells of bench.py at theirs:
    (name, graph, target, inputs, the generated kernels they run)."""
    rng = np.random.default_rng(0)
    out = []
    n = SOFTMAX_N
    graph, args = softmax_chain(m, {"y": 32}, rows=n, cols=n, scale=1.0)
    out.append(("softmax 8192^2 (bench.py)", graph, "out", args,
                {"rowchain": 1}))
    v, d, rows = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    out.append(("scatter-add (bench.py)",
                scatter_add_graph(m, v, d, SCATTER["tile"]), "demb",
                {"tok": rng.integers(0, v, rows).astype(np.float32),
                 "g": (rng.normal(size=(rows, d)) / np.sqrt(d)).astype(
                     np.float32)}, {"mapreduce": 1}))
    graph, args = softmax_chain(m, {"y": 64}, rows=256, cols=512, scale=1.0)
    out.append(("softmax 256x512", graph, "out", args, {"rowchain": 1}))
    inp = m.input("inp")
    q, k = m.iters("q", "k")
    causal = m.Fun("causal")
    causal[q, k] = m.select(k <= q, inp[q, k], 0.0)
    causal.schedule(tile={"q": 64})
    out.append(("causal mask", causal.target("causal"), "causal",
                {"inp": _normal(40, (128, 128))[0]}, {"mapreduce": 1}))
    img = m.input("img")
    y = m.iters("y")
    x = m.irange("x", 0, img.shape[1] - 2)
    blur = m.Fun("blur")
    blur[y, x] = (img[y, x] + img[y, x + 1] + img[y, x + 2]) * (1.0 / 3.0)
    blur.schedule(tile={"y": 32})
    out.append(("stencil blur", blur.target("blur"), "blur",
                {"img": _normal(41, (64, 258))[0]}, {"mapreduce": 1}))
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    loss = m.Fun("loss")
    loss[0] = m.sq(a[y, x] - b[y, x])
    loss.schedule(tile={"y": 32})
    av, bv = _normal(42, (128, 256), (128, 256))
    out.append(("scalar loss", loss.target("loss"), "loss",
                {"a": av, "b": bv}, {"mapreduce": 1}))
    ta = m.input("ta")
    y = m.iters("y")
    x = m.irange("x", 0, y + 1)
    tri = m.Fun("tri")
    tri[y] = ta[y, x]
    tri.schedule(tile={"y": 32})
    out.append(("triangular row sums", tri.target("tri"), "tri",
                {"ta": _normal(43, (128, 128))[0]}, {"mapreduce": 1}))
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    rn = layers.rms_norm(m.input("rn"), 256, row_tile=32)
    out.append(("rms_norm(row_tile=32)", rn.target("rn_out"), "rn_out",
                {"rn": _normal(44, (64, 256))[0]}, {"rowchain": 1}))
    tok, table = m.input("tok"), m.input("table")
    i, d = m.iters("i", "d")
    emb = m.Fun("emb")
    emb[i, d] = table[m.to_index(tok[i]), d]
    emb.with_shape([tok.shape[0], table.shape[1]])
    emb.schedule(tile={"i": 8})
    out.append(("embedding gather", emb.target("emb"), "emb",
                {"tok": rng.integers(0, 32, 16).astype(np.float32),
                 "table": _normal(45, (32, 128))[0]}, {"mapreduce": 1}))
    ha, hx = m.input("ha"), m.input("hx")
    y2, x2 = m.iters("y2", "x2")
    hashed = m.Fun("hashed")
    hashed[y2, x2] = hx[y2, x2] * ha[(y2 * x2) % 17]
    hashed.with_shape([hx.shape[0], hx.shape[1]])
    hashed.schedule(tile={"y2": 8})
    hv, av2 = _normal(46, (16, 64), (17,))
    out.append(("hashed LUT", hashed.target("hashed"), "hashed",
                {"hx": hv, "ha": av2}, {"mapreduce": 1}))
    sv = m.input("sv")
    si, sj = m.iters("si", "sj")
    hist = m.Fun("hist")
    hist[(si + sj) % 11] = sv[si, sj]
    hist.with_shape([11])
    hist.schedule(tile={"si": 8})
    out.append(("banded histogram", hist.target("hist"), "hist",
                {"sv": _normal(47, (16, 64))[0]}, {"mapreduce": 1}))
    return out


def path_c(egt, gpu) -> dict:
    """Phase 10: the schedule DSL surface under schedule_mode="force":
    every program launches its kernels once per kernel, as its stats say,
    and matches the plain lowering on the card."""
    from exprgrad_torch.ops import mapreduce, rowchain

    programs = path_c_programs(egt)
    models = []
    for name, graph, target, args, expect in programs:
        models.append(egt.compile(graph, seed=0, schedule_mode="force",
                                  device="cuda"))
    mapreduce.launches = rowchain.launches = 0
    outs = [model.call(target, args) for model, (_, _, target, args, _)
            in zip(models, programs)]
    torch.cuda.synchronize()
    launches = {"mapreduce": mapreduce.launches,
                "rowchain": rowchain.launches}
    want_launches = {"mapreduce": 0, "rowchain": 0}
    for model, got, (name, graph, target, args, expect) in zip(
            models, outs, programs):
        stats = model.lowering_stats(target)
        assert stats == expect, (name, stats)
        for kind in want_launches:
            want_launches[kind] += stats.get(kind, 0)
        plain = egt.compile(graph, seed=0, schedule_mode="ignore",
                            device="cuda").call(target, args)
        tol = (SOFTMAX_TOL if name.startswith("softmax") else
               GEN_SCATTER if "scatter" in name or "histogram" in name
               else GEN_F32)
        err = assert_same(f"path (c) {name}", got, plain, tol)
        print(f"path (c) {name}: lowering {stats}, max |err| vs the plain "
              f"lowering {err:.3e}")
    assert launches == want_launches, (launches, want_launches)
    model, (_, _, target, args, _) = models[0], programs[0]
    model.call(target, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.call(target, args)
    call_ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"path (c): kernel launches {launches}, as the stats say; softmax "
          f"{SOFTMAX_N}^2 call (host arrays in and out) {call_ms:.2f} ms "
          f"warm on {gpu}")
    return launches


def path_d(egt, gpu) -> dict:
    """Phase 11: the flash_transformer head with row-tiled layers at the
    serving width: predict and three fit steps, against the CPU port."""
    from exprgrad_torch.ops import mapreduce, matmul, rowchain

    graph = transformer_head(egt, HEAD["dim"], HEAD["vocab"])
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    cpu = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    rows, dim, vocab = HEAD["rows"], HEAD["dim"], HEAD["vocab"]
    rng = np.random.default_rng(2)
    data = {"x": rng.standard_normal((rows * HEAD_STEPS, dim),
                                     dtype=np.float32),
            "labels": np.eye(vocab, dtype=np.float32)[
                rng.integers(0, vocab, rows * HEAD_STEPS)]}
    first = {"x": data["x"][:rows]}
    counters = (mapreduce, rowchain, matmul)
    for c in counters:
        c.launches = 0
    probs = model.call("predict", first)
    torch.cuda.synchronize()
    predict_launches = {c.__name__.split(".")[-1]: c.launches
                        for c in counters}
    stats = model.lowering_stats("predict")
    want = {"mapreduce": stats.get("mapreduce", 0),
            "rowchain": stats.get("rowchain", 0),
            "matmul": stats.get("matmul", 0) + stats.get("matmul-fused", 0)}
    assert predict_launches == want, (predict_launches, stats)
    assert predict_launches["rowchain"] == 2, stats
    cpu_probs = cpu.call("predict", first)
    assert probs.shape == (rows, vocab) and np.isfinite(probs).all()
    err = float(np.abs(probs - cpu_probs).max())
    np.testing.assert_allclose(probs, cpu_probs, **PREDICT)
    print(f"path (d) predict [{rows},{dim}] -> [{rows},{vocab}]: launches "
          f"{predict_launches}, lowering {stats}, max |err| vs the CPU port "
          f"{err:.3e}")

    start = {t: x.clone() for t, x in cpu.params.items()}
    for c in counters:
        c.launches = 0
    model.fit("train", data, batch_size=rows, log_status=False)
    torch.cuda.synchronize()
    fit_launches = {c.__name__.split(".")[-1]: c.launches for c in counters}
    train_stats = model.lowering_stats("train")
    per_step = {"mapreduce": train_stats.get("mapreduce", 0),
                "rowchain": train_stats.get("rowchain", 0),
                "matmul": train_stats.get("matmul", 0)
                + train_stats.get("matmul-fused", 0)}
    assert fit_launches == {k: HEAD_STEPS * v for k, v in per_step.items()}, (
        fit_launches, train_stats)
    assert per_step["mapreduce"] >= 1 and per_step["rowchain"] >= 1, \
        train_stats
    cpu.fit("train", data, batch_size=rows, log_status=False)
    batch = {"x": data["x"][:rows], "labels": data["labels"][:rows]}
    loss = float(model.call("loss", batch)[0])
    cpu_loss = float(cpu.call("loss", batch)[0])
    rel, worst = update_err(model.params, cpu.params, start)
    print(f"path (d) fit {HEAD_STEPS} steps: launches {fit_launches} "
          f"({per_step} per step), lowering {train_stats}; loss {loss:.6f} "
          f"vs CPU {cpu_loss:.6f}; parameters vs CPU: |diff| / |update| "
          f"{rel:.3e}, max |diff| {worst:.3e}")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel

    model.epoch += 1
    batch = {"x": data["x"][:rows], "labels": data["labels"][:rows]}
    model.apply("train", batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.apply("train", batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"path (d) train step [{rows},{dim}]: {step_ms:.2f} ms (mean of "
          f"{TIMED_STEPS} warm steps) on {gpu}")
    return {"predict": predict_launches, "fit": fit_launches}


# --- paged serving: kernel B7 and the continuous batcher (phase 12) -------

def paged_case(gen, dev, b, h, hkv, t, d, P, page, dtype, n_pages=None,
               lens=None, q_dtype=torch.float32, seed=0, scale=1.0):
    """Inputs of paged decode attention: a pool of random values in every
    page (garbage where nothing was written), a page table of distinct
    pages per row with -1 past each row's length, ``key_pos`` live below
    the length and -1 after it, ``q_pos`` the last ``t`` positions; an
    int8 pool's scales uniform in [0.5, 1.5) times ``scale``.
    Returns (q, pool, table, key_pos, q_pos) on ``dev``."""
    from exprgrad_torch.ops.paged import PagedKVPool

    rng = np.random.default_rng(seed)
    n_pages = n_pages or 4 * P
    shape = (n_pages, hkv, page, d)
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3], generator=gen, device=dev) + 0.5)
                  * scale for _ in range(2))
        pool = PagedKVPool(k=k, v=v, k_scale=ks, v_scale=vs)
    else:
        pool = PagedKVPool(*(torch.randn(shape, generator=gen, device=dev)
                             .to(dtype) for _ in range(2)))
    lens = (rng.integers(t, P * page, b) if lens is None
            else np.asarray(lens))
    table = np.full((b, P), -1, np.int32)
    free = rng.permutation(n_pages)
    used = 0
    for i in range(b):
        n = -(-int(lens[i]) // page)
        table[i, :n] = free[used:used + n]
        used += n
    slots = np.arange(P * page)
    key_pos = np.where(slots[None] < lens[:, None], slots[None], -1)
    q_pos = (lens[:, None] - t + np.arange(t)[None])
    q = torch.randn((b, h, t, d), generator=gen, device=dev).to(q_dtype)
    return (q, pool, torch.as_tensor(table, device=dev),
            torch.as_tensor(key_pos.astype(np.int32), device=dev),
            torch.as_tensor(q_pos.astype(np.int32), device=dev))


def paged_bound(q, pool, table, key_pos, q_pos, window=None) -> tuple:
    """The bound of one paged-attention call on these inputs: the bytes of
    q, the out, the table and positions and the resident pages' K and V
    (and scales), each read or written once; the multiply-adds of QK and
    PV over the (query, key) pairs that attend (4d flops a pair)."""
    b, h, t, d = q.shape
    _, hkv, page, _ = pool.k.shape
    resident = int((table >= 0).sum()) * hkv * page
    kv = 2 * resident * d * pool.k.element_size()
    if pool.k_scale is not None:
        kv += 2 * resident * 4
    small = 2 * q.numel() * q.element_size() + 4 * (
        table.numel() + key_pos.numel() + q_pos.numel())
    kp = key_pos.long()[:, None, :]
    qp = q_pos.long()[:, :, None]
    keep = (kp >= 0) & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    pairs = int(keep.sum()) * h
    return bound(4.0 * d * pairs, kv + small)


def check_paged_kernel(gen, dev) -> float:
    """Phase 12 (a): B7 against its plain version on the card, on the seven
    cases of tests/test_paged_attention.py, the serving decode step, bench.py's
    shape, and the edges (rows over one block, a page of 12, a head_dim
    with no 16-byte rows, bfloat16 queries, a row with no live key).
    Returns the largest |kernel - plain| over the cases."""
    from exprgrad_torch.ops import paged_attention as pa

    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    cases = [  # name, (b, h, hkv, t, d, P, page, pool dtype), window, extra
        ("mha", (2, 4, 4, 1, 128, 4, 64, f32), None, {}),
        ("gqa", (2, 4, 2, 1, 128, 4, 64, f32), None, {}),
        ("mqa d64", (2, 8, 1, 1, 64, 3, 32, f32), None, {}),
        ("t=3", (2, 4, 2, 3, 64, 4, 64, f32), None, {}),
        ("window 40", (2, 4, 4, 1, 128, 4, 64, f32), 40, {}),
        ("int8 + scales", (1, 4, 2, 2, 128, 3, 128, i8), None, {}),
        ("bf16 pages, window 24", (2, 2, 2, 2, 32, 4, 16, bf16), 24, {}),
        ("serving decode step", PAGED_SERVING_CASE, None,
         dict(n_pages=33, lens=PAGED_SERVING_LENS)),
        ("bench.py paged shape", PAGED_BENCH_CASE, None,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_BENCH_LENS)),
        ("12 rows, page 12, d 40, window 20",
         (2, 8, 2, 3, 40, 5, 12, bf16), 20, {}),
        ("bf16 queries, int8 d 48", (3, 4, 2, 1, 48, 4, 16, i8), None,
         dict(q_dtype=bf16)),
        # the splits' edges, at bench.py's shape (6 splits of 3 pages): live
        # pages that end inside a split, rows whose later splits hold no
        # resident page (129 and 1 slots), a window that ends inside a
        # split, int8 pages across all six splits
        ("bench.py shape, rows ending mid-split and splits with no "
         "resident page", PAGED_BENCH_CASE, None,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS)),
        ("bench.py shape, window 500", PAGED_BENCH_CASE, 500,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_BENCH_LENS)),
        # scales as ops.decode._quantize makes them (absmax / 127): keys of
        # order one.  With scales near 1 the dequantized keys reach +-190,
        # the scores +-200, and a softmax that sharp moves its output by
        # 1e-2 when float32 rounding moves a score by 1e-4 (both versions
        # sum the 128 products in other orders)
        ("bench.py shape, int8 pages", PAGED_BENCH_CASE[:-1] + (i8,), None,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS,
              scale=1 / 127)),
        ("a one-entry table (P = 1)", (4, 8, 2, 1, 128, 1, 64, bf16), None,
         {}),
        ("2048-slot rows at page 16", (4, 4, 2, 2, 64, 128, 16, bf16), None,
         dict(n_pages=4 * 128 + 1, lens=(2048, 2048, 1999, 2040))),
    ]
    worst = 0.0
    for i, (name, shape, window, extra) in enumerate(cases):
        q, pool, table, key_pos, q_pos = paged_case(gen, dev, *shape,
                                                    seed=i, **extra)
        if name.startswith("bf16 queries"):
            key_pos[1] = -1          # row 1 sees no key: 0 on both
        got = pa.paged_decode_attention(q, pool, table, key_pos, q_pos,
                                        window=window)
        again = pa.paged_decode_attention(q, pool, table, key_pos, q_pos,
                                          window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"paged {name}: two runs differ"
        want = pa.paged_decode_attention_plain(q, pool, table, key_pos,
                                               q_pos, window=window)
        tol = F32_OUT if q.dtype == torch.float32 else BF16_OUT
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"paged {name}: {m}")
        err = (got.float() - want.float()).abs().max().item()
        if name.startswith("bf16 queries"):
            assert torch.all(got[1] == 0), "a row with no key is not 0"
        worst = max(worst, err)
        print(f"kernel check paged {name}: two runs equal bit for bit, "
              f"max |err| {err:.3e} "
              f"(q {tuple(q.shape)} {str(q.dtype)[6:]}, pool "
              f"{tuple(pool.k.shape)} {str(pool.k.dtype)[6:]}, "
              f"{int((table >= 0).sum())} resident pages)")
    # int8 pages at bench.py's shape with scales near 1 (keys up to +-190,
    # scores up to +-200), the data the int8 case above leaves out: a
    # softmax this sharp turns one float32 rounding of a score into 1e-4 to
    # 1e-3 of output, so the kernel and the plain version are each held
    # against the same formula in float64, beside that formula with each
    # score rounded once to float32 (printed, not asserted: which float32
    # order lands nearer varies with the data by ten times and more)
    q, pool, table, key_pos, q_pos = paged_case(
        gen, dev, *PAGED_BENCH_CASE[:-1], i8, seed=len(cases),
        n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS)
    got = pa.paged_decode_attention(q, pool, table, key_pos, q_pos)
    want = pa.paged_decode_attention_plain(q, pool, table, key_pos, q_pos)
    exact = paged_float64(q, pool, table, key_pos, q_pos)
    once = paged_float64(q, pool, table, key_pos, q_pos, round_scores=True)
    assert torch.isfinite(got).all()
    print(f"kernel check paged bench.py shape, int8 pages with scales near "
          f"1: max |out - float64 formula| kernel "
          f"{(got.double() - exact).abs().max().item():.3e}, plain "
          f"{(want.double() - exact).abs().max().item():.3e}, the formula "
          f"with each score rounded once to float32 "
          f"{(once - exact).abs().max().item():.3e}; max |kernel - plain| "
          f"{(got - want).abs().max().item():.3e}")
    return worst


def paged_float64(q, pool, table, key_pos, q_pos, round_scores=False):
    """The plain version's formula (gather_view, dequantize, softmax of the
    masked scores, P.V; 0 where a row sees no key) in float64; with
    ``round_scores`` each scaled score is rounded once to float32."""
    from exprgrad_torch.ops.paged import gather_view

    view = gather_view(pool, table.clamp(min=0))
    b, h, t, d = q.shape
    hkv, n = view.k.shape[1], view.k.shape[2]
    k, v = view.k.double(), view.v.double()
    if view.k_scale is not None:
        k = k * view.k_scale.double()[..., None]
        v = v * view.v_scale.double()[..., None]
    qg = q.double().reshape(b, hkv, h // hkv * t, d)
    s = torch.einsum("bgqd,bgsd->bgqs", qg, k).reshape(b, h, t, n) * d ** -0.5
    if round_scores:
        s = s.float().double()
    kp = key_pos.long()[:, None, None, :]
    mask = (kp >= 0) & (kp <= q_pos.long()[:, None, :, None])
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    p = torch.nan_to_num(p, nan=0.0)  # rows that see no key
    out = torch.einsum("bgqs,bgsd->bgqd", p.reshape(b, hkv, -1, n), v)
    return out.reshape(b, h, t, d)


def time_paged_kernel(gen, dev, gpu, name, shape, lens, n_pages) -> dict:
    """Phase 12 (b): B7 at one shape beside its plain version and the
    library route (gather_view, then scaled_dot_product_attention with a
    boolean mask: two calls), with CUDA events, in turns."""
    from exprgrad_torch.ops import paged_attention as pa
    from exprgrad_torch.ops.paged import gather_view

    q, pool, table, key_pos, q_pos = paged_case(gen, dev, *shape, lens=lens,
                                                n_pages=n_pages)
    h, hkv = q.shape[1], pool.k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = ((key_pos[:, None, None, :] >= 0)
            & (key_pos[:, None, None, :] <= q_pos[:, None, :, None]))
    clamped = table.clamp(min=0)
    gqa = {"enable_gqa": True} if h != hkv else {}

    def library():
        view = gather_view(pool, clamped)
        return sdpa(q, view.k.to(q.dtype), view.v.to(q.dtype),
                    attn_mask=mask, **gqa)

    fns = {"kernel": lambda: pa.paged_decode_attention(
               q, pool, table, key_pos, q_pos),
           "plain": lambda: pa.paged_decode_attention_plain(
               q, pool, table, key_pos, q_pos),
           "library": library}
    torch.testing.assert_close(fns["library"](), fns["plain"](), **F32_OUT)
    runs = {k: [] for k in fns}
    for which in ("plain", "library", "kernel", "kernel", "library",
                  "plain"):
        runs[which].append(cuda_ms(fns[which], iters=50, warmup=5))
    res = {k: sum(v) / len(v) for k, v in runs.items()}
    res["runs"] = runs
    res["host_us"] = {k: host_us(fns[k]) for k in ("kernel", "library")}
    res["profiled"] = {"kernel": fns["kernel"], "library": library}
    res["bound"] = paged_bound(q, pool, table, key_pos, q_pos)
    res["err"] = (fns["kernel"]() - fns["plain"]()).abs().max().item()
    print(f"paged attention {name}: kernel {res['kernel']:.5f} ms, plain "
          f"{res['plain']:.5f} ms, gather_view + scaled_dot_product_attention"
          f" (two calls) {res['library']:.5f} ms, bound "
          f"{res['bound'][0]:.5f} ms ({res['bound'][1]}); runs {runs}; "
          f"host us per call {res['host_us']} on {gpu}")
    return res


def _percentiles(values) -> str:
    p50, p90 = np.percentile(np.asarray(values), [50, 90])
    return f"p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms"


def staggered_mix(vocab):
    """bench.py's staggered mix from seed 0: (prompts, budgets)."""
    rng = np.random.default_rng(0)
    n = MIX["n"]
    sizes = rng.integers(*MIX["prompt"], n)
    budgets = [int(x) for x in rng.integers(*MIX["budget"], n)]
    prompts = [rng.integers(0, vocab, s).astype(np.float32) for s in sizes]
    return prompts, budgets


def drive_mix(server, kind, prompts, budgets):
    """Serve the mix through ``ContinuousBatcher(server, attention=kind,
    **BATCHER)``: half the requests up front, then one more before each
    ``step()``.  Returns (streams in submission order, the batcher, the
    seconds from its construction to the last token, synchronized, the
    number of ``step()`` calls)."""
    from exprgrad_torch.models import ContinuousBatcher

    n = len(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = ContinuousBatcher(server, attention=kind, **BATCHER)
    rids = [b.submit(p, m) for p, m in zip(prompts[:n // 2],
                                          budgets[:n // 2])]
    out, steps = {}, 0
    while len(out) < n:
        if len(rids) < n:
            i = len(rids)
            rids.append(b.submit(prompts[i], budgets[i]))
        out.update(b.step())
        steps += 1
    torch.cuda.synchronize()
    return [out[r] for r in rids], b, time.perf_counter() - t0, steps


def path_e(egt, gpu) -> dict:
    """Phase 12 (c): the continuous batcher over a paged pool at the serving
    width, through kernel B7 (``attention="flash"``) and through the
    gathered view (``"gather"``), under bench.py's staggered mix."""
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    from exprgrad_torch.ops import (attention, mapreduce, matmul,
                                    paged_attention, rowchain)

    counters = (attention, matmul, mapreduce, rowchain, paged_attention)
    model = egt.compile(flash_transformer(**SERVING), seed=0, device="cuda")
    vocab, blocks = SERVING["vocab"], SERVING["blocks"]
    prompts, budgets = staggered_mix(vocab)
    n = len(prompts)

    def drive(server, kind):
        """The mix with the kernels' counters at 0 just before; returns
        (streams, batcher, seconds, B7 launches)."""
        for c in counters:
            c.launches = 0
        streams, b, secs, _ = drive_mix(server, kind, prompts, budgets)
        launches = paged_attention.launches
        others = sum(c.launches for c in counters[:-1])
        stats = b.stats
        want = blocks * stats["dispatches"] if kind == "flash" else 0
        assert launches == want, (kind, launches, stats)
        assert others == 0, others
        assert stats["preemptions"] > 0, stats
        assert stats["free_pages"] == stats["pool_pages"], stats
        for s, m in zip(streams, budgets):
            assert s.shape == (m,), (s.shape, m)
            assert np.all((s >= 0) & (s < vocab))
        return streams, b, secs, launches

    # float32 cache: flash, gather and solo serving give the same greedy
    # streams, but where float32 reassociation flips a near-tie
    srv32 = FlashLMServer(model, cache_dtype=torch.float32)
    flash32, b32, _, l32 = drive(srv32, "flash")
    gather32, _, _, _ = drive(srv32, "gather")
    solo = [srv32.generate(p[None], n_new=m)[0].cpu().numpy().astype(
        np.int64) for p, m in zip(prompts, budgets)]
    parted = []
    for i, (f, g, s) in enumerate(zip(flash32, gather32, solo)):
        differ = np.flatnonzero((f != g) | (f != s))
        if not differ.size:
            continue
        j = int(differ[0])
        seq = np.concatenate([prompts[i], s[:j].astype(np.float32)])
        logits, _ = srv32.prefill(seq[None], srv32.init_caches(1))
        top = torch.topk(logits[0, -1], 2).values
        margin = float(top[0] - top[1])
        parted.append((i, j, margin))
        print(f"path (e) float32 request {i}: streams part at token {j} "
              f"(flash {f[j]}, gather {g[j]}, solo {s[j]}); solo top-2 "
              f"logit margin {margin:.3e}")
        assert margin <= NEAR_TIE, (i, j, margin)
    print(f"path (e) float32 cache: {n - len(parted)} of {n} greedy streams "
          f"equal across flash, gather and solo; stats {b32.stats}; B7 "
          f"launches {l32} = {blocks} blocks x {b32.stats['dispatches']} "
          f"dispatches")

    # the default bfloat16 cache: a warm drive of each, then the timed ones
    srv = FlashLMServer(model)
    drive(srv, "flash")
    drive(srv, "gather")
    res = {}
    for kind in ("flash", "gather"):
        streams, b, secs, launches = drive(srv, kind)
        tokens = sum(len(s) for s in streams)
        m = b.request_metrics()
        res[kind] = dict(streams=streams, secs=secs, launches=launches,
                         stats=b.stats, tokens=tokens)
        print(f"path (e) {kind} (bf16 cache): {tokens} tokens in {secs:.3f} s"
              f": {tokens / secs:.1f} tokens/s, {n / secs:.2f} requests/s, "
              f"ttft {_percentiles([r['ttft_s'] for r in m])}, latency "
              f"{_percentiles([r['latency_s'] for r in m])}; "
              f"{secs / b.stats['dispatches'] * 1e3:.2f} ms per decode "
              f"dispatch; "
              f"stats {b.stats}; B7 launches {launches} on {gpu}")
    same = sum(np.array_equal(a, b) for a, b in zip(
        res["flash"]["streams"], res["gather"]["streams"]))
    print(f"path (e) bf16 cache: {same} of {n} streams equal between flash "
          f"and gather")
    return {"launches": res["flash"]["launches"], "parted": parted,
            "same_bf16": same}


def phase_done(name, since) -> float:
    """Print a phase's seconds; returns the time it ended."""
    now = time.perf_counter()
    print(f"phase {name}: {now - since:.1f} s")
    return now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import exprgrad_torch as egt
    from exprgrad_torch.io import load_model, save_model
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    import exprgrad_torch.layers  # noqa: F401  (egt.layers in builders)
    from exprgrad_torch.ops import attention, matmul
    from exprgrad_torch.utils import kernels, triton_build

    gpu = gpu_line()
    dev = torch.device("cuda")
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{kernels.library_path()} (host of {gpu}); nvcc seconds by "
          f"file {kernels.compile_seconds}")
    if kernels.build_log.strip():
        print(kernels.build_log.strip())

    t_phase = phase_done("1 (build)", t0)

    # 2. kernel against its plain version -------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = flash_cases(gen, dev)
    slice_err = check_flash_forward(attention, cases)
    q, k, v = cases[0][1]
    fwd_times = time_flash_forward(attention, q, k, v, gpu)
    kernel_ms, plain_ms = fwd_times["kernel"], fwd_times["plain"]
    sdpa_ms = fwd_times["library"]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # the backward kernels against their plain version, then their times
    bwd_err = check_flash_backward(attention, cases, gen, dev)
    q, k, v = cases[0][1]
    bwd_times = time_flash_backward(attention, q, k, v, gen, dev, gpu)
    (bf16_case,) = (c for c in cases if c[0] == "serving shape bf16 causal")
    time_flash_backward(attention, *bf16_case[1], gen, dev, gpu)
    att_bounds = attention_bounds(*q.shape[:3], q.shape[3])
    print(f"flash bounds {att_bounds} on {gpu}")

    t_phase = phase_done("2 (flash kernels)", t_phase)

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
    attention.launches = matmul.launches = 0
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

    t_phase = phase_done("3 and 4 (predict, serve)", t_phase)

    # 5. train -------------------------------------------------------------
    data = lm_data(np.random.default_rng(0), SERVING["vocab"], TRAIN_SEQS,
                   SEQ)
    first = {name: value[:BATCH] for name, value in data.items()}
    assert model.epoch == cpu_model.epoch == 0
    # the main path of training: two steps as a user makes them; each runs
    # the forward, dq and dkv kernels once per block
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    matmul.launches = 0
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

    t_phase = phase_done("5 (train)", t_phase)

    # 6. the scheduled matmul kernel against its plain version -----------
    mm_err = check_matmul_kernel(gen, dev)
    mm_times = time_matmul(gen, dev, MATMUL_N, gpu)

    t_phase = phase_done("6 (matmul kernel)", t_phase)

    # 7. and 8. the scheduled paths, each with the counters at 0 ---------
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    path_a_launches = path_a(egt, matmul, gpu)
    path_b_launches = path_b(egt, matmul, gpu)
    mm_launches = path_a_launches + sum(path_b_launches.values())
    print(f"scheduled paths: matmul kernel launches path (a) "
          f"{path_a_launches}, path (b) {path_b_launches}")

    t_phase = phase_done("7 and 8 (paths (a), (b))", t_phase)

    # 9. the generated kernels against their plain versions ----------------
    gen_err = check_generated_kernels(egt, gpu)
    gen_err["mapreduce"] = max(gen_err["mapreduce"], check_scatter_cases(egt))
    gen_times = time_generated_kernels(egt, gpu)
    t_phase = phase_done(f"9 (generated kernels; Triton compiled for "
                         f"{triton_build.compile_seconds:.1f} s)", t_phase)

    # 10. and 11. the map/reduce paths, each with the counters at 0 -------
    path_c_launches = path_c(egt, gpu)
    t_phase = phase_done("10 (path (c))", t_phase)
    path_d_launches = path_d(egt, gpu)
    t_phase = phase_done("11 (path (d))", t_phase)
    gen_launches = {
        kind: path_c_launches[kind] + sum(
            run[kind] for run in path_d_launches.values())
        for kind in ("mapreduce", "rowchain")}
    print(f"map/reduce paths: generated kernel launches path (c) "
          f"{path_c_launches}, path (d) {path_d_launches}; Triton compiled "
          f"for {triton_build.compile_seconds:.1f} s in all")

    # 12. paged serving: B7 against its plain version, its times, and
    # path (e) with the counters at 0 ------------------------------------
    paged_err = check_paged_kernel(gen, dev)
    paged_times = {
        "serving": time_paged_kernel(
            gen, dev, gpu, "serving decode step [8,4,1,128], bf16 pool "
            "33x4x32x128", PAGED_SERVING_CASE, PAGED_SERVING_LENS, 33),
        "bench": time_paged_kernel(
            gen, dev, gpu, "bench.py shape [8,8,1,128], bf16 pool "
            "129x8x128x128", PAGED_BENCH_CASE, PAGED_BENCH_LENS,
            PAGED_BENCH_PAGES)}
    path_e_run = path_e(egt, gpu)
    phase_done("12 (paged attention, path (e))", t_phase)
    q, k, v = cases[0][1]
    print(f"scaled_dot_product_attention [8,4,256,128] f32 causal runs "
          f"{kernel_names(lambda: sdpa(q, k, v, is_causal=True))}")
    # its backward by device time, which settles the library's figure
    # for dq and dkv without autograd's host work
    sdpa_bwd = device_kernels(sdpa_backward(
        q, k, v, torch.randn(q.shape, generator=gen, device=dev)))
    sdpa_bwd_ms = sum(sdpa_bwd.values())
    print(f"scaled_dot_product_attention backward [8,4,256,128] f32 causal "
          f"runs, device ms per call: {sdpa_bwd}; {sdpa_bwd_ms:.5f} ms in "
          f"all on {gpu}")
    # B5, B6 and B7 by device time: every kernel one call launches (B5's
    # keys, sort and searchsorted, and the segment walk;
    # index_add's clone and kernel; B6 and torch.softmax; B7's splits and
    # merge; the library route's gather and sdpa)
    profiled = {f"B5 {name}": fn for name, fn in
                gen_times["mapreduce"]["profiled"].items()}
    profiled.update(gen_times["rowchain"]["profiled"])
    for shape, res in paged_times.items():
        profiled[f"B7 {shape}"] = res["profiled"]["kernel"]
        profiled[f"B7 library {shape}"] = res["profiled"]["library"]
    device_ms = {}
    for name, fn in profiled.items():
        per_kernel = device_kernels(fn)
        device_ms[name] = sum(per_kernel.values())
        print(f"device ms per call, {name}: {device_ms[name]:.5f} "
              f"({ {k[:60]: round(v, 5) for k, v in per_kernel.items()} }) "
              f"on {gpu}")
    skew = (device_ms["B5 scatter-add all on one destination"]
            / device_ms["B5 scatter-add uniform"])
    print(f"B5 scatter-add: all indices on one destination takes {skew:.2f}x "
          f"the uniform case's device time")
    print(f"the whole run {time.perf_counter() - t_start:.1f} s")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu"))
    assert not loaded, f"the port imported {loaded}"

    def row(name, source, replaces, launches, err, ms, plain, library,
            bound_of, route="cuda"):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound_of[0], "bound_by": bound_of[1],
                "library_ms": library}

    print(gpu)
    print(json.dumps({"kernels": [
        row("flash_attention_forward", "exprgrad_torch/csrc/flash_fwd.cu",
            "exprgrad_tpu/ops/attention.py:293", launches, slice_err,
            kernel_ms, plain_ms, sdpa_ms, att_bounds["forward"]),
        row("flash_attention_backward_dq", "exprgrad_torch/csrc/flash_bwd.cu",
            "exprgrad_tpu/ops/attention.py:375", train_launches["dq"],
            bwd_err[0], bwd_times["dq"], bwd_times["plain"], sdpa_bwd_ms,
            att_bounds["dq"]),
        row("flash_attention_backward_dkv",
            "exprgrad_torch/csrc/flash_bwd.cu",
            "exprgrad_tpu/ops/attention.py:444", train_launches["dkv"],
            bwd_err[1], bwd_times["dkv"], bwd_times["plain"], sdpa_bwd_ms,
            att_bounds["dkv"]),
        row("scheduled_matmul", "exprgrad_torch/csrc/matmul.cu",
            "exprgrad_tpu/ops/matmul.py:24", mm_launches, mm_err,
            mm_times["kernel"], mm_times["plain"], mm_times["library"],
            mm_times["bound"]),
        row("scheduled_mapreduce", "exprgrad_torch/ops/mapreduce.py",
            "exprgrad_tpu/backend/pallasgen.py:1804", gen_launches[
                "mapreduce"], max(gen_err["mapreduce"],
                                  gen_times["mapreduce"]["err"]),
            gen_times["mapreduce"]["kernel"], gen_times["mapreduce"]["plain"],
            gen_times["mapreduce"]["library"], gen_times["mapreduce"]["bound"],
            route="triton"),
        row("scheduled_rowchain", "exprgrad_torch/ops/rowchain.py",
            "exprgrad_tpu/backend/pallasgen.py:2375", gen_launches[
                "rowchain"], max(gen_err["rowchain"],
                                 gen_times["rowchain"]["err"]),
            gen_times["rowchain"]["kernel"], gen_times["rowchain"]["plain"],
            gen_times["rowchain"]["library"], gen_times["rowchain"]["bound"],
            route="triton"),
        row("paged_decode_attention", "exprgrad_torch/csrc/paged_attention.cu",
            "exprgrad_tpu/ops/paged_attention.py:78", path_e_run["launches"],
            max(paged_err, paged_times["bench"]["err"]),
            paged_times["bench"]["kernel"], paged_times["bench"]["plain"],
            paged_times["bench"]["library"], paged_times["bench"]["bound"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
