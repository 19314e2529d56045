"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve,
train, and run scheduled contractions.

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
   the CPU; and the time of a train step;
6. hold the scheduled matmul kernel (B1) against its plain version at
   4096^3, ragged 30x50x70 and 1000^3, a transposed store, each extra
   operand pattern of the epilogue (row bias, col broadcast, full
   residual, with relu and select) and bfloat16 inputs, and time it at
   4096^3 beside torch.matmul (TF32 off);
7. path (a): c[y,x] = a[y,it]*b[it,x] at 4096^3 float32 with
   schedule(tile 512), compiled with schedule_mode="force": one kernel
   launch per call, lowering {"matmul": 1}, the product against
   torch.matmul in float64;
8. path (b): a scheduled MLP at the flash_transformer FFN width (dense
   512->2048, relu, dense 2048->512, residual add, squared error, adam)
   on [2048, 512] rows: predict folds bias, relu and the residual into
   two kernel launches (matmul-fused 2) and matches the CPU port; three
   fit steps agree with the CPU port; the time of a train step.

Each path runs with the kernels' launch counters set to 0 just before
it and read just after.  It needs a CUDA device and the rest of the
repository; without either it fails.  The line before the last is the
JSON list of kernels (time, bound, plain and library times); the last
line is a JSON object naming the device.
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

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SERVING = dict(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
               max_seq=256)
BATCH, SEQ, PROMPT, NEW = 8, 256, 128, 128
TRAIN_SEQS, TRAIN_EPOCHS, TIMED_STEPS = 32, 3, 5
# the scheduled paths: the repo's matmul cell (bench.py) and an MLP at
# the serving model's FFN width on 8 x 256 token rows
MATMUL_N, MATMUL_TILE = 4096, 512
MLP = dict(dim=512, hidden=2048, tile=128)
MLP_ROWS, MLP_STEPS = 2048, 3


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


def bound(flops: float, nbytes: float) -> tuple:
    """(the least milliseconds the card could take, what bounds it): the
    operations over the float32 peak or the bytes over HBM's rate."""
    op_ms = flops / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def attention_bounds(b, h, s, d) -> dict:
    """Bounds of the flash kernels at a causal [b, h, s, d] float32 call:
    multiply-adds over the live (row, key) pairs only (s(s+1)/2 of s^2),
    each input read once and each output written once.  Per live pair
    the forward does QK and PV (4d flops), dq recomputes S and does dP
    and dS.K (6d), dkv recomputes S and does P^T.dO, dP and dS^T.Q (8d)."""
    pairs = b * h * s * (s + 1) / 2
    full, rows = b * h * s * d * 4, b * h * s * 4
    return {
        "forward": bound(4 * d * pairs, 3 * full + full + rows),
        "dq": bound(6 * d * pairs, 5 * full + rows + full + rows),
        "dkv": bound(8 * d * pairs, 4 * full + 2 * rows + 2 * full),
    }


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
    out["bound"] = bound(2.0 * n ** 3, 3 * n * n * 4)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    from exprgrad_torch.io import load_model, save_model
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    import exprgrad_torch.layers  # noqa: F401  (egt.layers in builders)
    from exprgrad_torch.ops import attention, matmul
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
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    print(f"flash fwd [8,4,256,128] f32 causal: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (runs {times}), "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms on {gpu}")

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
    # the library's backward alone: the graph is kept and walked again
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = sdpa(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), g, retain_graph=True))
    del qg, kg, vg, sdpa_out
    att_bounds = attention_bounds(*q.shape[:3], q.shape[3])
    print(f"flash bwd [8,4,256,128] f32 causal: dq {dq_ms:.4f} ms, "
          f"dkv {dkv_ms:.4f} ms, plain backward (dq, dk, dv) "
          f"{plain_bwd_ms:.4f} ms (runs {bwd_times}), "
          f"scaled_dot_product_attention backward (dq, dk, dv) "
          f"{sdpa_bwd_ms:.4f} ms; bounds {att_bounds} on {gpu}")

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

    # 6. the scheduled matmul kernel against its plain version -----------
    mm_err = check_matmul_kernel(gen, dev)
    mm_times = time_matmul(gen, dev, MATMUL_N, gpu)

    # 7. and 8. the scheduled paths, each with the counters at 0 ---------
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    path_a_launches = path_a(egt, matmul, gpu)
    path_b_launches = path_b(egt, matmul, gpu)
    mm_launches = path_a_launches + sum(path_b_launches.values())
    print(f"scheduled paths: matmul kernel launches path (a) "
          f"{path_a_launches}, path (b) {path_b_launches}")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu"))
    assert not loaded, f"the port imported {loaded}"

    def row(name, source, replaces, launches, err, ms, plain, library,
            bound_of):
        return {"name": name, "route": "cuda", "source": source,
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
            bwd_err[0], dq_ms, plain_bwd_ms, sdpa_bwd_ms, att_bounds["dq"]),
        row("flash_attention_backward_dkv",
            "exprgrad_torch/csrc/flash_bwd.cu",
            "exprgrad_tpu/ops/attention.py:444", train_launches["dkv"],
            bwd_err[1], dkv_ms, plain_bwd_ms, sdpa_bwd_ms,
            att_bounds["dkv"]),
        row("scheduled_matmul", "exprgrad_torch/csrc/matmul.cu",
            "exprgrad_tpu/ops/matmul.py:24", mm_launches, mm_err,
            mm_times["kernel"], mm_times["plain"], mm_times["library"],
            mm_times["bound"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
