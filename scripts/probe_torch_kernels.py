"""Probe the port's hand-written kernels on one GPU.

    python3 scripts/probe_torch_kernels.py [--out FILE] [--parts LIST]
        [--variants LIST | --skip-variants] [--root DIR]

Parts (``--parts``, default ``tensor,power,b5,b7``), random inputs from
seed 0:

1. tensor: flash forward (B2, exprgrad_torch/csrc/flash_fwd.cu) and the
   backward's dq (B3) and dk/dv (B4) kernels (csrc/flash_bwd.cu) at the
   serving shape [8, 4, 256, 128] causal, float32 and bfloat16, beside
   scaled_dot_product_attention and its backward; the scheduled matmul
   (B1, csrc/matmul.cuh) at 4096^3 float32 beside torch.matmul (TF32
   off).  For each: the host us per call of the Python entry point
   (enqueue rate, no synchronize) and chip_smoke.py's CUDA-event ms per
   call, both before the first profiler session, then the kernels'
   device ms per call by torch.profiler; sdpa's backward also by its
   kernels' names.
2. power: two seconds of back-to-back B1 calls, then of torch.matmul,
   with nvidia-smi sampling the SM clock, power draw and temperature.
3. b5: the generated scatter (B5, exprgrad_torch/ops/mapreduce.py) at
   bench.py's scatter-add (n=16384, v=2048, d=512, float32) through
   ``mapreduce_impl``, uniform and with every index on one destination,
   beside ``index_add``: host us per call, CUDA events, device ms of
   every kernel a call launches; and B6's softmax 8192^2 host us per
   call.  ``host`` (not in the default) gives only host figures, through
   calls the port has had since it ran B5 and B6 (and B2's forward and
   B1, the torch.library ops of this port's later checkouts), so that
   ``--root`` can point at an older checkout.
   ``ops`` (not in the default) gives only B2's forward and B1's host
   figures, the median and range of five rounds, without Triton.
   ``b5map`` (not in the default): B5's map/reduce template at path
   (d)'s five train-step kernels and the calibration's tiny map
   [16, 64], row reduction 8192^2 and elementwise map 8192^2, each
   through ``mapreduce_impl``: device ms of every kernel a call launches
   (torch.profiler), host us per call, CUDA events, the bound, and the
   torch call of the same traffic (chip_smoke.py's ``_library_twin``).
   It runs against ``--root``'s package too.
   ``gemm`` (not in the default): the einsum path's float32 contractions
   on B1's Hopper mainloop (csrc/gemm_sm90.cu, ``ops.matmul.contract``)
   at the training cell's shapes (Codestral-22B's widths, 4,096 tokens)
   in each layout: device ms of its split pre-passes and of its GEMM
   (torch.profiler), CUDA events of the whole call, the bound (3 x 2 m n
   k over 495 TFLOP/s), torch.einsum's device ms (TF32 off), and B1's
   ``mma.sync`` mainloop (``matmul_impl``, default block) at the same
   m, n, k with contiguous [m, k] and [k, n] operands.
4. b7: paged decode attention (B7, csrc/paged_attention.cu) at bench.py's
   paged shape and at path (e)'s decode step, beside its library route
   (gather_view, then scaled_dot_product_attention): as b5.
5. variants (``--variants``, default fwd,bwd, any of fwd, bwd, b5, b7;
   none with ``--skip-variants``):
   flash_fwd.cu rebuilt with other tile constants (kBlockQ, kSplit,
   kBlockK, kStages) and with parts cut out (no Q.K^T, no P.V, no load of
   the next tile; their outputs are wrong), and flash_bwd.cu rebuilt with
   parts cut out (no first products S and dP, no products at all, no
   load of the next tile), each as its own library beside the port's, and
   timed by torch.profiler at the serving shape, causal and not (the
   backward's dq and dkv kernels apart).  b5: each step of a scatter
   alone (the keys kernel; the keys, then torch.sort and
   torch.searchsorted; those two alone; the walk, pieces of long
   segments included, without the grouping step) and the walk with its position loads cut
   (contiguous positions, no gather through the permutation).  b7: one split (no merge), a split a page, the port's
   split, and the scoring and P.V cut out (loads only).

Summary lines name the card and its power limit; --out (default
build/probe_torch_kernels.txt) gets them too.  Needs a CUDA device and
nvcc; imports no jax.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if "--root" in sys.argv:  # another checkout's package and chip_smoke
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1])
                           .resolve()))
else:
    sys.path.insert(0, str(ROOT))

from chip_smoke import (cuda_ms, device_kernels, gpu_line,  # noqa: E402
                        sdpa_backward)

SERVING = (8, 4, 256, 128)
MATMUL_N = 4096
# name -> (tile constants, cuts)
VARIANTS = {
    "port": ({}, ()),
    "q64 split2": ({"kBlockQ": 64, "kSplit": 2}, ()),
    "q64 split2 k32 stages4": (
        {"kBlockQ": 64, "kSplit": 2, "kBlockK": 32, "kStages": 4}, ()),
    "q32 split2 k32": ({"kSplit": 2, "kBlockK": 32}, ()),
    "cut Q.K^T": ({}, ("qk",)),
    "cut P.V": ({}, ("pv",)),
    "cut both": ({}, ("qk", "pv")),
    "cut next-tile loads": ({}, ("load",)),
}
CUTS = {
    "qk": ("qk<kD>(s, s_q + wr * L::kQK, s_qs + wr * L::kQK, "
           "tk + wc * L::kQK, g, t);",
           "s[0][0] = (float)tk[lane] + (float)s_q[lane];"),
    "pv": ("pv<kD, kSTiles, L::kV>(o, s, alpha, tv + wc * L::kV, g, t);",
           "o[0][0] += s[0][0] + s[kSTiles - 1][3] + (float)tv[lane];"),
    "load": ("    if (ahead <= band.hi) {", "    if (false) {"),
}
# flash_bwd.cu: name -> cuts, each a (regex, replacement) on the source
# (cutting only the second products would let the compiler drop the
# first, whose results then go unused: that is "cut all products")
BWD_VARIANTS = {
    "port": (),
    "cut S and dP": ("abt",),
    "cut all products": ("pv",),
    "cut next-tile loads": ("load",),
}
BWD_CUTS = {
    "abt": [(r"(void abt\([^{]*\{)", r"\1\n  if (kD > 0) return;")],
    "pv": [(r"pv<kD, kNT, ld>\([^;]*\);", ";")],
    "load": [(r"if \(ahead <= band\.hi\) issue", "if (false) issue"),
             (r"if \(ahead < turns\) issue", "if (false) issue")],
}


def device_ms(fn, name_part, calls=20) -> float:
    """Device ms per launch of the kernels whose name holds name_part
    (each call launches one), over the launches the profiler recorded:
    it can drop events, so dividing by the calls made would read low."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name_part in e.key]
    count = sum(e.count for e in events)
    if not count:
        return float("nan")
    return sum(e.self_device_time_total for e in events) / count / 1e3


def host_us(fn, calls=200) -> float:
    """Host microseconds per call, enqueue only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def times(say, gen, dev):
    from exprgrad_torch.ops import attention, matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []  # (label, fn, kernel name part or None for all, calls)
    for dtype, lib_part in ((torch.float32, "fmha"),
                            (torch.bfloat16, "flash")):
        q, k, v, g = (torch.randn(SERVING, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        out, lse = attention.flash_attention_forward(q, k, v, causal=True)
        _, delta = attention.flash_bwd_dq(q, k, v, out, lse, g, causal=True)
        label = f"{list(SERVING)} {str(dtype)[6:]} causal"
        cases += [(f"B2 {label}", lambda q=q, k=k, v=v:
                   attention.flash_attention_forward(q, k, v, causal=True),
                   "flash_fwd", 50),
                  (f"sdpa {label}", lambda q=q, k=k, v=v:
                   sdpa(q, k, v, is_causal=True), lib_part, 50),
                  (f"B3 dq {label}", lambda q=q, k=k, v=v, o=out, l=lse,
                   g=g: attention.flash_bwd_dq(q, k, v, o, l, g,
                                               causal=True),
                   "flash_bwd_dq", 50),
                  (f"B4 dkv {label}", lambda q=q, k=k, v=v, l=lse, dl=delta,
                   g=g: attention.flash_bwd_dkv(q, k, v, l, dl, g,
                                                causal=True),
                   "flash_bwd_dkv", 50),
                  (f"sdpa backward {label}", sdpa_backward(q, k, v, g),
                   None, 50)]
    a, b = (torch.randn(MATMUL_N, MATMUL_N, generator=gen, device=dev)
            for _ in range(2))
    cases += [(f"B1 {MATMUL_N}^3 float32", lambda: matmul.matmul_impl(a, b),
               "matmul_kernel", 10),
              (f"torch.matmul {MATMUL_N}^3 float32",
               lambda: torch.matmul(a, b), "gemm", 10)]
    # host clock and CUDA events before any profiler session
    clocks = {label: (host_us(fn, calls=4 * calls),
                      cuda_ms(fn, iters=calls, warmup=2))
              for label, fn, _, calls in cases}
    for label, fn, part, calls in cases:
        host, events = clocks[label]
        if part is None:  # every kernel of the call, by name
            named = device_kernels(fn, calls=calls // 2)
            say(f"{label}: device {sum(named.values()):.5f} ms "
                f"({named}), host {host:.1f} us per call, CUDA events "
                f"{events:.5f} ms")
            continue
        say(f"{label}: device {device_ms(fn, part, calls=calls // 2):.5f} "
            f"ms, host {host:.1f} us per call, CUDA events {events:.5f} ms")


def power(say, gen, dev, seconds=2.0):
    from exprgrad_torch.ops import matmul

    a, b = (torch.randn(MATMUL_N, MATMUL_N, generator=gen, device=dev)
            for _ in range(2))
    query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"]
    for name, fn in (("B1", lambda: matmul.matmul_impl(a, b)),
                     ("torch.matmul", lambda: torch.matmul(a, b))):
        fn()
        torch.cuda.synchronize()
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                samples.append(subprocess.run(
                    query, capture_output=True, text=True,
                    timeout=30).stdout.strip())
                time.sleep(0.2)

        thread = threading.Thread(target=sample)
        thread.start()
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            fn()
            calls += 1
            if calls % 20 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / calls * 1e3
        stop.set()
        thread.join()
        say(f"{name} {MATMUL_N}^3 float32 for {seconds} s: {ms:.4f} ms per "
            f"call; SM clock, power, temperature: {samples}")


def build_variants(out_dir: Path, source: str, entries: tuple,
                   edits: dict) -> dict:
    """Build each variant of csrc/``source`` (name -> a function of the
    source text) as its own library, one nvcc each, all started together;
    returns {name: {entry: ctypes function}} with the C entry points
    renamed per variant."""
    from exprgrad_torch.utils import kernels

    text0 = (ROOT / "exprgrad_torch/csrc" / source).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for i, (name, edit) in enumerate(edits.items()):
        text = edit(text0)
        for entry in entries:
            assert f'extern "C" int {entry}(' in text, entry
            text = text.replace(f'extern "C" int {entry}(',
                                f'extern "C" int {entry}_v{i}(')
        stem = f"{Path(source).stem}_v{i}"
        src, lib = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        src.write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS,
               f"-I{ROOT / 'exprgrad_torch/csrc'}", "-shared", "-o",
               str(lib), str(src)]
        builds[name] = (i, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (i, lib, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        fns[name] = {}
        for entry in entries:
            fn = getattr(ctypes.CDLL(str(lib)), f"{entry}_v{i}")
            fn.argtypes = kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[name][entry] = fn
    return fns


def fwd_edit(consts, cuts):
    def edit(text):
        for const, value in consts.items():
            text, n = re.subn(rf"constexpr int {const} = [^;]*;",
                              f"constexpr int {const} = {value};", text)
            assert n == 1, const
        for cut in cuts:
            old, new = CUTS[cut]
            assert old in text, cut
            text = text.replace(old, new)
        return text
    return edit


def regex_edit(cuts):
    """A source edit that applies each (pattern, replacement), each of
    which must match."""
    def edit(text):
        for pattern, repl in cuts:
            text, n = re.subn(pattern, repl, text)
            assert n >= 1, pattern
        return text
    return edit


def variants(say, gen, dev, out_dir):
    from exprgrad_torch.utils import kernels

    fns = build_variants(out_dir, "flash_fwd.cu", ("egt_flash_fwd",), {
        name: fwd_edit(*spec) for name, spec in VARIANTS.items()})
    b, h, s, d = SERVING
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(SERVING, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        for causal in (True, False):
            res = {}
            for _ in range(2):  # two turns, in the same order
                for name, entry in fns.items():
                    fn = entry["egt_flash_fwd"]
                    out = torch.empty_like(q)
                    lse = torch.empty(b * h, s, device=dev)
                    stream = torch.cuda.current_stream().cuda_stream

                    def call(fn=fn, out=out, lse=lse, stream=stream):
                        kernels.check(fn(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), b, h, h, s, s, d,
                            d ** -0.5, int(causal), 0, 0, 0,
                            0 if dtype == torch.float32 else 1, stream),
                            "variant")

                    res.setdefault(name, []).append(
                        round(device_ms(call, "flash_fwd"), 5))
            say(f"variants {list(SERVING)} {str(dtype)[6:]} "
                f"{'causal' if causal else 'not causal'}, device ms per "
                f"call, two turns: {res}")


def bwd_variants(say, gen, dev, out_dir):
    from exprgrad_torch.ops import attention
    from exprgrad_torch.utils import kernels

    entries = ("egt_flash_bwd_dq", "egt_flash_bwd_dkv")
    fns = build_variants(out_dir, "flash_bwd.cu", entries, {
        name: regex_edit([c for cut in cuts for c in BWD_CUTS[cut]])
        for name, cuts in BWD_VARIANTS.items()})
    b, h, s, d = SERVING
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (torch.randn(SERVING, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        code = 0 if dtype == torch.float32 else 1
        for causal in (True, False):
            out, lse = attention.flash_attention_forward(q, k, v,
                                                         causal=causal)
            _, delta = attention.flash_bwd_dq(q, k, v, out, lse, g,
                                              causal=causal)
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            scratch = torch.empty_like(delta)
            stream = torch.cuda.current_stream().cuda_stream
            res = {}
            for _ in range(2):  # two turns, in the same order
                for name, fn in fns.items():
                    def call_dq(fn=fn["egt_flash_bwd_dq"]):
                        kernels.check(fn(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), g.data_ptr(), lse.data_ptr(),
                            scratch.data_ptr(), dq.data_ptr(), b, h, h, s,
                            s, d, d ** -0.5, int(causal), 0, 0, 0, code,
                            stream), "variant")

                    def call_dkv(fn=fn["egt_flash_bwd_dkv"]):
                        kernels.check(fn(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), b, h, h, s, s, d,
                            d ** -0.5, int(causal), 0, 0, 0, code, stream),
                            "variant")

                    res.setdefault(name, []).append(
                        (round(device_ms(call_dq, "flash_bwd_dq"), 5),
                         round(device_ms(call_dkv, "flash_bwd_dkv"), 5)))
            say(f"backward variants {list(SERVING)} {str(dtype)[6:]} "
                f"{'causal' if causal else 'not causal'}, device ms per "
                f"call (dq, dkv), two turns: {res}")


def scatter_call(gen_dev):
    """bench.py's scatter-add model on the card: (the B5 kernel object,
    its tensors, the index_add call on them)."""
    import numpy as np
    import exprgrad_torch as egt
    import exprgrad_torch.layers  # noqa: F401
    from chip_smoke import SCATTER, executor_of, scatter_add_graph

    v, d, n = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, v, n).astype(np.float32)
    g = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    model = egt.compile(scatter_add_graph(egt, v, d, SCATTER["tile"]),
                        seed=0, schedule_mode="force", device="cuda")
    model.call("demb", {"tok": tok, "g": g})
    (low,) = executor_of(model)._lowerings.values()
    mr = low.scheduled_mapreduce()
    prog = model.program
    tok_t = torch.from_numpy(tok).to(gen_dev)
    g_t = torch.from_numpy(g).to(gen_dev)
    prev = torch.zeros(v, d, device=gen_dev)
    tensors = {prog.inputs["tok"]: tok_t, prog.inputs["g"]: g_t,
               prog.targets["demb"].output: prev}
    return mr, tensors, (lambda: prev.index_add(0, tok_t.long(), g_t)), \
        (prog.inputs["tok"], tok_t, g_t, prev)


def softmax_call(dev):
    import exprgrad_torch as egt
    import exprgrad_torch.layers  # noqa: F401
    from chip_smoke import SOFTMAX_N, executor_of, softmax_chain

    n = SOFTMAX_N
    graph, args = softmax_chain(egt, {"y": 32}, rows=n, cols=n, scale=1.0)
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    model.call("out", args)
    (chain,) = executor_of(model).row_fused.values()
    x = torch.from_numpy(args["inp"]).to(dev)
    prog = model.program
    tensors = {prog.inputs["inp"]: x,
               prog.targets["out"].output: torch.zeros_like(x)}
    return lambda: chain.lower(tensors)


def gather_call(dev):
    """A B5 kernel that is no scatter (the classifier's gather family)."""
    import exprgrad_torch as egt
    from chip_smoke import MAPREDUCE_FAMILIES, executor_of

    graph, args = MAPREDUCE_FAMILIES["gather"](egt)
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    model.call("out", args)
    ex = executor_of(model)
    (low,) = ex._lowerings.values()
    mr = low.scheduled_mapreduce()
    prog = model.program
    out = prog.targets["out"].output
    tensors = {prog.inputs[k]: torch.from_numpy(v).to(dev)
               for k, v in args.items()}
    tensors[out] = torch.zeros(ex.shapes[out], device=dev)
    return lambda: mr.lower(tensors)


def host(say, dev):
    """Host us per call of B5's scatter-add, a B5 gather and B6's softmax
    entry points, and of B2's forward (the serving shape, causal, and
    [1,1,64,64], whose device time is far below the host's) and B1
    (256^3, bare and with chip_smoke's relu-and-row-bias epilogue), each
    through the entry point the port has had since it ran the kernel (no
    synchronize inside the timed calls)."""
    from chip_smoke import epilogue
    from exprgrad_torch.ops import attention, matmul

    mr, tensors, _, _ = scatter_call(dev)
    gather = gather_call(dev)
    softmax = softmax_call(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn(8, 4, 256, 128, generator=gen, device=dev)
               for _ in range(3))
    qs = torch.randn(1, 1, 64, 64, generator=gen, device=dev)
    a = torch.randn(256, 256, generator=gen, device=dev)
    bias = torch.randn(256, generator=gen, device=dev)
    relu_row = epilogue([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
                         ("const", 3, 0, 0, 0), ("le", 4, 3, 2, 0),
                         ("select", 5, 4, 2, 3), ("mov", 0, 5, 0, 0)],
                        (0.0,), ("row",))
    fns = {
        "B2 forward": lambda: attention.flash_attention_forward(
            q, k, v, causal=True),
        "B2 forward [1,1,64,64]": lambda: attention.flash_attention_forward(
            qs, qs, qs, causal=True),
        "B1": lambda: matmul.matmul_impl(a, a),
        "B1 relu+bias": lambda: matmul.matmul_impl(
            a, a, epilogue=relu_row, extra=[bias]),
    }
    fused = ", ".join(f"{name} {host_us(fn, calls=1000):.1f}"
                      for name, fn in fns.items())
    say(f"host us per call: B5 scatter-add "
        f"{host_us(lambda: mr.lower(tensors)):.1f}, B5 gather "
        f"{host_us(gather):.1f}, B6 softmax 8192^2 {host_us(softmax):.1f}, "
        f"{fused} (package at "
        f"{Path(sys.modules['exprgrad_torch'].__file__).parents[1]})")


def ops_host(say, dev, rounds=5, calls=2000):
    """Host us per call of B2's forward and B1 through their entry points
    (``host``'s four calls, without B5 and B6): the median and the range
    of ``rounds`` rounds of ``calls`` calls each."""
    from chip_smoke import epilogue
    from exprgrad_torch.ops import attention, matmul

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn(8, 4, 256, 128, generator=gen, device=dev)
               for _ in range(3))
    qs = torch.randn(1, 1, 64, 64, generator=gen, device=dev)
    a = torch.randn(256, 256, generator=gen, device=dev)
    bias = torch.randn(256, generator=gen, device=dev)
    relu_row = epilogue([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
                         ("const", 3, 0, 0, 0), ("le", 4, 3, 2, 0),
                         ("select", 5, 4, 2, 3), ("mov", 0, 5, 0, 0)],
                        (0.0,), ("row",))
    fns = {
        "B2 forward": lambda: attention.flash_attention_forward(
            q, k, v, causal=True),
        "B2 forward [1,1,64,64]": lambda: attention.flash_attention_forward(
            qs, qs, qs, causal=True),
        "B1": lambda: matmul.matmul_impl(a, a),
        "B1 relu+bias": lambda: matmul.matmul_impl(
            a, a, epilogue=relu_row, extra=[bias]),
    }
    parts = []
    for name, fn in fns.items():
        runs = sorted(host_us(fn, calls=calls) for _ in range(rounds))
        parts.append(f"{name} {runs[len(runs) // 2]:.2f} "
                     f"({runs[0]:.2f}-{runs[-1]:.2f})")
    say(f"ops host us per call, median (range) of {rounds} x {calls}: "
        f"{', '.join(parts)} (package at "
        f"{Path(sys.modules['exprgrad_torch'].__file__).parents[1]})")


def timed_line(say, label, fn, calls=50):
    hs, ev = host_us(fn), cuda_ms(fn, iters=calls, warmup=5)
    named = device_kernels(fn, calls=calls // 2)
    say(f"{label}: device {sum(named.values()):.5f} ms "
        f"({ {k[:60]: round(t, 5) for k, t in named.items()} }), host "
        f"{hs:.1f} us per call, CUDA events {ev:.5f} ms")


def gemm(say, dev):
    from chip_smoke import CELL_GEMMS, gemm_plan
    from exprgrad_torch.ops import matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    for label, spec, sa, sb in CELL_GEMMS:
        plan, out_shape, (batch, m, n, k) = gemm_plan(spec, sa, sb)
        a = torch.randn(sa, device=dev)
        b = torch.randn(sb, device=dev)
        ops = 2.0 * batch * m * n * k
        bound = 3 * ops / 495e12 * 1e3
        named = device_kernels(
            lambda: matmul.contract(a, b, plan, out_shape), calls=10)
        split = sum(t for name, t in named.items() if "split" in name)
        main = sum(t for name, t in named.items() if "gemm" in name)
        ev = cuda_ms(lambda: matmul.contract(a, b, plan, out_shape),
                     iters=10, warmup=2)
        lib = sum(device_kernels(lambda: torch.einsum(spec, a, b),
                                 calls=10).values())
        del a, b
        x = torch.randn(m, k, device=dev)
        w = torch.randn(k, n, device=dev)
        old = sum(device_kernels(lambda: matmul.matmul_impl(x, w),
                                 calls=5).values())
        del x, w
        say(f"gemm {label} ({spec}, {plan.layout}, m {m} n {n} k {k}): "
            f"einsum-b1 device {split + main:.4f} ms (split {split:.4f}, "
            f"GEMM {main:.4f}: {ops / main / 1e9:.1f} TFLOP/s float32-"
            f"exact, {100 * bound / main:.1f}% of its bound), CUDA events "
            f"{ev:.4f} ms, bound {bound:.4f} ms; torch.einsum device "
            f"{lib:.4f} ms ({ops / lib / 1e9:.1f} TFLOP/s); B1 mma.sync "
            f"device {old:.4f} ms")
        torch.cuda.empty_cache()


def b5(say, dev):
    from chip_smoke import scatter_tokens

    mr, tensors, index_add, (tok_id, tok_t, g_t, prev) = scatter_call(dev)
    timed_line(say, "B5 scatter-add uniform", lambda: mr.lower(tensors))
    timed_line(say, "index_add uniform", index_add)
    skew = torch.from_numpy(scatter_tokens("all on one destination",
                                           tok_t.numel(), prev.shape[0]))
    skew = skew.to(dev)
    edge = {**tensors, tok_id: skew}
    timed_line(say, "B5 scatter-add all on one destination",
               lambda: mr.lower(edge))
    timed_line(say, "index_add all on one destination",
               lambda: prev.index_add(0, skew.long(), g_t))
    host(say, dev)


def _step_kernels(dev):
    """Path (d)'s train-step B5 kernels (chip_smoke.py's
    ``time_step_kernels``): {label: (lowering, kernel, tensors, epoch)},
    each kernel with the tensors one step hands it."""
    import numpy as np
    import exprgrad_torch as egt
    import exprgrad_torch.layers  # noqa: F401
    from chip_smoke import HEAD, transformer_head
    from exprgrad_torch.ops import mapreduce

    graph = transformer_head(egt, HEAD["dim"], HEAD["vocab"])
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    rows, dim, vocab = HEAD["rows"], HEAD["dim"], HEAD["vocab"]
    rng = np.random.default_rng(2)
    batch = {"x": rng.standard_normal((rows, dim), dtype=np.float32),
             "labels": np.eye(vocab, dtype=np.float32)[
                 rng.integers(0, vocab, rows)]}
    model.epoch = 1
    model.apply("train", batch)
    (ex,) = [ex for (name, _), ex in model._executors.items()
             if name == "train"]
    lows = {}
    for i, low in ex._lowerings.items():
        if (i in ex._skip_kernels or i in ex.fused or i in ex.row_fused
                or low.kernel.extern is not None or not low._bounds_ok
                or low.scheduled_route() != "mapreduce"):
            continue
        lows[id(low.scheduled_mapreduce().compiled())] = low
    seen, real = {}, mapreduce.mapreduce_impl

    def spy(kern, tensors, epoch):
        if id(kern) in lows and id(kern) not in seen:
            seen[id(kern)] = (lows[id(kern)], kern,
                              {t: tensors[t].clone() for t in kern.args},
                              epoch)
        return real(kern, tensors, epoch)

    mapreduce.mapreduce_impl = spy
    try:
        model.apply("train", batch)
    finally:
        mapreduce.mapreduce_impl = real
    torch.cuda.synchronize()
    out = {}
    for low, kern, tensors, epoch in seen.values():
        shapes = [tuple(low.shapes[r.tensor]) for r in low.kernel.reads]
        label = (f"path (d) {low._kernel_desc()} {shapes} -> "
                 f"{tuple(low.shapes[low.kernel.write.tensor])}")
        out[label] = (low, kern, tensors, epoch)
    assert len(out) == len(lows) == 5, (len(out), len(lows))
    return out


def _calibration_kernels(dev):
    """The calibration's three B5 cases (scripts/calibrate_torch.py
    ``_map``, ``_row_sum``): {label: (lowering, kernel, tensors, 1)}."""
    import numpy as np
    import exprgrad_torch as egt
    from chip_smoke import executor_of

    def build(rows, cols, reduce, seed):
        inp = egt.input("inp")
        y, x = egt.iters("y", "x")
        out = egt.Fun("out")
        if reduce:
            out[y] = inp[y, x]
        else:
            out[y, x] = egt.exp(inp[y, x]) + 1.0
        out.schedule(tile={"y": 16})
        v = np.random.default_rng(seed).standard_normal((rows, cols))
        return out.target("out"), {"inp": v.astype(np.float32)}

    out = {}
    for label, rows, cols, reduce, seed in (
            ("tiny map [16, 64]", 16, 64, False, 1),
            ("row reduction 8192^2", 8192, 8192, True, 2),
            ("elementwise map 8192^2", 8192, 8192, False, 1)):
        graph, args = build(rows, cols, reduce, seed)
        model = egt.compile(graph, seed=0, schedule_mode="force",
                            device="cuda")
        model.call("out", args)
        ex = executor_of(model)
        (low,) = ex._lowerings.values()
        kern = low.scheduled_mapreduce().compiled()
        prog = model.program
        tensors = {prog.inputs["inp"]: torch.from_numpy(args["inp"]).to(dev)}
        tensors[prog.targets["out"].output] = torch.zeros(
            ex.shapes[prog.targets["out"].output], device=dev)
        out[f"calibration {label}"] = (low, kern, tensors, 1)
    return out


def b5map(say, dev):
    """B5's map/reduce template (no scatter) at path (d)'s five step
    kernels and three calibration cases, through ``mapreduce_impl``: the
    device ms of every kernel a call launches (torch.profiler), host us a
    call (enqueue only), CUDA-event ms a call, the bound (bytes over
    3.35 TB/s) and the torch call of the same traffic (chip_smoke.py's
    ``_library_twin``: events and device ms).  The host and event figures
    come before any profiler session.  Works against the package of
    ``--root`` (any checkout whose chip_smoke.py has ``_library_twin``)."""
    from chip_smoke import PEAK_HBM_BYTES, _library_twin
    from exprgrad_torch.ops import mapreduce

    cases = {**_step_kernels(dev), **_calibration_kernels(dev)}
    rows = []
    for label, (low, kern, tensors, epoch) in cases.items():
        mr = low.scheduled_mapreduce()
        fn = (lambda kern=kern, tensors=tensors, epoch=epoch:
              mapreduce.mapreduce_impl(kern, tensors, epoch))
        twin, lib = _library_twin(mr, tensors)
        rows.append((label, mr, kern, fn, twin, lib,
                     host_us(fn), cuda_ms(fn, iters=50, warmup=5),
                     cuda_ms(lib, iters=50, warmup=5)))
    for label, mr, kern, fn, twin, lib, hs, ev, lib_ev in rows:
        named = device_kernels(fn, calls=25)
        lib_named = device_kernels(lib, calls=25)
        plan = {k: v for k, v in kern.plan.items()
                if k in ("grid", "block_p", "block_q", "num_warps", "splits",
                         "lane", "combine_grid")}
        say(f"b5map {label}: device {sum(named.values()):.5f} ms "
            f"({ {k[:40]: round(t, 5) for k, t in named.items()} }), host "
            f"{hs:.1f} us per call, CUDA events {ev:.5f} ms, bound "
            f"{mr.total_bytes / PEAK_HBM_BYTES * 1e3:.5f} ms "
            f"({mr.total_bytes} bytes), {twin} events {lib_ev:.5f} ms "
            f"device {sum(lib_named.values()):.5f} ms; plan {plan}")
    say(f"b5map package at "
        f"{Path(sys.modules['exprgrad_torch'].__file__).parents[1]}")


def b7_cases(dev):
    from chip_smoke import (PAGED_BENCH_CASE, PAGED_BENCH_LENS,
                            PAGED_BENCH_PAGES, PAGED_SERVING_CASE,
                            PAGED_SERVING_LENS, paged_case)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return {"bench.py paged shape": paged_case(
                gen, dev, *PAGED_BENCH_CASE, lens=PAGED_BENCH_LENS,
                n_pages=PAGED_BENCH_PAGES),
            "path (e) decode step": paged_case(
                gen, dev, *PAGED_SERVING_CASE, lens=PAGED_SERVING_LENS,
                n_pages=33)}


def b7(say, dev):
    from exprgrad_torch.ops import paged_attention as pa
    from exprgrad_torch.ops.paged import gather_view

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (q, pool, table, key_pos, q_pos) in b7_cases(dev).items():
        mask = ((key_pos[:, None, None, :] >= 0)
                & (key_pos[:, None, None, :] <= q_pos[:, None, :, None]))
        gqa = {"enable_gqa": True} if q.shape[1] != pool.k.shape[1] else {}

        def library(q=q, pool=pool, table=table, mask=mask, gqa=gqa):
            view = gather_view(pool, table.clamp(min=0))
            return sdpa(q, view.k.to(q.dtype), view.v.to(q.dtype),
                        attn_mask=mask, **gqa)

        timed_line(say, f"B7 {name}", lambda q=q, pool=pool, table=table,
                   key_pos=key_pos, q_pos=q_pos: pa.paged_decode_attention(
                       q, pool, table, key_pos, q_pos))
        timed_line(say, f"gather_view + sdpa {name}", library)


def b5_variants(say, dev):
    """Each step of B5's scatter alone, and the walk without its gather
    through the permutation: device ms and host us per call."""
    from exprgrad_torch.ops import mapreduce as om
    from exprgrad_torch.utils import triton_build

    mr, tensors, _, _ = scatter_call(dev)
    kern = mr.compiled()
    plan = kern.plan
    ops = [tensors[t].contiguous() for t in kern.tids]
    out = torch.empty_like(tensors[kern.out_tid])
    ws = om.group(kern, ops, 0, dev)
    part = torch.empty(max(plan["part"], 1), device=dev)
    counts = torch.zeros(max(plan["counts"], 1), dtype=torch.int32,
                         device=dev)

    def fn(name, source=kern.source):
        return triton_build.load(source, name)

    def keys_kernel():
        triton_build.launch(fn("egt_scatter_keys"), (plan["keys_grid"],), 4,
                            ws["keys"], *ops, 0)

    rows = torch.arange(plan["K"] + 1, dtype=ws["keys"].dtype, device=dev)

    def sort_only():
        skeys, _ = torch.sort(ws["keys"], stable=True)
        torch.searchsorted(skeys, rows, out_int32=True)

    contiguous = kern.source.replace(
        "p = tl.load(perm_ptr + s, mask=s_ok, other=0).to(tl.int32)",
        "p = s")
    assert contiguous != kern.source

    def walk(source=kern.source):
        triton_build.launch(fn("egt_mapreduce", source), plan["grid"],
                            plan["num_warps"], out, part, counts,
                            ws["sorted"], ws["perm"], ws["offsets"], *ops,
                            0)

    res, hosts = {}, {}
    for _ in range(2):  # two turns, in the same order
        for name, call in (("whole call", lambda: mr.lower(tensors)),
                           ("keys kernel", keys_kernel),
                           ("grouping (keys, then torch.sort and "
                            "torch.searchsorted)",
                            lambda: om.group(kern, ops, 0, dev)),
                           ("torch.sort and torch.searchsorted", sort_only),
                           ("walk (no grouping step)", walk),
                           ("walk, contiguous positions",
                            lambda: walk(contiguous))):
            named = device_kernels(call, calls=20)
            res.setdefault(name, []).append(round(sum(named.values()), 5))
            hosts.setdefault(name, []).append(round(host_us(call), 1))
    say(f"B5 variants at bench.py's scatter-add, device ms per call, two "
        f"turns: {res}")
    say(f"B5 variants at bench.py's scatter-add, host us per call, two "
        f"turns: {hosts}")


B7_CUTS = {
    "loads only": [(r"consume\(ring, kp, ksc, vsc\);",
                    "acc[0][0] += (float)ring[lane] + "
                    "(float)ring[2 * kChunk * rowb - 1 - lane];")],
    # q.k in two levels, a partial per 16 bytes of K (16-byte rows only)
    "two-level q.k": [
        (r"(unpack16\(\*reinterpret_cast<const uint4\*>\(krow \+ u \* 16\), "
         r"kf, TKV\(\)\);)", r"\1\n        float part[ROWS] = {};"),
        (r"s\[rr\] = fmaf\(s_q\[rr \* kMaxD \+ u \* kV \+ x\], kc, "
         r"s\[rr\]\);\n        \}\n",
         "part[rr] = fmaf(s_q[rr * kMaxD + u * kV + x], kc, part[rr]);\n"
         "        }\n        for (int rr = 0; rr < ROWS; ++rr) "
         "s[rr] += part[rr];\n")],
}


def int8_distance(say, dev, fns):
    """At bench.py's paged shape with int8 pages whose scales are near 1
    (scores up to +-200): the distance of the plain version and of each
    build's kernel from the same formula in float64, beside that of the
    formula with each score rounded once to float32 (``one rounding``)."""
    from chip_smoke import (PAGED_BENCH_CASE, PAGED_BENCH_PAGES,
                            PAGED_SPLIT_LENS, paged_case, paged_float64)
    from exprgrad_torch.ops import paged_attention as pa
    from exprgrad_torch.utils import kernels

    gen = torch.Generator(device=dev)
    res = {}
    for seed in range(4):
        gen.manual_seed(seed)
        q, pool, table, key_pos, q_pos = paged_case(
            gen, dev, *PAGED_BENCH_CASE[:-1], torch.int8,
            n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS)
        exact = paged_float64(q, pool, table, key_pos, q_pos)
        outs = {"one rounding": paged_float64(q, pool, table, key_pos, q_pos,
                                              round_scores=True),
                "plain": pa.paged_decode_attention_plain(
                    q, pool, table, key_pos, q_pos)}
        b, h, t, d = q.shape
        hkv, page = pool.k.shape[1], pool.k.shape[2]
        P = table.shape[1]
        rows = h // hkv * t
        n_split, per = pa.split_plan(
            P, page, b * hkv * -(-rows // pa.rows_per_block(rows)),
            torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty(n_split * b * hkv * rows * (d + 2), device=dev)
        for name, entry in fns.items():
            out = outs[name] = torch.empty_like(q)
            kernels.check(entry["egt_paged_decode"](
                q.data_ptr(), pool.k.data_ptr(), pool.v.data_ptr(),
                pool.k_scale.data_ptr(), pool.v_scale.data_ptr(),
                table.data_ptr(), key_pos.data_ptr(), q_pos.data_ptr(),
                out.data_ptr(), part.data_ptr(), b, h, hkv,
                pool.k.shape[0], t, d, page, P, d ** -0.5, 0, 1, n_split,
                per, 0, 2, torch.cuda.current_stream().cuda_stream),
                "variant")
        for name, out in outs.items():
            res.setdefault(name, []).append(
                f"{(out.double() - exact).abs().max().item():.3e}")
    say(f"B7 int8 pages with scales near 1 at bench.py's paged shape, max "
        f"|out - float64 formula|, seeds 0-3: {res}")


def b7_variants(say, dev, out_dir):
    """B7 with one split (no merge) and the port's split, then rebuilt with
    parts cut out, by device time."""
    from exprgrad_torch.ops import paged_attention as pa
    from exprgrad_torch.utils import kernels

    edits = {"port": lambda text: text}
    for name, cuts in B7_CUTS.items():
        edits[name] = regex_edit(cuts)
    fns = build_variants(out_dir, "paged_attention.cu", ("egt_paged_decode",),
                         edits)
    int8_distance(say, dev, {n: fns[n] for n in ("port", "two-level q.k")})
    for case, (q, pool, table, key_pos, q_pos) in b7_cases(dev).items():
        b, h, t, d = q.shape
        hkv, page = pool.k.shape[1], pool.k.shape[2]
        P = table.shape[1]
        rows = h // hkv * t
        blocks = b * hkv * -(-rows // pa.rows_per_block(rows))
        plan = pa.split_plan(P, page, blocks,
                             torch.cuda.get_device_properties(
            dev).multi_processor_count)
        out = torch.empty_like(q)
        part = torch.empty(P * b * hkv * rows * (d + 2), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        res = {}
        for _ in range(2):
            for name, entry in fns.items():
                for split, (n_split, per) in (("one split", (1, P)),
                                              ("a split a page", (P, 1)),
                                              ("split", plan)):
                    if name != "port" and split != "split":
                        continue
                    fn = entry["egt_paged_decode"]

                    def call(fn=fn, n_split=n_split, per=per):
                        kernels.check(fn(
                            q.data_ptr(), pool.k.data_ptr(),
                            pool.v.data_ptr(), None, None, table.data_ptr(),
                            key_pos.data_ptr(), q_pos.data_ptr(),
                            out.data_ptr(), part.data_ptr(), b, h, hkv,
                            pool.k.shape[0], t, d, page, P, d ** -0.5, 0, 1,
                            n_split, per, 0, 1, stream), "variant")

                    named = device_kernels(call, calls=20)
                    res.setdefault(f"{name}, {split} {n_split}", []).append(
                        round(sum(named.values()), 5))
        say(f"B7 variants at {case} (q {tuple(q.shape)}, bf16 pool "
            f"{tuple(pool.k.shape)}), device ms per call, two turns: {res}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/probe_torch_kernels.txt")
    ap.add_argument("--parts", default="tensor,power,b5,b7",
                    help="any of tensor, power, b5, b5map, b7, host, "
                    "ops, gemm")
    ap.add_argument("--skip-variants", action="store_true")
    ap.add_argument("--variants", default="fwd,bwd",
                    help="which kernels' variants to time: fwd, bwd, b5, b7")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose exprgrad_torch and chip_smoke "
                    "run (read before the imports)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    gpu = gpu_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        def say(line):
            line = f"{line} on {gpu}"
            print(line, flush=True)
            out.write(line + "\n")

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        parts = set(args.parts.split(","))
        if "tensor" in parts:
            times(say, gen, dev)
        if "power" in parts:
            power(say, gen, dev)
        if "b5map" in parts:
            b5map(say, dev)
        if "gemm" in parts:
            gemm(say, dev)
        if "b5" in parts:
            b5(say, dev)
        elif "host" in parts:
            host(say, dev)
        if "ops" in parts:
            ops_host(say, dev)
        if "b7" in parts:
            b7(say, dev)
        which = set() if args.skip_variants else set(
            args.variants.split(","))
        out_dir = ROOT / "build" / "exprgrad_torch" / "probe_variants"
        if "fwd" in which:
            variants(say, gen, dev, out_dir)
        if "bwd" in which:
            bwd_variants(say, gen, dev, out_dir)
        if "b5" in which:
            b5_variants(say, dev)
        if "b7" in which:
            b7_variants(say, dev, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
