"""Probe the port's tensor-core kernels B1-B4 on one GPU.

    python3 scripts/probe_torch_kernels.py [--out FILE] [--skip-variants]

Three parts, random inputs from seed 0:

1. times: flash forward (B2, exprgrad_torch/csrc/flash_fwd.cu) and the
   backward's dq (B3) and dk/dv (B4) kernels (csrc/flash_bwd.cu) at the
   serving shape [8, 4, 256, 128] causal, float32 and bfloat16, beside
   scaled_dot_product_attention and its backward; the scheduled matmul
   (B1, csrc/matmul.cu) at 4096^3 float32 beside torch.matmul (TF32
   off).  For each: the host us per call of the Python entry point
   (enqueue rate, no synchronize) and chip_smoke.py's CUDA-event ms per
   call, both before the first profiler session, then the kernels'
   device ms per call by torch.profiler; sdpa's backward also by its
   kernels' names.
2. power: two seconds of back-to-back B1 calls, then of torch.matmul,
   with nvidia-smi sampling the SM clock, power draw and temperature.
3. variants (--variants fwd,bwd; none with --skip-variants):
   flash_fwd.cu rebuilt with other tile constants (kBlockQ, kSplit,
   kBlockK, kStages) and with parts cut out (no Q.K^T, no P.V, no load of
   the next tile; their outputs are wrong), and flash_bwd.cu rebuilt with
   parts cut out (no first products S and dP, no products at all, no
   load of the next tile), each as its own library beside the port's,
   and timed by torch.profiler at the serving shape, causal and not (the
   backward's dq and dkv kernels apart).

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


def bwd_edit(cuts):
    def edit(text):
        for cut in cuts:
            for pattern, repl in BWD_CUTS[cut]:
                text, n = re.subn(pattern, repl, text)
                assert n >= 1, cut
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
        name: bwd_edit(cuts) for name, cuts in BWD_VARIANTS.items()})
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/probe_torch_kernels.txt")
    ap.add_argument("--skip-variants", action="store_true")
    ap.add_argument("--variants", default="fwd,bwd",
                    help="which kernels' variants to time: fwd, bwd or both")
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
        times(say, gen, dev)
        power(say, gen, dev)
        which = set() if args.skip_variants else set(
            args.variants.split(","))
        out_dir = ROOT / "build" / "exprgrad_torch" / "probe_variants"
        if "fwd" in which:
            variants(say, gen, dev, out_dir)
        if "bwd" in which:
            bwd_variants(say, gen, dev, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
