#!/usr/bin/env python3
"""Measure the routing cost model's constants of exprgrad_torch on the GPU.

The port's counterpart of ``scripts/pallas_calibrate.py`` and
``scripts/pallas_overhead.py``; it imports the port and chip_smoke.py's
program builders, never jax.  Every case runs through the compiled
executor (``TorchExecutor``), the path user models take, on device
tensors, once through the kernel and once through the plain lowering:

* B1 (``schedule_mode="force"``) against the plain lowering
  (``"ignore"``: the einsum, ``torch.matmul`` with TF32 off) at 1024^3,
  2048^3 and 4096^3 in float32 and bfloat16;
* an unscheduled float32 contraction through the einsum path, on B1's
  Hopper mainloop (lowering path ``einsum-b1``) against ``torch.einsum``
  (TF32 off), at 64^3 and 1024^3 to 4096^3: the cost model is told
  which side to take (:class:`Side`'s ``einsum``);
* B5 against the plain lowering on an elementwise map and a row
  reduction over 8192 x 8192, and bench.py's scatter-add (n 16384, d 512)
  at v 2048 and at v 512 and 8192;
* B6 against the plain lowering on the softmax at 8192^2 and a layer_norm
  chain over 8192 x 1024;
* B2 (``impl="flash"``) against ``impl="xla"`` at the serving shape
  ``[8, 4, 256, 128]`` and a long one ``[2, 4, 4096, 128]``, causal;
* the per-call cost of a tiny kernel on each side, where the card is
  idle: a ``[16, 64]`` map, a 64^3 contraction, attention
  ``[1, 1, 64, 64]``.

Each time is the median of ``--reps`` wall times (5), each of N
back-to-back executor calls ended by ``torch.cuda.synchronize()``, so the
host's cost of a call stays in the measurement where the host sets the
pace; the two sides' walls alternate, each rep starting with the other
side.  A gap between the medians smaller than the walls' spread is a tie,
which keeps the kernel.  The tiny cases give the per-call costs; each
rate is a large case's work over its wall time a call (the fitted cases),
and a rate above the card's peak for its type raises.  Both sides of a
tied fitted case get the kernel's rate, so their per-call costs decide.

    python scripts/calibrate_torch.py            # on a machine with a GPU

writes ``exprgrad_torch/backend/calibration.json`` (the constants, the
card's name and power limit from nvidia-smi, torch's version, the date)
and the table between the ``calibrate_torch`` markers of PERF.md
and the ``_DEFAULTS`` block of ``exprgrad_torch/backend/policy.py``, the
same numbers with their provenance (``--json``, ``--perf``, ``--policy``
name other files).  It raises without a GPU and writes nothing then.  ``calibrate(reps=..., quick=True)`` is the short
run ``chip_smoke.py`` makes.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from chip_smoke import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS,  # noqa: E402
                        PEAK_HBM_BYTES, PEAK_TF32_FLOPS, SCATTER, gpu_line,
                        matmul_graph, scatter_add_graph, softmax_chain)

MARK_BEGIN = "<!-- calibrate_torch: begin -->"
MARK_END = "<!-- calibrate_torch: end -->"
# policy.py's _DEFAULTS block, which the script writes with the JSON
POLICY_PATH = os.path.join(ROOT, "exprgrad_torch", "backend", "policy.py")
POLICY_BEGIN = ("# calibrate_torch: begin (scripts/calibrate_torch.py "
                "writes this block and\n# calibration.json from one run)")
POLICY_END = "# calibrate_torch: end"
DEVICE = "cuda"


# --- the programs (chip_smoke.py's builders where it has them) -----------

def _matmul(egt, n, tile):
    rng = np.random.default_rng(n)
    a, b = (rng.standard_normal((n, n)).astype(np.float32) for _ in "ab")
    return matmul_graph(egt, tile), "c", {"a": a, "b": b}


def _einsum(egt, n):
    """``c[y, x] = a[y, it] * b[it, x]`` with no schedule: the einsum
    path's contraction."""
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    c[y, x] = egt.input("a")[y, it] * egt.input("b")[it, x]
    rng = np.random.default_rng(n)
    a, b = (rng.standard_normal((n, n)).astype(np.float32) for _ in "ab")
    return c.target("c"), "c", {"a": a, "b": b}


def _map(egt, rows, cols):
    inp = egt.input("inp")
    y, x = egt.iters("y", "x")
    out = egt.Fun("out")
    out[y, x] = egt.exp(inp[y, x]) + 1.0
    out.schedule(tile={"y": 16})
    v = np.random.default_rng(1).standard_normal((rows, cols))
    return out.target("out"), "out", {"inp": v.astype(np.float32)}


def _row_sum(egt, rows, cols):
    inp = egt.input("inp")
    y, x = egt.iters("y", "x")
    out = egt.Fun("out")
    out[y] = inp[y, x]
    out.schedule(tile={"y": 16})
    v = np.random.default_rng(2).standard_normal((rows, cols))
    return out.target("out"), "out", {"inp": v.astype(np.float32)}


def _scatter_add(egt, v):
    n, d = SCATTER["n"], SCATTER["d"]
    rng = np.random.default_rng(0)
    return scatter_add_graph(egt, v, d, SCATTER["tile"]), "demb", {
        "tok": rng.integers(0, v, n).astype(np.float32),
        "g": (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)}


def _softmax(egt, n):
    graph, args = softmax_chain(egt, {"y": 32}, rows=n, cols=n, scale=1.0)
    return graph, "out", args


def _layer_norm(egt, rows, dim):
    inp, gamma, beta = (egt.input(s) for s in ("inp", "gamma", "beta"))
    n, v, out = egt.Fun("mean"), egt.Fun("var"), egt.Fun("out")
    y, x = egt.iters("y", "x")
    n[y] = inp[y, x] * (1.0 / dim)
    y, x = egt.iters("y", "x")
    v[y] = egt.sq(inp[y, x] - n[y]) * (1.0 / dim)
    y, x = egt.iters("y", "x")
    out[y, x] = (inp[y, x] - n[y]) / egt.sqrt(v[y] + 1e-5) * gamma[x] \
        + beta[x]
    for f in (n, v, out):
        f.schedule(tile={"y": 16})
    rng = np.random.default_rng(3)
    return out.target("out"), "out", {
        "inp": rng.standard_normal((rows, dim)).astype(np.float32),
        "gamma": rng.standard_normal(dim).astype(np.float32),
        "beta": rng.standard_normal(dim).astype(np.float32)}


def _attention(egt, impl, b, h, s, d):
    import exprgrad_torch.layers as layers

    out = layers.fused_attention(egt.input("q"), egt.input("k"),
                                 egt.input("v"), causal=True, impl=impl)
    rng = np.random.default_rng(4)
    args = {name: rng.standard_normal((b, h, s, d)).astype(np.float32)
            for name in "qkv"}
    return out.target("out"), "out", args


# --- timing ----------------------------------------------------------------

class Side:
    """One executor of a program on device tensors, ready to run.
    ``einsum`` True or False makes the cost model send the einsum path's
    float32 contractions to B1's Hopper mainloop, or keep them on
    torch.einsum (every case's plain side: the plain lowering); None
    leaves it the committed constants."""

    def __init__(self, egt, built, dtype, mode, einsum=None):
        from exprgrad_torch.backend.executor import TorchExecutor
        from exprgrad_torch.passes import infer_shapes

        graph, target, args = built
        model = egt.compile(graph, seed=0, device=DEVICE)
        prog = model.program
        if dtype == "bfloat16":  # the compiled program in bfloat16
            prog = prog.copy()
            prog.scalar_type = egt.ir.ScalarType.BF16
        tdt = getattr(torch, dtype)
        self.shapes = infer_shapes(prog, target, model._input_shapes(args))
        self.tensors = {
            prog.inputs[name]: torch.from_numpy(value).to(model.device, tdt)
            for name, value in args.items()}
        self.tensors.update({t: p.to(tdt) for t, p in model.params.items()})
        self.ex = TorchExecutor(prog, target, self.shapes, model.device,
                                schedule_mode=mode)
        if einsum is not None:
            self.ex.policy.constants.update(
                einsum_kernel_launch_us=0.0 if einsum else float("inf"),
                einsum_kernel_tflops_float32=float("inf") if einsum
                else 1.0)
        self.precision = model.precision

    def run(self):
        return self.ex.run(self.tensors, self.shapes, 1, 0)


def _counters():
    """Each kind of case's launch counter: (module, attribute)."""
    from exprgrad_torch.ops import attention, mapreduce, matmul, rowchain

    return {"B1": (matmul, "launches"), "einsum-b1": (matmul,
                                                      "gemm_launches"),
            "B5": (mapreduce, "launches"), "B6": (rowchain, "launches"),
            "B2": (attention, "launches")}


def _sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _launches(side, kind) -> int:
    """Run ``side`` once (its first run plans, builds and compiles) and
    count its launches of kernel ``kind``."""
    mod, attr = _counters()[kind]
    setattr(mod, attr, 0)
    side.run()
    _sync()
    n = getattr(mod, attr)
    setattr(mod, attr, 0)
    return n


def _calls(side, target_ms) -> int:
    """Calls a wall of about ``target_ms`` takes, from one timed call."""
    side.run()
    _sync()
    t0 = time.perf_counter()
    side.run()
    _sync()
    est = max(time.perf_counter() - t0, 1e-6) * 1e3
    return int(min(200, max(3, target_ms / est)))


def walls_in_turns(sides, reps, target_ms) -> list:
    """Each side's wall times a call over ``reps`` turns: a wall is N
    back-to-back calls of one side ended by a synchronize, the sides
    alternate, and each turn starts with the other side."""
    from exprgrad_torch.model import matmul_precision

    calls = [_calls(side, target_ms) for side in sides]
    walls = [[] for _ in sides]
    for rep in range(reps):
        order = range(len(sides)) if rep % 2 == 0 else \
            reversed(range(len(sides)))
        for i in order:
            with matmul_precision(sides[i].precision):
                _sync()
                t0 = time.perf_counter()
                for _ in range(calls[i]):
                    sides[i].run()
                _sync()
                walls[i].append((time.perf_counter() - t0) * 1e3 / calls[i])
    return walls, calls


def winner(case) -> str:
    """``kernel``, ``plain``, or ``tie`` where the gap between the medians
    is smaller than the larger spread (max - min) of the two sides'
    walls; a tie keeps the kernel."""
    spread = max(max(w) - min(w) for w in (case["kernel_walls"],
                                           case["plain_walls"]))
    if abs(case["kernel_ms"] - case["plain_ms"]) < spread:
        return "tie"
    return "kernel" if case["kernel_ms"] < case["plain_ms"] else "plain"


def _pair(egt, name, kind, kernel_built, plain_built, dtype, work,
          unit, reps, target_ms, kernel_mode="force", plain_mode="ignore"):
    """One case: the kernel's side and the plain side, checked to launch
    the kernel and not to, then timed in turns."""
    kside = Side(egt, kernel_built, dtype, kernel_mode,
                 True if kind == "einsum-b1" else None)
    pside = Side(egt, plain_built, dtype, plain_mode, False)
    launched = _launches(kside, kind)
    plain_launched = _launches(pside, kind)
    if launched < 1 or plain_launched:
        raise RuntimeError(
            f"{name}: {kind} launched {launched} times on the kernel's "
            f"side and {plain_launched} on the plain side")
    (kernel_walls, plain_walls), calls = walls_in_turns(
        (kside, pside), reps, target_ms)
    case = {"name": name, "kernel": kind, "dtype": dtype, "work": work,
            "unit": unit, "kernel_ms": statistics.median(kernel_walls),
            "plain_ms": statistics.median(plain_walls),
            "kernel_walls": kernel_walls, "plain_walls": plain_walls,
            "calls": calls, "launches": launched}
    print(f"calibrate: {name} ({dtype}): {kind} {case['kernel_ms']:.4f} ms,"
          f" plain {case['plain_ms']:.4f} ms a call ({calls[0]}/{calls[1]} "
          f"calls a wall, {reps} walls in turns; {winner(case)})",
          flush=True)
    return case, kside


def _flops_mm(n):
    return 2.0 * n ** 3


def _flops_att(b, h, s, d):
    return 4.0 * b * h * s * s * d


def measure(egt, reps=5, quick=False) -> list:
    """Every case of the module docstring; ``quick`` makes each wall
    about 15 ms of calls instead of 40.  Returns the cases."""
    target_ms = 15.0 if quick else 40.0
    cases = []

    def pair(*a, **kw):
        case, side = _pair(egt, *a, reps=reps, target_ms=target_ms, **kw)
        cases.append(case)
        return case, side

    built = _map(egt, 16, 64)
    pair("tiny map [16, 64]", "B5", built, built, "float32", 0, "B")
    built = _matmul(egt, 64, 64)
    pair("tiny contraction 64^3", "B1", built, built, "float32",
         _flops_mm(64), "FLOP")
    built = _einsum(egt, 64)
    pair("tiny einsum 64^3", "einsum-b1", built, built, "float32",
         _flops_mm(64), "FLOP")
    pair("tiny attention [1, 1, 64, 64]", "B2",
         _attention(egt, "flash", 1, 1, 64, 64),
         _attention(egt, "xla", 1, 1, 64, 64), "float32",
         _flops_att(1, 1, 64, 64), "FLOP", plain_mode="force")
    for dtype in ("float32", "bfloat16"):
        for n in (1024, 2048, 4096):
            built = _matmul(egt, n, 128)
            pair(f"matmul {n}^3", "B1", built, built, dtype, _flops_mm(n),
                 "FLOP")
    for n in (1024, 2048, 4096):
        built = _einsum(egt, n)
        pair(f"einsum {n}^3", "einsum-b1", built, built, "float32",
             _flops_mm(n), "FLOP")
    built = _map(egt, 8192, 8192)
    _, side = pair("elementwise map 8192^2", "B5", built, built, "float32",
                   None, "B")
    cases[-1]["work"] = _mapreduce_bytes(side)
    built = _row_sum(egt, 8192, 8192)
    _, side = pair("row reduction 8192^2", "B5", built, built, "float32",
                   None, "B")
    cases[-1]["work"] = _mapreduce_bytes(side)
    for v in (512, SCATTER["v"], 8192):
        built = _scatter_add(egt, v)
        _, side = pair(f"scatter-add n={SCATTER['n']} v={v} "
                       f"d={SCATTER['d']}", "B5", built, built, "float32",
                       None, "B")
        cases[-1]["work"] = _mapreduce_bytes(side)
        cases[-1]["gather_work"] = _mapreduce_bytes(side, "gather_work")
    built = _softmax(egt, 8192)
    _, side = pair("softmax 8192^2", "B6", built, built, "float32", None,
                   "B")
    cases[-1]["work"], cases[-1]["members"] = _chain_bytes(side)
    built = _layer_norm(egt, 8192, 1024)
    _, side = pair("layer_norm 8192x1024", "B6", built, built, "float32",
                   None, "B")
    cases[-1]["work"], cases[-1]["members"] = _chain_bytes(side)
    for b, h, s, d in ((8, 4, 256, 128), (2, 4, 4096, 128)):
        pair(f"causal attention [{b}, {h}, {s}, {d}]", "B2",
             _attention(egt, "flash", b, h, s, d),
             _attention(egt, "xla", b, h, s, d), "float32",
             _flops_att(b, h, s, d), "FLOP", plain_mode="force")
    return cases


def _mapreduce_bytes(side, attr="total_bytes"):
    (low,) = [low for low in side.ex._lowerings.values()
              if low.scheduled_route() == "mapreduce"]
    return getattr(low.scheduled_mapreduce(), attr)


def _chain_bytes(side):
    (chain,) = side.ex.row_fused.values()
    return ((chain.operand_bytes, chain.out_bytes), len(chain.members))


def _case(cases, name, dtype="float32"):
    (case,) = [c for c in cases if c["name"] == name and c["dtype"] == dtype]
    return case


# --- the constants ---------------------------------------------------------

# (case, dtype, the kernel side's constant, the plain side's, scale): the
# per-call costs (us a call, the card idle) and the rates (work over the
# wall time a call) the constants are fitted to
TINY = (("tiny map [16, 64]", "kernel_launch_us", "plain_launch_us"),
        ("tiny contraction 64^3", "matmul_kernel_launch_us",
         "matmul_plain_launch_us"),
        ("tiny attention [1, 1, 64, 64]", "attention_flash_launch_us",
         "attention_plain_launch_us"),
        ("tiny einsum 64^3", "einsum_kernel_launch_us",
         "einsum_plain_launch_us"))
RATES = (
    ("matmul 4096^3", "float32", "kernel_matmul_tflops_float32",
     "plain_matmul_tflops_float32", 1e12),
    ("matmul 4096^3", "bfloat16", "kernel_matmul_tflops_bfloat16",
     "plain_matmul_tflops_bfloat16", 1e12),
    ("elementwise map 8192^2", "float32", "kernel_elementwise_gbps",
     "plain_elementwise_gbps", 1e9),
    ("softmax 8192^2", "float32", "kernel_rowchain_gbps", None, 1e9),
    ("causal attention [2, 4, 4096, 128]", "float32",
     "flash_attention_tflops", "plain_attention_tflops", 1e12),
    ("einsum 4096^3", "float32", "einsum_kernel_tflops_float32", None,
     1e12),
)

# each rate's ceiling, the card's published peak for its type (chip_smoke's
# table): B1 and B2 run float32 as split TF32, three products a product;
# the plain contraction runs float32 with TF32 off
PEAKS = {
    "kernel_matmul_tflops_float32": PEAK_TF32_FLOPS / 3 / 1e12,
    "plain_matmul_tflops_float32": PEAK_F32_FLOPS / 1e12,
    "kernel_matmul_tflops_bfloat16": PEAK_BF16_FLOPS / 1e12,
    "plain_matmul_tflops_bfloat16": PEAK_BF16_FLOPS / 1e12,
    "kernel_elementwise_gbps": PEAK_HBM_BYTES / 1e9,
    "plain_elementwise_gbps": PEAK_HBM_BYTES / 1e9,
    "kernel_rowchain_gbps": PEAK_HBM_BYTES / 1e9,
    "flash_attention_tflops": PEAK_TF32_FLOPS / 3 / 1e12,
    "plain_attention_tflops": PEAK_TF32_FLOPS / 1e12,
    "einsum_kernel_tflops_float32": PEAK_TF32_FLOPS / 3 / 1e12,
}

# the comments of policy.py's _DEFAULTS, each over the constants it names
COMMENTS = (
    ("B1 at 4096^3 through the executor (schedule tile 128) against the "
     "plain lowering (the einsum: torch.matmul, TF32 off): 2 m n k over "
     "the wall time a call; where the two tie, the plain side has the "
     "kernel's rate", ("kernel_matmul_tflops_float32",
                              "plain_matmul_tflops_float32",
                              "kernel_matmul_tflops_bfloat16",
                              "plain_matmul_tflops_bfloat16")),
    ("an elementwise map over 8192 x 8192 float32: the bytes read and "
     "written over the wall time a call, B5 and the plain lowering",
     ("kernel_elementwise_gbps", "plain_elementwise_gbps")),
    ("the three-kernel softmax at 8192^2 float32 as one B6: its operand "
     "and output bytes over the wall time a call", ("kernel_rowchain_gbps",)),
    ("causal attention [2, 4, 4096, 128] float32 through the attention "
     "extern: 4 b h sq skv d over the wall time a call, B2 against "
     "impl=\"xla\"", ("flash_attention_tflops", "plain_attention_tflops")),
    ("the per-call cost of a tiny kernel through the executor, the card "
     "idle (us a call): a [16, 64] map (B5 / plain), a 64^3 contraction "
     "(B1 / plain), attention [1, 1, 64, 64] (B2 / impl=\"xla\")",
     ("kernel_launch_us", "plain_launch_us", "matmul_kernel_launch_us",
      "matmul_plain_launch_us", "attention_flash_launch_us",
      "attention_plain_launch_us")),
    ("the einsum path's contractions on B1's Hopper mainloop (split "
     "pre-pass and wgmma GEMM) against torch.einsum, TF32 off: 2 m n k "
     "over the wall time a call at 4096^3, and each side's per-call cost "
     "at 64^3 (the plain side's rate is plain_matmul_tflops_float32)",
     ("einsum_kernel_tflops_float32", "einsum_kernel_launch_us",
      "einsum_plain_launch_us")),
)


def fitted(case) -> list:
    """The constants fitted to ``case``."""
    keys = [k for name, *ks in TINY if name == case["name"] for k in ks
            if k]
    keys += [k for name, dtype, kk, pk, _ in RATES
             if (name, dtype) == (case["name"], case["dtype"])
             for k in (kk, pk) if k]
    return keys


def derive(cases) -> dict:
    """The constants from the cases: the tiny cases' per-call costs, and
    each rate a large case's work over its wall time a call (the plain
    side takes the kernel's rate where the case is a tie).  Raises where
    a rate passes the card's peak for its type."""
    c = {}
    for name, kernel_key, plain_key in TINY:
        case = _case(cases, name)
        c[kernel_key] = case["kernel_ms"] * 1e3
        if plain_key:
            c[plain_key] = case["plain_ms"] * 1e3
    for name, dtype, kernel_key, plain_key, scale in RATES:
        case = _case(cases, name, dtype)
        work = sum(case["work"]) if isinstance(case["work"], (list, tuple)) \
            else case["work"]
        c[kernel_key] = work / (case["kernel_ms"] * 1e-3) / scale
        if plain_key:
            c[plain_key] = c[kernel_key] if winner(case) == "tie" else \
                work / (case["plain_ms"] * 1e-3) / scale
    for key, peak in PEAKS.items():
        if c[key] > peak:
            raise ValueError(
                f"calibrate: {key} {c[key]:.6g} is above the card's peak "
                f"{peak:.6g} for its type: a case's work or time is wrong")
    return c


def decide(cases, constants) -> list:
    """Each case's route under ``constants`` beside the measured winner:
    ``(case, the model's choice, the measured winner)``."""
    from exprgrad_torch.backend.policy import SchedulePolicy

    pol = SchedulePolicy("auto")
    pol.constants.update(constants)
    pol.constants["calibrated"] = True
    out = []
    for case in cases:
        kind, name = case["kernel"], case["name"]
        if kind in ("B1", "einsum-b1"):
            n = round((case["work"] / 2) ** (1 / 3))
            d = (pol.contraction(n, n, n, case["dtype"]) if kind == "B1"
                 else pol.einsum_contraction(n, n, n))
        elif kind == "B5":
            d = pol.mapreduce(case["work"], case.get("gather_work", 0) * 4)
        elif kind == "B6":
            (op, outb), n = case["work"], case["members"]
            d = pol.rowchain(op, outb, n)
        else:
            dims = name[name.index("[") + 1:name.index("]")]
            b, h, s, dd = (int(x) for x in dims.split(","))
            d = pol.attention(b, h, s, s, dd)
        out.append((case, d.use_pallas, winner(case)))
    return out


def calibrate(reps=5, quick=False) -> dict:
    """Measure every case on the card; returns ``{"card", "torch",
    "date", "constants", "cases", "decisions"}``.  Raises without a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("calibrate_torch needs an NVIDIA GPU "
                           "(torch.cuda.is_available() is False)")
    import exprgrad_torch as egt
    from exprgrad_torch.utils import kernels

    kernels.load()
    cases = measure(egt, reps=reps, quick=quick)
    constants = derive(cases)
    return {"card": gpu_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "date": datetime.date.today().isoformat(),
            "reps": reps, "constants": constants, "cases": cases,
            "decisions": decide(cases, constants)}


def table(result) -> str:
    """The markdown table of a calibration."""
    lines = [
        f"{result['card']}; torch {result['torch']}, CUDA "
        f"{result['cuda']}, {result['date']}; `scripts/calibrate_torch.py`,"
        f" median of {result['reps']} wall times of N back-to-back "
        "executor calls on device tensors, ended by a synchronize, the "
        "two sides in turns.",
        "",
        "| Case | Kernel | dtype | Kernel ms | Plain ms | Plain / kernel "
        "| Spread % | Model routes to | Measured winner | Fitted to it |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    held = [0, 0]  # predicted, of the cases no constant was fitted to
    for case, choice, won in result["decisions"]:
        spread = max((max(w) - min(w)) / statistics.median(w)
                     for w in (case["kernel_walls"], case["plain_walls"]))
        keys = fitted(case)
        if not keys:
            held[0] += choice == (won != "plain")
            held[1] += 1
        lines.append(
            f"| {case['name']} | {case['kernel']} | {case['dtype']} | "
            f"{case['kernel_ms']:.4f} | {case['plain_ms']:.4f} | "
            f"{case['plain_ms'] / case['kernel_ms']:.2f} | "
            f"{spread * 100:.1f} | {'kernel' if choice else 'plain'} | "
            f"{won} | {', '.join(f'`{k}`' for k in keys) or '-'} |")
    agree = sum(choice == (won != "plain")
                for _, choice, won in result["decisions"])
    lines.append("")
    lines.append(
        f"Winners predicted: {agree} of {len(result['decisions'])} (a tie "
        f"keeps the kernel); {held[0]} of the {held[1]} cases no constant "
        "was fitted to.")
    lines.append("")
    lines.append("Constants: " + ", ".join(
        f"`{k}` {v:.6g}" for k, v in sorted(result["constants"].items())))
    return "\n".join(lines)


def defaults_block(result) -> str:
    """policy.py's ``_DEFAULTS`` block: the constants with their
    provenance."""
    import textwrap

    c = result["constants"]
    out = [POLICY_BEGIN,
           f"# {result['card']}; torch {result['torch']}, CUDA "
           f"{result['cuda']}, {result['date']}; median of "
           f"{result['reps']} wall times of back-to-back executor calls "
           "(the table in PERF.md between the calibrate_torch markers).",
           "_DEFAULTS = {"]
    out[1:2] = textwrap.wrap(out[1], 75, initial_indent="",
                             subsequent_indent="# ")
    for comment, keys in COMMENTS:
        out += textwrap.wrap(comment, 75, initial_indent="    # ",
                             subsequent_indent="    # ")
        out += [f"    {k!r}: {c[k]!r},".replace("'", '"') for k in keys]
    out += ["}", POLICY_END]
    return "\n".join(out)


def _replace_between(path, begin, end, block) -> None:
    text = open(path).read() if os.path.exists(path) else ""
    if begin in text and end in text:
        head, rest = text.split(begin, 1)
        text = head + block + rest.split(end, 1)[1]
    else:
        text = (text + "\n" if text else "") + block + "\n"
    with open(path, "w") as f:
        f.write(text)


def write(result, json_path, perf_path, policy_path) -> None:
    """calibration.json, PERF.md's table and policy.py's ``_DEFAULTS``,
    from one result."""
    data = {"card": result["card"], "torch": result["torch"],
            "cuda": result["cuda"], "date": result["date"],
            "script": "scripts/calibrate_torch.py", "reps": result["reps"]}
    data.update(result["constants"])
    with open(json_path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    _replace_between(perf_path, MARK_BEGIN, MARK_END,
                     f"{MARK_BEGIN}\n{table(result)}\n{MARK_END}")
    if not os.path.exists(policy_path):  # a copy to put in place by hand
        import shutil

        shutil.copy(POLICY_PATH, policy_path)
    _replace_between(policy_path, POLICY_BEGIN, POLICY_END,
                     defaults_block(result))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", default=os.path.join(
        ROOT, "exprgrad_torch", "backend", "calibration.json"))
    ap.add_argument("--perf", default=os.path.join(ROOT, "PERF.md"))
    ap.add_argument("--policy", default=POLICY_PATH,
                    help="policy.py whose _DEFAULTS block to rewrite (a "
                         "copy of this checkout's where the file is new)")
    ap.add_argument("--cases", default=None,
                    help="also write every case's walls to this JSON file")
    args = ap.parse_args(argv)
    result = calibrate(reps=args.reps)
    print(table(result))
    write(result, args.json, args.perf, args.policy)
    if args.cases:
        with open(args.cases, "w") as f:
            json.dump({k: v for k, v in result.items() if k != "decisions"},
                      f, indent=1)
    print(f"wrote {args.json}, the table in {args.perf} and _DEFAULTS in "
          f"{args.policy}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
