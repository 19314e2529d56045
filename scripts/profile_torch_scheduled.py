"""Profile the PyTorch/CUDA port's scheduled paths on one GPU.

    python3 scripts/profile_torch_scheduled.py [--out FILE]

Builds the programs that chip_smoke.py runs through kernel B1
(exprgrad_torch/csrc/matmul.cuh) and the generated kernels B5 and B6
(exprgrad_torch/ops/mapreduce.py, rowchain.py), compiled with
schedule_mode="force" on the card, random data from seed 0:

- path (a): c[y,x] = a[y,it]*b[it,x] at 4096^3 float32 with
  schedule(tile 512), call("c") with numpy arrays in and out;
- path (b): the scheduled MLP at the flash_transformer FFN width (dense
  512->2048, relu, dense 2048->512, residual, squared error, adam),
  apply("train") on [2048, 512] rows;
- path (c): the schedule DSL programs of examples/scheduled_kernels.py
  sections 3-9 and bench.py's softmax 8192^2 and scatter-add, one call
  of each with numpy arrays in and out;
- path (d): the flash_transformer head with row-tiled rms_norm and
  softmax (chip_smoke.py's transformer_head), apply("train") on
  [2048, 512] rows and one-hot labels over a vocabulary of 2048.

For each: ten warm runs on the host clock ending in
torch.cuda.synchronize(), ms each; one warm run under torch.profiler
(wall ms, device ms, the device's busy share and the operators that take
the most device time); cProfile of one warm run (the host functions by
their own time).  Each summary line names the card and its power limit.
The full tables go to ``--out`` (default
``build/profile_torch_scheduled.txt`` under the working directory).
Needs a CUDA device; imports no jax.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

import numpy as np
import torch

from profile_torch_serving import gpu_line, profiled

from chip_smoke import HEAD, MATMUL_N, MATMUL_TILE, MLP, MLP_ROWS, \
    matmul_graph, path_c_programs, scheduled_mlp, transformer_head


def host_runs(name, fn, gpu, count=10):
    runs = []
    for _ in range(count):
        t0 = time.perf_counter()
        fn()
        runs.append(round((time.perf_counter() - t0) * 1e3, 3))
    print(f"{name} warm ms, {count} runs: {runs}; mean "
          f"{sum(runs) / count:.3f} ms on {gpu}")


def host_profile(name, fn, out, rows=8):
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
    out.write(f"== cProfile, one warm {name}\n{text.getvalue()}\n")
    lines = [ln for ln in text.getvalue().splitlines()
             if ln.strip()[:1].isdigit()][:rows]
    print(f"cProfile, one warm {name}, by own time:")
    print("\n".join(lines))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile_torch_scheduled.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_scheduled: needs a CUDA device", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    import exprgrad_torch.layers  # noqa: F401  (egt.layers in the builder)

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__}, cuda {torch.version.cuda}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rng = np.random.default_rng(0)

    n = MATMUL_N
    mm = egt.compile(matmul_graph(egt, MATMUL_TILE), seed=0,
                     schedule_mode="force", device="cuda")
    mm_args = {"a": rng.standard_normal((n, n), dtype=np.float32),
               "b": rng.standard_normal((n, n), dtype=np.float32)}

    def call_c():
        mm.call("c", mm_args)
        torch.cuda.synchronize()

    mlp = egt.compile(scheduled_mlp(egt, **MLP), seed=0,
                      schedule_mode="force", device="cuda")
    batch = {name: rng.standard_normal((MLP_ROWS, MLP["dim"]),
                                       dtype=np.float32)
             for name in ("v", "t")}

    def train_step():
        mlp.epoch += 1
        mlp.apply("train", batch)
        torch.cuda.synchronize()

    programs = [(egt.compile(graph, seed=0, schedule_mode="force",
                             device="cuda"), target, inputs)
                for _, graph, target, inputs, _ in path_c_programs(egt)]

    def path_c():
        for model, target, inputs in programs:
            model.call(target, inputs)
        torch.cuda.synchronize()

    head = egt.compile(transformer_head(egt, HEAD["dim"], HEAD["vocab"]),
                       seed=0, schedule_mode="force", device="cuda")
    head_batch = {"x": rng.standard_normal((HEAD["rows"], HEAD["dim"]),
                                           dtype=np.float32),
                  "labels": np.eye(HEAD["vocab"], dtype=np.float32)[
                      rng.integers(0, HEAD["vocab"], HEAD["rows"])]}

    def head_step():
        head.epoch += 1
        head.apply("train", head_batch)
        torch.cuda.synchronize()

    paths = ((f"path (a) call c {n}^3", call_c),
             (f"path (b) train step [{MLP_ROWS},{MLP['dim']}]", train_step),
             (f"path (c) {len(programs)} calls", path_c),
             (f"path (d) train step [{HEAD['rows']},{HEAD['dim']}]",
              head_step))
    for _, fn in paths:
        fn()
        fn()  # warm: kernel build, executor, allocator, cuBLAS handles
    with open(args.out, "w") as out:
        out.write(f"{gpu}\n")
        for name, fn in paths:
            host_runs(name, fn, gpu)
            profiled(name, fn, out, gpu)
            host_profile(name, fn, out)
    print(f"lowering: path (a) {mm.lowering_stats('c')}, path (b) train "
          f"{mlp.lowering_stats('train')}, path (d) train "
          f"{head.lowering_stats('train')}")
    print(f"full tables: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
